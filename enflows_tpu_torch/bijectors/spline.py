"""Monotone rational-quadratic spline bijectors (neural-spline-flow family).

PyTorch counterpart of ``enflows_tpu/bijectors/spline.py``: K bins on
``[-bound, bound]`` with identity tails outside, bin widths and heights from
a floored softmax, interior knot slopes from a floored, shifted softplus
(zero raw parameters give the identity), the bin picked by a one-hot
select, and the exact inverse by the stable two-root solve of the bin-local
quadratic. ``inverse()`` returns a parameter-sharing sibling.
"""
from __future__ import annotations

import math

import torch

from .base import Bijector, as_parameter
from .coupling import MLPConditioner, _split_of, init_mlp_layers, \
    reversal_stack

# Copied from enflows_tpu/bijectors/spline.py:48-52.
_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# softplus(raw + _DERIV_SHIFT) == 1 - _MIN_DERIV at raw == 0.
_DERIV_SHIFT = math.log(math.expm1(1.0 - _MIN_DERIV))


def softplus(u):
    """``jax.nn.softplus`` = logaddexp(u, 0) = max(u, 0) + log1p(e^-|u|)."""
    return torch.clamp(u, min=0.0) + torch.log1p(torch.exp(-torch.abs(u)))


def _knots(raw, bound: float, min_bin: float):
    """(bin sizes (..., K), knots (..., K+1)) with the endpoints pinned to
    -bound and +bound, not accumulated
    (``enflows_tpu/bijectors/spline.py:55-71``)."""
    K = raw.shape[-1]
    probs = torch.softmax(raw, dim=-1)
    probs = min_bin + (1.0 - min_bin * K) * probs
    sizes = 2.0 * bound * probs
    knots = -bound + torch.cumsum(sizes, dim=-1)
    edge = torch.ones_like(knots[..., :1])
    knots = torch.cat([-bound * edge, knots[..., :-1], bound * edge], dim=-1)
    return sizes, knots


def _derivs(raw, min_deriv: float):
    """``(..., K-1)`` interior slopes -> ``(..., K+1)`` with the boundary
    slopes pinned to 1 (``enflows_tpu/bijectors/spline.py:74-79``)."""
    d_in = min_deriv + softplus(raw + _DERIV_SHIFT)
    one = torch.ones_like(d_in[..., :1])
    return torch.cat([one, d_in, one], dim=-1)


def rq_spline(x, w_raw, h_raw, d_raw, *, bound: float, inverse: bool = False,
              min_bin: float = _MIN_BIN, min_deriv: float = _MIN_DERIV):
    """Elementwise monotone rational-quadratic spline on ``[-bound, bound]``,
    identity with zero ladj outside; returns ``(y, elementwise ladj)``
    (``enflows_tpu/bijectors/spline.py:82-171``).

    ``w_raw, h_raw: (..., K)``, ``d_raw: (..., K-1)``, broadcasting against
    ``x`` on the leading axes. ``inverse=True`` evaluates the exact inverse
    and its ladj."""
    if d_raw.shape[-1] != w_raw.shape[-1] - 1:
        raise ValueError(
            f"expected K-1={w_raw.shape[-1] - 1} interior derivatives, got "
            f"{d_raw.shape[-1]}")
    widths, xk = _knots(w_raw, bound, min_bin)
    heights, yk = _knots(h_raw, bound, min_bin)
    d = _derivs(d_raw, min_deriv)
    K = w_raw.shape[-1]

    in_range = (x > -bound) & (x < bound)
    ref_knots = yk if inverse else xk
    idx = (x[..., None] >= ref_knots[..., 1:-1]).sum(-1)
    idx = torch.clamp(idx, 0, K - 1)
    onehot = (idx[..., None] == torch.arange(K, device=x.device)).to(x.dtype)

    def pick(a, shift: int = 0):
        sl = a[..., shift:shift + K] if a.shape[-1] != K else a
        return (sl * onehot).sum(-1)

    wk, hk = pick(widths), pick(heights)
    x0, y0 = pick(xk), pick(yk)
    d0, d1 = pick(d), pick(d, shift=1)
    s = hk / wk

    if inverse:
        dy = torch.where(in_range, x - y0, 0.5 * hk)
        t = d1 + d0 - 2.0 * s
        a = hk * (s - d0) + dy * t
        b = hk * d0 - dy * t
        c = -s * dy
        root = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        # Stable two-root form (spline.py:141-154): q = -(b + sign(b)
        # sqrt(disc)) / 2 gives the roots c/q and q/a; exactly one lies in
        # [0, 1].
        q = -0.5 * (b + torch.where(b >= 0.0, 1.0, -1.0) * root)
        r1 = torch.where(q != 0.0, c / torch.where(q != 0.0, q, 1.0), 0.0)
        r2 = torch.where(a != 0.0, q / torch.where(a != 0.0, a, 1.0), r1)
        eps = 1e-6
        use_r1 = (r1 >= -eps) & (r1 <= 1.0 + eps)
        xi = torch.clamp(torch.where(use_r1, r1, r2), 0.0, 1.0)
        y = x0 + xi * wk
    else:
        xi = torch.clamp(torch.where(in_range, (x - x0) / wk, 0.5), 0.0, 1.0)
        t = d1 + d0 - 2.0 * s
        y = y0 + hk * (s * xi * xi + d0 * xi * (1.0 - xi)) \
            / (s + t * xi * (1.0 - xi))

    omxi = 1.0 - xi
    t = d1 + d0 - 2.0 * s
    denom = s + t * xi * omxi
    num = s * s * (d1 * xi * xi + 2.0 * s * xi * omxi + d0 * omxi * omxi)
    ladj_fwd = torch.log(num) - 2.0 * torch.log(denom)

    y = torch.where(in_range, y, x)
    ladj = torch.where(in_range, -ladj_fwd if inverse else ladj_fwd, 0.0)
    return y, ladj


class ElementwiseRQSpline(Bijector):
    """Unconditional per-dimension spline warp
    (``enflows_tpu/bijectors/spline.py:174-198``): ``w_raw, h_raw: (dim,
    K)``, ``d_raw: (dim, K-1)``."""

    def __init__(self, w_raw, h_raw, d_raw, *, inverted: bool = False,
                 bound: float = 5.0):
        super().__init__()
        self.w_raw = as_parameter(w_raw)
        self.h_raw = as_parameter(h_raw)
        self.d_raw = as_parameter(d_raw)
        self.inverted = inverted
        self.bound = float(bound)

    def fields(self):
        return {"w_raw": self.w_raw, "h_raw": self.h_raw,
                "d_raw": self.d_raw}

    def forward_and_ladj(self, x):
        y, ladj = rq_spline(x, self.w_raw, self.h_raw, self.d_raw,
                            bound=self.bound, inverse=self.inverted)
        return y, ladj.sum(-1)

    def inverse(self):
        return ElementwiseRQSpline(self.w_raw, self.h_raw, self.d_raw,
                                   inverted=not self.inverted,
                                   bound=self.bound)


def init_elementwise_rq_spline(dim: int, n_bins: int = 8, *,
                               bound: float = 5.0, dtype=torch.float32,
                               device="cuda") -> ElementwiseRQSpline:
    """Identity-initialized: uniform bins, unit derivatives
    (``enflows_tpu/bijectors/spline.py:201-209``)."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return ElementwiseRQSpline(z(dim, n_bins), z(dim, n_bins),
                               z(dim, n_bins - 1), bound=bound)


class RQSplineCoupling(Bijector):
    """Coupling layer whose transformed half goes through per-dimension RQ
    splines conditioned on the untouched half
    (``enflows_tpu/bijectors/spline.py:212-249``). The conditioner maps
    ``(..., split) -> (..., d_b * (3 * n_bins - 1))``: per transformed dim,
    K widths, K heights, K-1 interior slopes."""

    def __init__(self, conditioner: MLPConditioner, split: int, *,
                 n_bins: int = 8, inverted: bool = False,
                 bound: float = 5.0):
        super().__init__()
        self.conditioner = conditioner
        self.split = int(split)
        self.n_bins = int(n_bins)
        self.inverted = inverted
        self.bound = float(bound)

    def forward_and_ladj(self, x):
        x_a, x_b = x[..., :self.split], x[..., self.split:]
        K = self.n_bins
        h = self.conditioner(x_a)
        d_b = x_b.shape[-1]
        if h.shape[-1] != d_b * (3 * K - 1):
            raise ValueError(
                f"conditioner emits {h.shape[-1]} params but the spline "
                f"needs {d_b} * (3*{K}-1) = {d_b * (3 * K - 1)} "
                f"(event dim {x.shape[-1]}, split {self.split})")
        p = h.reshape(*h.shape[:-1], d_b, 3 * K - 1)
        y_b, ladj = rq_spline(x_b, p[..., :K], p[..., K:2 * K], p[..., 2 * K:],
                              bound=self.bound, inverse=self.inverted)
        return torch.cat([x_a, y_b], dim=-1), ladj.sum(-1)

    def inverse(self):
        return RQSplineCoupling(self.conditioner, self.split,
                                n_bins=self.n_bins,
                                inverted=not self.inverted, bound=self.bound)


def init_rq_spline_coupling(generator: torch.Generator, dim: int,
                            hidden=(64, 64), *, n_bins: int = 8,
                            split: int | None = None, bound: float = 5.0,
                            activation: str = "gelu", dtype=torch.float32,
                            compute_dtype=None,
                            device="cuda") -> RQSplineCoupling:
    """Identity-initialized spline coupling, zeroed final layer
    (``enflows_tpu/bijectors/spline.py:252-283``)."""
    d_a = _split_of(dim, split)
    sizes = (d_a,) + tuple(hidden) + ((dim - d_a) * (3 * n_bins - 1),)
    cond = MLPConditioner(
        init_mlp_layers(generator, sizes, dtype=dtype, device=device),
        activation=activation, compute_dtype=compute_dtype)
    return RQSplineCoupling(cond, d_a, n_bins=n_bins, bound=bound)


def spline_coupling_stack(generator: torch.Generator, dim: int,
                          n_layers: int = 4, hidden=(64, 64), *,
                          n_bins: int = 8, bound: float = 5.0,
                          activation: str = "gelu", dtype=torch.float32,
                          compute_dtype=None, device="cuda"):
    """``n_layers`` identity-initialized spline couplings with reversal
    Permutes in between (``enflows_tpu/bijectors/spline.py:286-304``)."""
    return reversal_stack(
        lambda: init_rq_spline_coupling(
            generator, dim, hidden, n_bins=n_bins, bound=bound,
            activation=activation, dtype=dtype,
            compute_dtype=compute_dtype, device=device),
        dim, n_layers)
