"""Affine coupling bijector (RealNVP-style), its MLP conditioner, and Permute.

PyTorch counterpart of ``enflows_tpu/bijectors/coupling.py``. The contracts
are the JAX package's:

* ``MLPConditioner`` keeps JAX's weight layout: each layer's ``W`` is
  ``(fan_in, fan_out)`` and a layer computes ``h @ W + b``.
* ``AffineCoupling`` maps ``[x_a, x_b] -> [x_a, x_b * exp(s) + t]`` with
  ``(s_raw, t) = conditioner(x_a)`` and the soft clamp
  ``s = m * tanh(s_raw / m)``; the per-sample ladj is ``sum(s)``.
* ``inverse()`` returns a sibling over the *same* conditioner module (so the
  very same ``nn.Parameter`` s) with ``inverted`` flipped.
* ``init_affine_coupling`` zeroes the final layer, so a fresh coupling is
  the identity map.

Random initial weights come from an explicit ``torch.Generator``; they are
drawn on the generator's device and then moved to ``device``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base import Bijector, Chain, as_parameter

# ``jax.nn.gelu`` defaults to approximate=True, the tanh form; torch's gelu
# defaults to the exact erf form, so the tanh form is asked for by name.
ACTIVATIONS = {
    "tanh": torch.tanh,
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": torch.relu,
    "silu": F.silu,
}


class Dense(nn.Module):
    """One conditioner layer ``h @ W + b``, ``W: (fan_in, fan_out)``."""

    def __init__(self, W, b):
        super().__init__()
        self.W = as_parameter(W)
        self.b = as_parameter(b)


class MLPConditioner(nn.Module):
    """Dense MLP ``(..., d_in) -> (..., d_out)``
    (``enflows_tpu/bijectors/coupling.py:47-78``).

    ``layers``: a sequence of ``(W, b)`` pairs, ``W: (fan_in, fan_out)``.
    The activation follows every layer but the last. ``compute_dtype``
    other than None (JAX's bf16 conditioner matmuls) is not ported and
    raises ``NotImplementedError``."""

    def __init__(self, layers, activation: str = "gelu",
                 compute_dtype: str | None = None):
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                f"MLPConditioner(compute_dtype={compute_dtype!r}) is not "
                f"ported yet")
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(ACTIVATIONS)}, got {activation!r}")
        self.layers = nn.ModuleList(Dense(W, b) for W, b in layers)
        self.activation = activation
        self.compute_dtype = compute_dtype

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        h = x
        for i, layer in enumerate(self.layers):
            h = h @ layer.W + layer.b
            if i + 1 < len(self.layers):
                h = act(h)
        return h


class AffineCoupling(Bijector):
    """``y = [x_a, x_b * exp(s) + t]`` with ``(s, t)`` from the conditioner
    on ``x_a = x[..., :split]`` (``enflows_tpu/bijectors/coupling.py:81``).

    The conditioner maps ``(..., split) -> (..., 2 * d_b)``: the first half
    is ``s_raw``, the second ``t``. ``inverted=True`` is the map
    ``x_b = (y_b - t) * exp(-s)`` with ladj ``-sum(s)``."""

    def __init__(self, conditioner: MLPConditioner, split: int, *,
                 inverted: bool = False, max_log_scale: float = 3.0):
        super().__init__()
        self.conditioner = conditioner
        self.split = int(split)
        self.inverted = inverted
        self.max_log_scale = float(max_log_scale)

    def _s_t(self, x_a):
        """``enflows_tpu/bijectors/coupling.py:102-111``."""
        h = self.conditioner(x_a)
        if h.shape[-1] % 2:
            raise ValueError(
                f"conditioner output width {h.shape[-1]} must be even "
                "(first half log-scale, second half shift)")
        d_b = h.shape[-1] // 2
        m = self.max_log_scale
        return m * torch.tanh(h[..., :d_b] / m), h[..., d_b:]

    def forward_and_ladj(self, x):
        """``enflows_tpu/bijectors/coupling.py:113-127``."""
        x_a, x_b = x[..., :self.split], x[..., self.split:]
        s, t = self._s_t(x_a)
        if s.shape[-1] != x_b.shape[-1]:
            raise ValueError(
                f"conditioner emits {s.shape[-1]} (s, t) pairs but the "
                f"transformed half has {x_b.shape[-1]} dims "
                f"(event dim {x.shape[-1]}, split {self.split})")
        if self.inverted:
            y_b = (x_b - t) * torch.exp(-s)
            ladj = -s.sum(-1)
        else:
            y_b = x_b * torch.exp(s) + t
            ladj = s.sum(-1)
        return torch.cat([x_a, y_b], dim=-1), ladj

    def inverse(self):
        """``enflows_tpu/bijectors/coupling.py:129-130``."""
        return AffineCoupling(self.conditioner, self.split,
                              inverted=not self.inverted,
                              max_log_scale=self.max_log_scale)


class Permute(Bijector):
    """Static event permutation ``y[..., i] = x[..., perm[i]]``, ladj 0
    (``enflows_tpu/bijectors/coupling.py:133-153``). ``inverse()`` holds
    the argsorted permutation."""

    def __init__(self, perm):
        super().__init__()
        self.perm = tuple(int(i) for i in perm)

    def forward(self, x):
        return x[..., list(self.perm)]

    def forward_and_ladj(self, x):
        y = self.forward(x)
        return y, torch.zeros(x.shape[:-1], dtype=torch.promote_types(
            x.dtype, torch.float32), device=x.device)

    def inverse(self):
        return Permute(tuple(int(i) for i in np.argsort(self.perm)))


def _split_of(dim: int, split: int | None) -> int:
    if dim < 2:
        raise ValueError("coupling needs event dim >= 2")
    d_a = dim // 2 if split is None else split
    if not 0 < d_a < dim:
        raise ValueError(
            f"split must satisfy 0 < split < dim (got split={d_a}, "
            f"dim={dim})")
    return d_a


def init_mlp_layers(generator: torch.Generator, sizes, *, dtype, device):
    """He-normal ``(W, b)`` layers for ``sizes`` with a zeroed last layer
    and zero biases (``enflows_tpu/bijectors/coupling.py:170-180``)."""
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i == len(sizes) - 2:
            W = torch.zeros(fan_in, fan_out, dtype=dtype, device=device)
        else:
            W = torch.randn(fan_in, fan_out, generator=generator,
                            dtype=dtype, device=generator.device)
            W = (W * math.sqrt(2.0 / fan_in)).to(device)
        layers.append((W, torch.zeros(fan_out, dtype=dtype, device=device)))
    return layers


def init_affine_coupling(generator: torch.Generator, dim: int,
                         hidden=(64, 64), *, split: int | None = None,
                         activation: str = "gelu",
                         max_log_scale: float = 3.0,
                         dtype=torch.float32, compute_dtype=None,
                         device="cuda") -> AffineCoupling:
    """Identity-initialized coupling layer, zeroed final layer
    (``enflows_tpu/bijectors/coupling.py:156-184``)."""
    d_a = _split_of(dim, split)
    sizes = (d_a,) + tuple(hidden) + (2 * (dim - d_a),)
    cond = MLPConditioner(
        init_mlp_layers(generator, sizes, dtype=dtype, device=device),
        activation=activation, compute_dtype=compute_dtype)
    return AffineCoupling(cond, d_a, max_log_scale=max_log_scale)


def reversal_stack(make_layer, dim: int, n_layers: int) -> Chain:
    """``n_layers`` couplings from ``make_layer()`` with reversal Permutes
    in between, applied first to last."""
    rev = Permute(tuple(range(dim - 1, -1, -1)))
    stages = []
    for i in range(n_layers):
        if i:
            stages.append(rev)
        stages.append(make_layer())
    return Chain.of(*stages)


def coupling_stack(generator: torch.Generator, dim: int, n_layers: int = 4,
                   hidden=(64, 64), *, activation: str = "gelu",
                   max_log_scale: float = 3.0, dtype=torch.float32,
                   compute_dtype=None, device="cuda") -> Chain:
    """``n_layers`` identity-initialized couplings with reversal Permutes in
    between (``enflows_tpu/bijectors/coupling.py:187-204``)."""
    return reversal_stack(
        lambda: init_affine_coupling(
            generator, dim, hidden, activation=activation,
            max_log_scale=max_log_scale, dtype=dtype,
            compute_dtype=compute_dtype, device=device),
        dim, n_layers)
