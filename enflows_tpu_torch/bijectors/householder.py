"""Householder reflection chains: exact orthogonal (rotation) bijectors.

PyTorch counterpart of ``enflows_tpu/bijectors/householder.py``. One
reflection is ``y = x - 2 v (v.x)/(v.v)``; ``V`` has shape ``(k, d)`` with the
reflections as rows (or ``(d,)`` for a single one). The ladj is zero.

Two execution paths:

* ``scan``: a loop over reflections wrapped in a ``torch.autograd.Function``
  whose backward re-applies the reflections in reverse to rebuild each
  stage's input, storing no intermediates (only ``V`` and the output).
* ``dense``: build ``Q = H_{k-1}...H_0`` once and apply ``x @ Q.T``. It is
  an f32 matmul; on a CUDA card that is full f32 only while
  ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default,
  which ``chip_smoke.py`` sets explicitly before it compares anything).
"""
from __future__ import annotations

import torch

from .base import Bijector, as_parameter


def _reflect(v, x):
    """One reflection; v (d,), x (..., d) (``householder.py:46``)."""
    coef = 2.0 * (x @ v) / (v @ v)
    return x - coef[..., None] * v


def _reflect_pullback_v(v, x, g):
    """Cotangent w.r.t. ``v`` of ``_reflect(v, x)`` against ``g``, including
    the implicit normalization v -> v/|v| (``householder.py:52``)."""
    inrm = torch.rsqrt(v @ v)
    w = inrm * v
    w_x = x @ w
    w_g = g @ w
    bdims = tuple(range(x.dim() - 1))
    dw = -2.0 * ((g * w_x[..., None]).sum(bdims)
                 + (x * w_g[..., None]).sum(bdims))
    return inrm * (dw - w * (dw @ w))


class _HouseholderChain(torch.autograd.Function):
    """Memory-free custom VJP (``householder.py:72-103``)."""

    @staticmethod
    def forward(ctx, V, x):
        y = x
        for v in V:
            y = _reflect(v, y)
        ctx.save_for_backward(V, y)
        return y

    @staticmethod
    def backward(ctx, g):
        V, y = ctx.saved_tensors
        z, delta = y, g
        dV = torch.empty_like(V)
        for i in range(V.shape[0] - 1, -1, -1):
            v = V[i]
            # H_i is an involution: H_i z recovers stage i's input.
            z = _reflect(v, z)
            dV[i] = _reflect_pullback_v(v, z, delta)
            delta = _reflect(v, delta)
        return dV, delta


def householder_chain(V, x):
    """Apply reflections V[0], V[1], ... in order to x (..., d)
    (``enflows_tpu/bijectors/householder.py:73``)."""
    return _HouseholderChain.apply(V, x)


def householder_matrix(V, dtype=None):
    """Q = H_{k-1}...H_0 as a (d, d) orthogonal matrix
    (``enflows_tpu/bijectors/householder.py:106``). Differentiable."""
    if dtype is None:
        dtype = V.dtype
    V = V.to(dtype)
    d = V.shape[-1]
    Q = torch.eye(d, dtype=dtype, device=V.device)
    for v in V:
        w = v * torch.rsqrt(v @ v)
        Q = Q - 2.0 * torch.outer(w, w @ Q)
    return Q


def householder_chain_dense(V, x):
    """``x @ Q.T`` (``enflows_tpu/bijectors/householder.py:128``)."""
    Q = householder_matrix(V)
    return torch.matmul(x, Q.T.to(x.dtype))


class Householder(Bijector):
    """Orthogonal bijector from a chain of Householder reflections
    (``enflows_tpu/bijectors/householder.py:137``).

    ``V``: (k, d) reflection rows, or (d,) for one reflection.
    ``mode``: 'auto' | 'scan' | 'dense'. ``reversed=True`` applies the rows
    last-first over the same Parameter; ``inverse()`` flips it.
    """

    def __init__(self, V, mode: str = "auto", *, reversed: bool = False):
        super().__init__()
        if mode not in ("auto", "scan", "dense"):
            raise ValueError(f"mode must be auto|scan|dense, got {mode!r}")
        self.V = as_parameter(V)
        self.mode = mode
        self.reversed = reversed

    def fields(self):
        return {"V": self.V.flip(0) if self.reversed else self.V}

    def vmat(self):
        """The reflections as (k, d) rows, in the order they are applied."""
        V = self.fields()["V"]
        return V[None, :] if V.dim() == 1 else V

    def _use_dense(self, x) -> bool:
        if self.mode != "auto":
            return self.mode == "dense"
        k, d = self.vmat().shape
        if x.dim() < 2:
            return False
        # Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
        # [householder auto]: forward and backward at d = 2, 8, 50, 128,
        # batch 2^10 - 2^20, k = 1 .. d, four runs): at d = 50 and 128 and
        # batch 2^20 the dense product was 1.5x (k = 1) to 14x (k = 64)
        # faster; at d <= 8, and at batch 2^10, both routes take about a
        # millisecond of host launches and swap places between runs. The
        # scan stays for a single reflection at small d, and beyond
        # d = 128, where nothing was measured and it stores no (d, d)
        # matrix.
        return d <= 128 and (k >= 2 or d >= 32)

    def forward(self, x):
        V = self.vmat()
        if self._use_dense(x):
            return householder_chain_dense(V, x)
        return householder_chain(V, x)

    def forward_and_ladj(self, x):
        y = self.forward(x)
        shape = x.shape[:-1] if x.dim() else ()
        ladj = torch.zeros(shape, dtype=torch.promote_types(
            x.dtype, torch.float32), device=x.device)
        return y, ladj

    def inverse(self):
        """A single reflection is an involution; otherwise the rows reversed
        (``enflows_tpu/bijectors/householder.py:189-192``)."""
        if self.V.dim() == 1:
            return self
        return Householder(self.V, self.mode, reversed=not self.reversed)

    def canonicalize(self):
        """Re-normalize the rows of ``V`` onto the unit sphere
        (``enflows_tpu/bijectors/householder.py:194-199``).

        Unlike the JAX version, which returns a new bijector, this updates
        the Parameter ``V`` in place under ``torch.no_grad()`` and returns
        ``self``; siblings sharing ``V`` see the update."""
        with torch.no_grad():
            V = self.V
            if V.dim() == 1:
                V.mul_(torch.rsqrt(V @ V))
            else:
                V.mul_(torch.rsqrt((V * V).sum(-1, keepdim=True)))
        return self
