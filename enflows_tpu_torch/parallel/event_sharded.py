"""Event-dimension sharding of elementwise chains.

PyTorch counterpart of ``enflows_tpu/parallel/event_sharded.py``.
Elementwise bijectors act on each dimension alone with per-dimension
parameters, and the per-sample ladj is a sum over dimensions, so the event
axis shards: each rank transforms its column block with its slice of
every parameter, and one all-reduce sums the partial ladjs. On the card
the rank's block runs kernel B1 (its gradient B2) as any (n, d) batch
does. Householder stages, and couplings and permutations, mix the
dimensions and are refused; shard the batch instead.
"""
from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from ..bijectors.coupling import AffineCoupling, Permute
from ..bijectors.spline import RQSplineCoupling
from ..bijectors.householder import Householder
from ..distributions.base import std_normal_logpdf
from ..ops.elementwise import (_grads_by_name, fused_forward_and_ladj,
                               is_fusible_chain)
from .collectives import psum, psum_flat
from .mesh import Mesh, block_range, shard_chains

_MIXING = (Householder, AffineCoupling, RQSplineCoupling, Permute)


def _check_elementwise(chain) -> None:
    for m in chain.modules():
        if isinstance(m, _MIXING):
            raise ValueError(
                f"{type(m).__name__} mixes event dims; event-sharding only "
                f"supports elementwise chains (shard the batch instead)")


def local_chain(chain, mesh: Mesh, axis_name: str = "dim", dim=None):
    """A copy of the elementwise ``chain`` holding this rank's slice of
    every per-dimension parameter and buffer (leading size ``dim``,
    by default the first parameter's), for the rank's column block."""
    _check_elementwise(chain)
    tensors = list(chain.parameters()) + list(chain.buffers())
    d = dim if dim is not None else tensors[0].shape[0]
    lo, hi = block_range(d, mesh.axis(axis_name))
    out = copy.deepcopy(chain)
    for m in out.modules():
        for name, p in list(m._parameters.items()):
            if p is not None and p.dim() and p.shape[0] == d:
                m._parameters[name] = nn.Parameter(
                    p.detach()[lo:hi].clone(), requires_grad=p.requires_grad)
        for name, b in list(m._buffers.items()):
            if b is not None and b.dim() and b.shape[0] == d:
                m._buffers[name] = b[lo:hi].clone()
    return out


def _forward(chain, x):
    """(y, per-sample partial ladj): B1 on the card for a fusible chain,
    else the chain's own forward."""
    if is_fusible_chain(chain, x.shape[1], x.dtype):
        return fused_forward_and_ladj(chain, x)
    return chain.forward_and_ladj(x)


def event_sharded_forward_and_ladj(chain, mesh: Mesh,
                                   axis_name: str = "dim") -> Callable:
    """``run(x_local) -> (y_local, ladj)`` for the global elementwise
    ``chain`` (``enflows_tpu/parallel/event_sharded.py:38-69``):
    ``x_local`` is this rank's column block (``shard_event_batch``),
    ``y_local`` its block of y and ``ladj`` the full per-sample ladj, the
    one all-reduce of the partial ladjs over ``axis_name``. An evaluation:
    no graph is kept."""
    local = local_chain(chain, mesh, axis_name)
    axis = mesh.axis(axis_name)

    def run(x_local):
        with torch.no_grad():
            y, ladj = _forward(local, x_local)
        return y, psum(ladj, axis)

    return run


def shard_event_batch(x: torch.Tensor, mesh: Mesh, axis_name: str = "dim",
                      batch_axis: str | None = None) -> torch.Tensor:
    """This rank's column block of the (batch, dim) ``x`` over
    ``axis_name`` (and, with ``batch_axis``, its row block over that axis
    too), on the mesh's device."""
    if batch_axis is not None:
        x = shard_chains(x, mesh, batch_axis)
    return shard_chains(x, mesh, axis_name, dim=1)


def event_sharded_negll_fn(mesh: Mesh, batch_axis: str = "batch",
                           dim_axis: str = "dim") -> Callable:
    """The whitening negll over a 2-D (batch x event) mesh
    (``enflows_tpu/parallel/event_sharded.py:78-107``): ``fn(chain_local,
    x_local) -> (negll, grads)``, ``chain_local`` this rank's slice of an
    elementwise chain (``local_chain``) and ``x_local`` its (rows, columns)
    block (``shard_event_batch(..., batch_axis=...)``). The negll is a sum
    of per-element terms over (n, d), so one all-reduce over each axis
    gives it (replicated); ``grads`` maps ``chain_local``'s parameter names
    to their gradients (this rank's slice of the global gradients), summed
    over the batch axis in the same all-reduce as the loss, where JAX's
    ``grad`` through ``shard_map`` inserts that sum itself."""
    b_axis, d_axis = mesh.axis(batch_axis), mesh.axis(dim_axis)

    def fn(chain_local, x_local):
        _check_elementwise(chain_local)
        n = x_local.shape[0] * b_axis.size
        with torch.enable_grad():
            y, ladj = _forward(chain_local, x_local)
            tot = std_normal_logpdf(y).sum() + ladj.sum()
            grads = _grads_by_name(chain_local, [-tot / n])
        names = list(grads)
        summed = psum_flat([tot.detach()] + [grads[k] for k in names],
                           b_axis)
        negll = -psum(summed[0], d_axis) / n
        return negll, dict(zip(names, summed[1:]))

    return fn
