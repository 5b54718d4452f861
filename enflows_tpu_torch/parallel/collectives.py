"""Named collectives over one mesh axis.

PyTorch counterpart of ``enflows_tpu/parallel/collectives.py``: the same
domain-level names (consensus means, gathers for the resampler and the
diagnostics) over ``torch.distributed``, each taking the :class:`Axis`
(``mesh.axis(name)``) it runs along. Every op returns a new tensor and
leaves its input as it was; on an axis with no process group (one process,
no group up) each is the identity.

Backends. NCCL takes CUDA tensors for every op. gloo takes CPU tensors for
every op, and CUDA tensors for ``all_reduce`` and ``broadcast`` only; an op
that gloo cannot run on the device (``all_gather``, ``reduce_scatter``, the
ring's send and receive) is staged through the host in ``_staged`` and
counted in ``STAGED``, never under NCCL and never silently. ``COLLECTIVES``
counts every op launched, by name, and each runs inside a profiler range
``enflows.parallel.<name>``.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch
import torch.distributed as dist

from ..utils.profiling import annotate
from .mesh import Axis

COLLECTIVES: collections.Counter = collections.Counter()
STAGED: collections.Counter = collections.Counter()


def _device_ok(axis: Axis, tensors) -> bool:
    """True where the group's backend runs the op on these tensors where
    they lie: NCCL, or gloo with CPU tensors."""
    return axis.backend != "gloo" or not any(t.is_cuda for t in tensors)


def _staged(name: str, op: Callable, *tensors):
    """Run ``op`` on host copies of ``tensors`` and copy its results back to
    the first tensor's device: gloo with CUDA tensors, for an op gloo runs
    on the CPU only. Counted in ``STAGED[name]``."""
    STAGED[name] += 1
    device = tensors[0].device
    out = op(*(t.cpu() for t in tensors))
    if isinstance(out, (list, tuple)):
        return type(out)(o.to(device) for o in out)
    return out.to(device)


def _launch(name: str):
    COLLECTIVES[name] += 1
    return annotate(f"enflows.parallel.{name}")


def _all_reduce(x: torch.Tensor, axis: Axis, op, name: str) -> torch.Tensor:
    if axis.group is None:
        return x
    y = x.detach().clone().contiguous()
    with _launch(name):
        dist.all_reduce(y, op=op, group=axis.group)
    return y


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Cross-rank sum."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM, "psum")


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Cross-rank mean: the step-size / acceptance consensus primitive."""
    return psum(x, axis) / axis.size


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Cross-rank elementwise maximum."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX, "pmax")


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in rank order: concatenated
    (``tiled``) or stacked in a new axis ``dim``."""
    if axis.group is None:
        return x if tiled else x.unsqueeze(dim)
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), axis, dim, tiled).bool()
    x = x.detach().contiguous()

    def op(t):
        out = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(out, t, group=axis.group)
        return out

    with _launch("all_gather"):
        parts = op(x) if _device_ok(axis, [x]) else \
            _staged("all_gather", op, x)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def psum_scatter(x: torch.Tensor, axis: Axis, tiled: bool = True
                 ) -> torch.Tensor:
    """Reduce-scatter along dim 0: this rank's block of the cross-rank sum
    (``tiled``), or, untiled, its row of an x of ``axis.size`` rows."""
    if axis.group is None:
        return x if tiled else x[0]
    x = x.detach().contiguous()
    rows = x.shape[0] // axis.size

    def op(t):
        out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t, group=axis.group)
        return out

    with _launch("psum_scatter"):
        out = op(x) if _device_ok(axis, [x]) else \
            _staged("psum_scatter", op, x)
    return out if tiled else out[0]


def axis_index(axis: Axis) -> int:
    """This rank's coordinate along ``axis``."""
    return axis.index


def broadcast_from_zero(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of ``axis`` (one shared draw)."""
    if axis.group is None:
        return x
    y = x.detach().clone().contiguous()
    with _launch("broadcast"):
        dist.broadcast(y, src=axis.ranks[0], group=axis.group)
    return y


def ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """One hop of a ring: send ``x`` to the previous rank of ``axis`` and
    return the next rank's, both posted in one ``batch_isend_irecv``.
    After s hops rank i holds the block of rank (i + s) mod size."""
    if axis.group is None or axis.size == 1:
        return x
    x = x.detach().contiguous()
    k, i = axis.size, axis.index

    def op(t):
        buf = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, axis.ranks[(i - 1) % k],
                          group=axis.group),
               dist.P2POp(dist.irecv, buf, axis.ranks[(i + 1) % k],
                          group=axis.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf

    with _launch("ring_shift"):
        return op(x) if _device_ok(axis, [x]) else \
            _staged("ring_shift", op, x)


def psum_flat(tensors: list, axis: Axis, mean: bool = False) -> list:
    """``psum`` (or ``pmean``) of several tensors in one all-reduce of
    their concatenation: one collective a step for a loss and every
    gradient of a model."""
    if axis.group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    flat = psum(flat, axis)
    if mean:
        flat = flat / axis.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out
