"""Numerical-safety guards.

PyTorch counterpart of ``enflows_tpu/utils/debugging.py`` for one device:
``assert_finite`` raises ``ValueError`` on NaN/Inf in any floating leaf, as
JAX's ``checkify`` error surfaces; ``nan_guard`` wraps a function so that
its outputs are checked. Each check reads one flag a floating leaf back to
the host. ``assert_replicated_consistent`` gathers a replicated value
from every rank of a process group and compares the copies bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .pytree import tree_leaves


def assert_finite(x: Any, name: str = "value") -> None:
    """Raise ``ValueError`` naming ``name`` and the leaf's index if a
    floating tensor leaf of ``x`` holds NaN or Inf."""
    for i, leaf in enumerate(tree_leaves(x)):
        if isinstance(leaf, torch.Tensor) and (
                leaf.is_floating_point() or leaf.is_complex()):
            if not bool(torch.isfinite(leaf).all()):
                raise ValueError(f"non-finite values in {name} (leaf {i})")


def nan_guard(fn: Callable, name: str = "output") -> Callable:
    """``fn`` with every output leaf checked by ``assert_finite``."""

    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name)
        return out

    return checked


def assert_replicated_consistent(x: Any, name: str = "value",
                                 group=None) -> None:
    """Raise ``AssertionError`` if a replicated value differs between the
    ranks (``enflows_tpu/utils/debugging.py:55-66``): every tensor leaf of
    ``x`` (a tensor, a number, or a tree of them, e.g. a ``state_dict()``)
    is ``all_gather``-ed over ``group`` (a ``parallel`` mesh axis, or by
    default the world) and each rank's copy compared with rank 0's, bit for
    bit (NaN equal to NaN). Every rank must call it; with no process group
    up there is one copy and nothing to compare."""
    from ..parallel.collectives import all_gather
    from ..parallel.mesh import Axis
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return
        world = dist.get_world_size()
        group = Axis("world", world, dist.get_rank(), dist.group.WORLD,
                     range(world))
    for i, leaf in enumerate(tree_leaves(x)):
        if leaf is None or isinstance(leaf, str):
            continue
        t = torch.as_tensor(leaf)
        if group.backend == "nccl" and not t.is_cuda:
            t = t.cuda()
        copies = all_gather(t.detach().reshape(1, -1), group)
        if t.dtype == torch.bool or not (t.is_floating_point()
                                         or t.is_complex()):
            same = [bool(torch.equal(copies[0], c)) for c in copies]
        else:
            bits = copies.view(torch.int64 if t.element_size() == 8 else
                               torch.int32 if t.element_size() == 4 else
                               torch.int16)
            nan = torch.isnan(copies)
            same = [bool(((bits[0] == b) | (nan[0] & n)).all())
                    for b, n in zip(bits, nan)]
        for r, ok in enumerate(same):
            if not ok:
                raise AssertionError(
                    f"replicated {name} (leaf {i}) diverges between rank 0 "
                    f"and rank {r}")
