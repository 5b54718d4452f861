"""Checkpoint / resume for training and sampling state.

PyTorch counterpart of ``enflows_tpu/utils/checkpoint.py``. A checkpoint is
``<path>/step_{k}.pt``, written by ``torch.save`` to a temporary name in the
same directory and moved into place with ``os.replace``: a process killed
while writing leaves the previous step as the latest, never a torn file.
The state is a nested dict, list or tuple of tensors, numbers, strings,
optimizer ``state_dict()`` s and generator states
(``torch.Generator.get_state()``); it is read back with
``weights_only=True``.

Sharded state (one process per rank, ``torch.distributed`` up): a leaf
wrapped as :class:`Shard` (a rank's block of rows of a global tensor) is
written by its rank to its own file ``step_{k}.shards.r{rank}.pt`` with
the block's global rows; every other leaf is replicated and written once,
by rank 0, after every rank's shard file is in place (a barrier), so
``step_{k}.pt`` marks a whole checkpoint. Every rank must call
``save_checkpoint``. ``restore_checkpoint`` reassembles each sharded leaf
for the ``Shard`` at its place in ``like`` from whichever files hold its
rows, so a run may resume on another number of ranks that divides the
global size. ``use_orbax=`` has no counterpart and raises.
"""
from __future__ import annotations

import collections
import glob
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist


def _unported_orbax():
    return NotImplementedError(
        "use_orbax=True has no counterpart in enflows_tpu_torch: Orbax is "
        "a JAX library; checkpoints are torch.save files")


class Shard(NamedTuple):
    """A rank's block of a tensor sharded along dim 0: ``local`` holds the
    global rows ``[start, start + len(local))`` of a tensor of ``length``
    rows (``parallel.block_range`` gives them)."""
    local: torch.Tensor
    start: int
    length: int


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _plain(value, shards=None):
    """``value`` as containers ``weights_only`` loads: named tuples become
    tuples, numpy arrays and scalars tensors and numbers, tensors detached
    copies on the CPU (a copy, so that a view saves its own elements and
    not its base's whole storage). A :class:`Shard` becomes a placeholder
    ``{"__shard__": i, "length": rows}``, its (start, local rows) appended
    to ``shards``."""
    if isinstance(value, Shard):
        shards.append((value.start, _plain(value.local)))
        return {"__shard__": len(shards) - 1, "length": value.length}
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, collections.OrderedDict):
        return collections.OrderedDict((k, _plain(v, shards))
                                       for k, v in value.items())
    if isinstance(value, dict):
        return {k: _plain(v, shards) for k, v in value.items()}
    if isinstance(value, list):
        return [_plain(v, shards) for v in value]
    if isinstance(value, tuple):
        return tuple(_plain(v, shards) for v in value)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value.copy())
    if isinstance(value, np.generic):
        return value.item()
    return value


def _rows(pieces: list, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a sharded leaf from its saved blocks
    ``pieces`` [(start, rows)]."""
    parts = []
    for p0, rows in sorted(pieces, key=lambda p: p[0]):
        a, b = max(start, p0), min(stop, p0 + rows.shape[0])
        if a < b:
            parts.append(rows[a - p0:b - p0])
    got = sum(p.shape[0] for p in parts)
    if got != stop - start:
        raise ValueError(f"checkpoint holds {got} of the rows "
                         f"[{start}, {stop}) of a sharded leaf")
    return torch.cat(parts)


def _like(value, like, pieces=None):
    """``value`` (as loaded) in the shape of ``like``: its named tuples,
    numpy arrays and, for every tensor, the device of the matching leaf of
    ``like``. A tensor with no tensor at its place in ``like`` stays on the
    CPU. A shard placeholder becomes the :class:`Shard` of ``like``'s rows,
    from the saved blocks ``pieces`` {index: [(start, rows)]}."""
    if isinstance(value, dict) and "__shard__" in value:
        if not isinstance(like, Shard):
            raise ValueError("a sharded leaf needs a Shard at its place in "
                             "like")
        rows = _rows(pieces[value["__shard__"]], like.start,
                     like.start + like.local.shape[0])
        return Shard(rows.to(like.local.device), like.start, like.length)
    if isinstance(value, dict):
        sub = like if isinstance(like, dict) else {}
        out = {k: _like(v, sub.get(k), pieces) for k, v in value.items()}
        return collections.OrderedDict(out) if isinstance(
            like, collections.OrderedDict) else out
    if isinstance(value, (list, tuple)):
        sub = like if isinstance(like, (list, tuple)) else ()
        items = [_like(v, sub[i] if i < len(sub) else None, pieces)
                 for i, v in enumerate(value)]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return tuple(items) if isinstance(value, tuple) else items
    if isinstance(value, torch.Tensor):
        if isinstance(like, torch.Tensor):
            return value.to(like.device)
        if isinstance(like, np.ndarray):
            return value.numpy()
    return value


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def _write(target: str, obj) -> None:
    # Not named step_*.pt: latest_step never sees a half-written file.
    tmp = os.path.join(os.path.dirname(target),
                       f".{os.path.basename(target)}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


def save_checkpoint(path: str, state: Any, step: int = 0,
                    use_orbax: bool = False) -> str:
    """Save ``state`` under the directory ``path`` as step ``step``; returns
    the file's path (``enflows_tpu/utils/checkpoint.py:50-110``). Tensors
    are copied to the host first, so the call waits for the device. Under
    ``torch.distributed`` every rank calls it: each writes its
    :class:`Shard` leaves to its own file, then rank 0 the rest."""
    if use_orbax:
        raise _unported_orbax()
    rank, world = _world()
    os.makedirs(path, exist_ok=True)
    shards: list = []
    plain = _plain(state, shards)
    if shards:
        _write(os.path.join(path, f"step_{step}.shards.r{rank}.pt"),
               {"rank": rank, "blocks": shards})
    if world > 1:
        dist.barrier()
    target = _file(path, step)
    if rank == 0:
        _write(target, plain)
    if world > 1:
        dist.barrier()
    return target


def restore_checkpoint(path: str, like: Any, step: int = 0,
                       use_orbax: bool = False) -> Any:
    """The state saved as step ``step`` under ``path``, read with
    ``weights_only=True``; ``like`` (the state of a fresh run) gives the
    named tuples, numpy arrays and the device of every tensor, and for a
    sharded leaf the :class:`Shard` whose rows to read
    (``enflows_tpu/utils/checkpoint.py:113-169``)."""
    if use_orbax:
        raise _unported_orbax()
    loaded = torch.load(_file(path, step), map_location="cpu",
                        weights_only=True)
    pieces: dict = collections.defaultdict(list)
    for f in sorted(glob.glob(os.path.join(path,
                                           f"step_{step}.shards.r*.pt"))):
        blocks = torch.load(f, map_location="cpu", weights_only=True)
        for i, (start, rows) in enumerate(blocks["blocks"]):
            pieces[i].append((start, rows))
    return _like(loaded, like, pieces)


def latest_step(path: str) -> int | None:
    """Largest step with a whole checkpoint (its ``step_{k}.pt``) under
    ``path``, else None (``enflows_tpu/utils/checkpoint.py:172-182``)."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        stem = name[5:-3]
        if name.startswith("step_") and name.endswith(".pt") and \
                stem.isdigit():
            steps.append(int(stem))
    return max(steps) if steps else None
