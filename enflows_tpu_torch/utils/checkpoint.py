"""Checkpoint / resume for training and sampling state.

PyTorch counterpart of ``enflows_tpu/utils/checkpoint.py`` for one device.
A checkpoint is one file, ``<path>/step_{k}.pt``, written by ``torch.save``
to a temporary name in the same directory and moved into place with
``os.replace``: a process killed while writing leaves the previous step as
the latest, never a torn file. The state is a nested dict, list or tuple of
tensors, numbers, strings, optimizer ``state_dict()`` s and generator
states (``torch.Generator.get_state()``); it is read back with
``weights_only=True``. JAX's per-process shard files and ``use_orbax=``
wait for the multi-device port (ROADMAP A.10).
"""
from __future__ import annotations

import collections
import os
from typing import Any

import numpy as np
import torch


def _unported_orbax():
    return NotImplementedError(
        "use_orbax=True is not ported to enflows_tpu_torch yet "
        "(ROADMAP A.10)")


def _plain(value):
    """``value`` as containers ``weights_only`` loads: named tuples become
    tuples, numpy arrays and scalars tensors and numbers, tensors detached
    copies on the CPU (a copy, so that a view saves its own elements and
    not its base's whole storage)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, collections.OrderedDict):
        return collections.OrderedDict((k, _plain(v))
                                       for k, v in value.items())
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value.copy())
    if isinstance(value, np.generic):
        return value.item()
    return value


def _like(value, like):
    """``value`` (as loaded) in the shape of ``like``: its named tuples,
    numpy arrays and, for every tensor, the device of the matching leaf of
    ``like``. A tensor with no tensor at its place in ``like`` stays on the
    CPU."""
    if isinstance(value, dict):
        sub = like if isinstance(like, dict) else {}
        out = {k: _like(v, sub.get(k)) for k, v in value.items()}
        return collections.OrderedDict(out) if isinstance(
            like, collections.OrderedDict) else out
    if isinstance(value, (list, tuple)):
        sub = like if isinstance(like, (list, tuple)) else ()
        items = [_like(v, sub[i] if i < len(sub) else None)
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


def save_checkpoint(path: str, state: Any, step: int = 0,
                    use_orbax: bool = False) -> str:
    """Save ``state`` under the directory ``path`` as step ``step``; returns
    the file's path (``enflows_tpu/utils/checkpoint.py:50-110``). Tensors
    are copied to the host first, so the call waits for the device."""
    if use_orbax:
        raise _unported_orbax()
    os.makedirs(path, exist_ok=True)
    target = _file(path, step)
    # Not named step_*: latest_step never sees a half-written file.
    tmp = os.path.join(path, f".step_{step}.pt.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        torch.save(_plain(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return target


def restore_checkpoint(path: str, like: Any, step: int = 0,
                       use_orbax: bool = False) -> Any:
    """The state saved as step ``step`` under ``path``, read with
    ``weights_only=True``; ``like`` (the state of a fresh run) gives the
    named tuples, numpy arrays and the device of every tensor
    (``enflows_tpu/utils/checkpoint.py:113-169``)."""
    if use_orbax:
        raise _unported_orbax()
    loaded = torch.load(_file(path, step), map_location="cpu",
                        weights_only=True)
    return _like(loaded, like)


def latest_step(path: str) -> int | None:
    """Largest step with a saved checkpoint under ``path``, else None
    (``enflows_tpu/utils/checkpoint.py:172-182``)."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            stem = name[5:].split(".")[0]
            if stem.isdigit():
                steps.append(int(stem))
    return max(steps) if steps else None
