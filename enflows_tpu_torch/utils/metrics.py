"""Structured metrics logging: a JSONL sink of per-step records.

PyTorch counterpart of ``enflows_tpu/utils/metrics.py``. Each record is
``{"step", "time", ...}`` as JAX writes it. With more than one rank
(``torch.distributed`` up), each rank writes its own file,
``{root}.r{rank}{ext}``, as each JAX process writes ``{root}.p{i}{ext}``. A record may
carry 0-d device tensors; they stay on the device while the record is
pending and are read back together, in one copy a device, when the logger
writes: every ``flush_every`` records, when ``history`` is read, and at
``close``. So a stream costs host reads only when it writes. JAX's
``from_jit`` has no counterpart, since the port compiles nothing: callers
use ``log``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def _read(tensors: list) -> list:
    """The values of 0-d tensors as Python numbers (bool, int or float by
    dtype), in one host copy per device; float64 holds every float32 value
    and integers up to 2^53 exactly."""
    out = [None] * len(tensors)
    by_device: dict = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        vals = torch.stack([tensors[i].detach().to(torch.float64)
                            for i in idx]).tolist()
        for i, v in zip(idx, vals):
            dt = tensors[i].dtype
            out[i] = bool(v) if dt == torch.bool else (
                v if dt.is_floating_point else int(v))
    return out


class MetricsLogger:
    """Per-step records to a JSON-lines file at ``path`` (appended) and to
    ``history``; ``path=None`` keeps ``history`` only. ``log(step,
    **metrics)`` takes numbers, numpy values and tensors: a 0-d tensor
    becomes a number when the record is written (so it must not be changed
    in place before then), a larger one a list at once."""

    def __init__(self, path: Optional[str] = None, flush_every: int = 1):
        if path is not None and dist.is_available() and \
                dist.is_initialized() and dist.get_world_size() > 1:
            root, ext = os.path.splitext(path)
            path = f"{root}.r{dist.get_rank()}{ext or '.jsonl'}"
        self.path = path
        self.flush_every = flush_every
        self._pending: list[dict] = []
        self._file = open(path, "a") if path else None
        self._history: list[dict] = []

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.dim():
                v = v.tolist()
            elif hasattr(v, "item") and not isinstance(v, torch.Tensor):
                v = np.asarray(v).item() if np.ndim(v) == 0 \
                    else np.asarray(v).tolist()
            rec[k] = v
        self._pending.append(rec)
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Read the pending records' tensors and write the records."""
        if not self._pending:
            return
        slots = [(rec, k) for rec in self._pending for k, v in rec.items()
                 if isinstance(v, torch.Tensor)]
        for (rec, k), v in zip(slots, _read([rec[k] for rec, k in slots])):
            rec[k] = v
        self._history.extend(self._pending)
        if self._file:
            self._file.write("".join(json.dumps(rec) + "\n"
                                     for rec in self._pending))
            self._file.flush()
        self._pending = []

    @property
    def history(self) -> list[dict]:
        """Every record logged so far, the pending ones read first."""
        self.flush()
        return self._history

    def close(self) -> None:
        self.flush()
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
