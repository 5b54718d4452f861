"""Tracing and profiling hooks.

PyTorch counterpart of ``enflows_tpu/utils/profiling.py``: ``trace``
captures ``torch.profiler`` around a block and writes a Chrome trace;
``annotate`` names a region (``torch.profiler.record_function``). The
package's own ranges carry JAX's ``enflows.*`` scope names, and each kernel
launch one ``enflows.cuda.*`` range; a range adds no device
synchronization and no device work. ``StepTimer`` is a wall-clock step
rate that synchronizes the device when read.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator:
    """Profile the enclosed block: CPU activity, and CUDA activity when a
    card is present. On exit the card is waited for, so that the block's
    kernels are in the trace, and a Chrome trace
    (``trace_<pid>_<ns>.json``) is written into ``log_dir``. Yields the
    ``torch.profiler.profile``; with ``log_dir=None`` nothing is profiled
    and it yields None."""
    if log_dir is None:
        yield None
        return
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region on the profiler's timeline, as a context manager
    (``torch.profiler.record_function``)."""
    return record_function(name)


def synchronize(sync_on=None) -> None:
    """Wait for the cards that hold ``sync_on``'s tensors, or for the
    current card when ``sync_on`` is None and CUDA is in use."""
    devices = {leaf.device for leaf in tree_leaves(sync_on)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    if sync_on is None and torch.cuda.is_initialized():
        devices.add(torch.device("cuda", torch.cuda.current_device()))
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock steps/s; ``rate()`` first waits for the card."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        return self

    def tick(self, n: int = 1):
        self.steps += n

    def rate(self, sync_on=None) -> float:
        """Steps a second since ``start``, after ``synchronize(sync_on)``."""
        synchronize(sync_on)
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")
