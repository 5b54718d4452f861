"""Reading a ``torch.profiler`` trace: the traced window, the device's busy
time as the union of its operations' intervals, time by kernel name, host
time inside the program's ranges, and the idle gaps by what the host was
doing.

The traced window is the benchmark's own ``portbench.window`` range; the
device was idle when it opened and is synchronized before it closes.
Device operations are kernels, copies and fills; where two overlap, the
overlap counts once.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Iterator

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """The events of one Chrome trace (``export_chrome_trace``), times in
    microseconds, restricted to the last ``portbench.window`` range."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X"]
        windows = [e for e in spans if e.get("name") == WINDOW
                   and e.get("cat", "").lower() == "user_annotation"]
        if not windows:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        w = max(windows, key=lambda e: float(e["ts"]))
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.thread = (w.get("pid"), w.get("tid"))
        self.device = []
        self.host = []
        for e in spans:
            cat = e.get("cat", "").lower()
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                s, t = max(s, self.t0), min(t, self.t1)
                if t > s:
                    self.device.append((s, t, e.get("name", "")))
            elif cat in HOST_CATS and e is not w and s < self.t1 \
                    and t > self.t0:
                self.host.append((s, t, e.get("name", ""), cat,
                                  (e.get("pid"), e.get("tid"))))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return 1e-6 * sum(e - s for s, e in union(
            (s, t) for s, t, _ in self.device))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernel_s(self, *patterns: str) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return 1e-6 * sum(t - s for s, t, n in self.device
                          if any(p in n for p in patterns))

    def count(self, *patterns: str) -> int:
        """Device operations whose name holds a pattern."""
        return sum(1 for _, _, n in self.device
                   if any(p in n for p in patterns))

    def host_s(self, *names: str) -> float:
        """Host seconds inside the ranges of these exact names."""
        return 1e-6 * sum(min(t, self.t1) - max(s, self.t0)
                          for s, t, n, _, _ in self.host if n in names)

    def gaps(self) -> list[tuple[float, float]]:
        """Idle (start, end) stretches of the window, in microseconds."""
        out, at = [], self.t0
        for s, e in union((s, t) for s, t, _ in self.device):
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def host_activity(self, t: float) -> str:
        """What the window's thread was doing at ``t``: the outermost range
        and the innermost operation open then."""
        open_ = [(s, e, n) for s, e, n, _, th in self.host
                 if th == self.thread and s <= t < e]
        if not open_:
            return "host: outside any operation"
        open_.sort(key=lambda x: (x[0], -x[1]))
        outer, inner = open_[0][2], open_[-1][2]
        return outer if outer == inner else f"{outer} > {inner}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing, each as [name, seconds]."""
        by_name: dict[str, float] = {}
        for s, t, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[self.host_activity(s), (e - s) * 1e-6]
                              for s, e in gaps]}


@contextlib.contextmanager
def profiled(cuda: bool) -> Iterator[dict]:
    """Profile the enclosed block; on exit ``out["trace"]`` holds its
    ``Trace``. The Chrome trace goes through a temporary file in TMPDIR,
    removed once read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out: dict = {}
    with profile(activities=acts) as prof:
        yield out
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    out["trace"] = Trace(events)
