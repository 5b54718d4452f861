"""Run one cell of the benchmark once: set-up, the measured (or traced)
window, the check against the reference, and the result line.

Everything a cell needs is found by name in files of its own:
``BENCHMARK.json`` names the cell's configuration (its ``file``) and traffic
mix; ``traffic/<traffic>.json`` holds the mix's parameters and names the
runner, ``runners/<runner>.py``, that runs it; ``cells/<cell>.json`` holds
what belongs to the cell alone (a sampler's step size, the limits of the
numbers compared, those it reports without comparing); and each per-layer
metric is read by
``metrics/<metric name>.py``. A configuration, a mix, a cell or a metric is
added by adding files.
"""
from __future__ import annotations

import collections
import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import torch

from . import trace as trace_mod
from .compare import Check

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WINDOW = trace_mod.WINDOW
IN_FLIGHT = 2       # units the host may run ahead of the card
FORBIDDEN = ("jax", "jaxlib", "flax", "enflows_tpu", "benchmarks", "bench")


def _merge(base: dict, over: dict | None) -> dict:
    return {**base, **(over or {})}


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix, cell parameters and
    metrics, as ``BENCHMARK.json`` and the files it names give them."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    path = root / "portbench" / "cells" / f"{workload}.json"
    params = json.loads(path.read_text()) if path.exists() else {}
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return dict(entry=cell, config=cfg, traffic=traffic, params=params,
                end_to_end=e2e, per_layer=per_layer)


@dataclass
class Run:
    """What a runner is given: the cell's files, the seed and the device.
    ``control`` builds the program's conditioners with bf16 products, the
    lower precision the check must fail."""
    name: str
    cfg: dict
    traffic: dict
    params: dict
    seed: int
    device: torch.device
    control: bool = False

    def limit(self, name: str) -> float | None:
        return self.params.get("limits", {}).get(name)

    def check(self, name: str, value: float) -> Check:
        return Check(name, value, self.limit(name))


def runner_for(run: Run):
    mod = importlib.import_module(
        f"portbench.runners.{run.traffic['runner']}")
    return mod.Runner(run)


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_units(runner, device, *, seconds=None, units=None) -> tuple:
    """Run the runner's unit until ``seconds`` have passed or ``units`` have
    run, with at most ``IN_FLIGHT`` units queued ahead of the card, then
    wait for the card. Returns (units, work, seconds)."""
    pending = collections.deque()
    n = work = 0
    gcs = []        # (generation, seconds) of each garbage collection
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            gcs.append((info["generation"],
                        time.perf_counter() - started.pop("t")))
    gc.callbacks.append(on_gc)
    t0 = last = time.perf_counter()
    gaps = []
    while True:
        work += runner.unit()
        n += 1
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > IN_FLIGHT:
                pending.popleft().synchronize()
        if units is not None and n >= units:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    gaps.sort()
    full = [t for g, t in gcs if g == 2]
    print(f"units: {n}, host seconds a unit min {gaps[0]:.4f} median "
          f"{gaps[len(gaps) // 2]:.4f} max {gaps[-1]:.4f}; garbage "
          f"collections {len(gcs)} in {sum(t for _, t in gcs):.4f} s, "
          f"{len(full)} of the oldest generation in {sum(full):.4f} s",
          file=sys.stderr)
    return n, work, elapsed


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             *, control: bool = False, overrides: dict | None = None,
             t_start: float | None = None, cell: dict | None = None,
             units: int | None = None) -> dict:
    """One run of the cell. Returns the result line's dict, its ``checks``
    last, each compared number with its limit. ``overrides`` replaces keys
    of the configuration, the traffic or the cell's parameters (the CPU
    tests' small sizes); ``cell`` a cell loaded beforehand; ``units`` a
    window of that many units in place of ``seconds``."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = cell or load_cell(workload)
    over = overrides or {}
    run = Run(workload, _merge(cell["config"], over.get("config")),
              _merge(cell["traffic"], over.get("traffic")),
              _merge(cell["params"], over.get("params")), seed, device,
              control)
    runner = runner_for(run)
    t_runner = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
    t_init = time.perf_counter()
    runner.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.3f} s: imports and files {t_runner - t_start:.3f}"
          f", device init {t_init - t_runner:.3f}, the runner's set-up "
          f"{t_start + setup_s - t_init:.3f}", file=sys.stderr)

    traced = None
    if trace:
        with trace_mod.profiled(device.type == "cuda") as out:
            run_units(runner, device, units=1)
            with torch.profiler.record_function(WINDOW):
                units, work, _ = run_units(
                    runner, device, units=run.traffic["trace_units"])
        traced = out["trace"]
        window_s = traced.window_s
    else:
        units, work, window_s = run_units(
            runner, device, seconds=None if units else seconds, units=units)

    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    info = runner.window_info(units)
    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = runner.check()
    # Numbers the cell's file names as not compared (no reading separates
    # a fault from round-off; PERF.md) are printed, and decide nothing.
    shown = run.params.get("not_compared", {})
    for c in checks:
        if c.name in shown:
            print(f"not compared: {c.name} = {c.value!r} ({shown[c.name]})",
                  file=sys.stderr)
    checks = [c for c in checks if c.name not in shown]

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks), "attempted": units,
              "failed": failed + sum(not c.ok for c in checks)}
    units_of = {m["name"]: m["unit"] for m in
                cell["end_to_end"] + cell["per_layer"]}
    if traced is None:
        metrics = {"setup_s": setup_s,
                   run.traffic["rate_metric"]: work / window_s}
    else:
        ctx = SimpleNamespace(trace=traced, cfg=run.cfg, **info)
        metrics = {}
        for m in cell["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["metrics"] = {k: {"value": v, "unit": units_of[k]}
                         for k, v in metrics.items()}
    result["device"] = dev
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, the
    JAX package's or its benchmarks'."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
