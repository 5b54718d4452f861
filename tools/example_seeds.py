"""Run an example script on other seeds, to see whether its gates hold on
more than the one seed it ships with.

    python tools/example_seeds.py torch <example> --seeds 0,1,2,3,4
        [--cpu] [-- <the example's own flags>]
    python tools/example_seeds.py jax <example> --seeds 0,1,2,3,4

``torch`` runs ``enflows_tpu_torch.examples.<example>.main`` (on the card
unless ``--cpu``) with every generator it makes seeded ``seed + 1000 *
s`` for run s (run 0 is the example as shipped), and prints the numbers
its gates read. ``jax`` runs the JAX script ``examples/<example>.py``'s
``main()`` on the CPU at its defaults with every ``PRNGKey(i)`` it makes
replaced by ``fold_in(PRNGKey(i), s)`` (run 0 as shipped). Each run's
exit code and seconds end its line; the process exits 0.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_torch(name, seeds, cpu, flags):
    import numpy as np
    import torch
    ex = importlib.import_module(f"enflows_tpu_torch.examples.{name}")
    argv = (["--cpu"] if cpu else []) + flags
    for s in seeds:
        ex.generator = lambda device, seed, s=s: torch.Generator(
            device=device).manual_seed(seed + 1000 * s)
        report = {}
        t0 = time.perf_counter()
        try:
            rc = ex.main(argv, report=report)
        except Exception as e:      # the example itself failed on this seed
            print(f"[seeds] torch {name} {argv} run {s}: "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        if name == "one_call_infer":
            numbers = {case: round(float(report[case].diagnostics["rhat"]
                                         .max()), 4)
                       for case in ("r1", "r2")}
        else:
            numbers = {k: np.round(v, 4).tolist() if hasattr(v, "shape")
                       else v for k, v in report.items()}
        print(f"[seeds] torch {name} {argv} run {s}: {numbers}; return "
              f"{rc}; {time.perf_counter() - t0:.1f} s", flush=True)


def run_jax(name, seeds):
    import jax
    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    shipped = jax.random.PRNGKey
    for s in seeds:
        jax.random.PRNGKey = (shipped if s == 0 else
                              lambda i, s=s: jax.random.fold_in(shipped(i), s))
        t0 = time.perf_counter()
        try:
            rc = ex.main()
        except Exception as e:      # the script itself failed on this seed
            rc = f"{type(e).__name__}: {e}"
        finally:
            jax.random.PRNGKey = shipped
        print(f"[seeds] jax {name} run {s}: return {rc}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("torch", "jax"))
    p.add_argument("example")
    p.add_argument("--seeds", default="0,1,2,3,4")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.package == "torch":
        run_torch(args.example, seeds, args.cpu, flags)
    else:
        run_jax(args.example, seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
