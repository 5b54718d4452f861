"""Readings for the limits of the numbers compared: the program's runs on
many seeds and the control's (the program with bf16 conditioner products)
on a few, at the cell's own sizes, each with a short window, all in one
process. Prints one JSON line a run and writes them to ``--out``.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --faults whiten.half --fault-seeds 7,8,9 \
        --seconds 2 --out calib.jsonl

A planted fault (``faults.py``) runs with the program's own precision. The
benchmark's own runs never run the control or a fault.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="faults of faults.FAULTS, each run on --fault-seeds")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    ints = lambda s: [int(v) for v in s.split(",") if v]
    runs = [(s, False, None) for s in ints(args.seeds)] + \
        [(s, True, None) for s in ints(args.control_seeds)] + \
        [(s, False, f) for f in args.faults.split(",") if f
         for s in ints(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    for seed, control, fault in runs:
        t0 = time.perf_counter()
        with faults.planted(fault) if fault else contextlib.nullcontext():
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 "cuda:0", control=control, cell=cell)
        line = dict(workload=args.workload, seed=seed, control=control,
                    fault=fault,
                    seconds=time.perf_counter() - t0,
                    checks={k: c["value"] for k, c in r["checks"].items()},
                    metrics={k: m["value"] for k, m in r["metrics"].items()},
                    peak=r["device"]["memory_peak_bytes"])
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
