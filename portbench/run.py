"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of a fixed number of the cell's units. The last line of standard
output is one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error and the result's
last key. Exits non-zero, with no result, when there is no card, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# Fixed directories inside the checkout, so that only a checkout's first
# run builds or compiles anything.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def _json_number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", t_start=T_START,
                              cell=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['limit'] is not None and c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    result["checks"] = {k: {"value": _json_number(c["value"]),
                            "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
