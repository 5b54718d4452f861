"""One-call inference on warped 2-D targets.

Counterpart of ``examples/one_call_infer.py``: three calls of ``infer``
replace the hand-wired train, precondition and sample pipeline
(``full_pipeline``):

1. a heavy-tailed unimodal target: the auto ladder's VI transport (on the
   card its elementwise rung runs B1 + B2 a step), then NUTS;
2. a bimodal target with observed data: a whitening transport fitted on
   the data (mode-covering; B3 a step on the card), then NUTS;
3. the bimodal target without data: tempered SMC, which also gives
   log Z. No kernel runs here.

The JAX script only prints; so does this one, and it returns 0.

Run: python -m enflows_tpu_torch.examples.one_call_infer [--cpu]
     [--vi-steps 500] [--warmup 400] [--samples 500] [--data 100000]
     [--whiten-batches 200] [--whiten-epochs 8] [--particles 16384]
     [--mutation-steps 5]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.examples.nf_example_2d import ground_truth


def _vec(device, dtype):
    return lambda *a: torch.tensor(a, dtype=dtype, device=device)


def heavy_tailed(device, dtype=torch.float32) -> et.FlowDistribution:
    """Target [1]: N(0, I) pushed through ScaleShift, one Householder
    reflection and a JohnsonInv tail warp (``one_call_infer.py:29-33``)."""
    v = _vec(device, dtype)
    f1 = et.compose(et.ScaleShift(v(1.3, 0.4), v(2.5, -1.2)),
                    et.Householder(v(1.0, 0.3)),
                    et.JohnsonInv(v(0.5, -0.3), v(2.0, 2.5), v(0.0, 0.0),
                                  v(1.0, 1.5)))
    return et.FlowDistribution(f1).requires_grad_(False)


def bimodal(device, dtype=torch.float32) -> et.FlowDistribution:
    """Targets [2] and [3]: CenterStretch pushes the mass off centre
    (``one_call_infer.py:44-48``; the 2-D example's generative flow)."""
    return et.FlowDistribution(ground_truth(device, dtype)) \
        .requires_grad_(False)


def main(argv=None, report: dict | None = None) -> int:
    """Runs the three cases and prints a line each. ``report``: a dict
    that receives each case's ``InferenceResult`` ("r1", "r2", "r3") and
    the data ("X"), for a caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--vi-steps", type=int, default=500)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--data", type=int, default=100_000)
    p.add_argument("--whiten-batches", type=int, default=200)
    p.add_argument("--whiten-epochs", type=int, default=8)
    p.add_argument("--particles", type=int, default=16384)
    p.add_argument("--mutation-steps", type=int, default=5)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)
    report = {} if report is None else report

    # 1. Heavy tails (Johnson warp): the auto reverse-KL transport suffices.
    t1 = heavy_tailed(dev)
    r1 = et.infer(t1.logpdf, dim=2, key=generator(dev, 0), num_chains=8,
                  num_warmup=args.warmup, num_samples=args.samples,
                  vi_steps=args.vi_steps, device=dev)
    d = r1.diagnostics
    print(f"[1] NUTS+auto: rhat={d['rhat'].max():.4f} "
          f"min_bulk_ess={d['min_bulk_ess']:.0f} "
          f"divergences={d['divergences']} mean={np.round(d['mean'], 3)}",
          flush=True)

    # 2. Bimodal with observed data: the whitening transport is
    # mode-covering where reverse KL is not.
    t2 = bimodal(dev)
    with torch.no_grad():
        X = t2.sample(generator(dev, 9), (args.data,), dim=2)
    r2 = et.infer(t2.logpdf, dim=2, key=generator(dev, 1), data=X,
                  whiten_batches=args.whiten_batches,
                  whiten_epochs=args.whiten_epochs, num_chains=8,
                  num_warmup=args.warmup, num_samples=args.samples,
                  device=dev)
    d2 = r2.diagnostics
    print(f"[2] NUTS+data-whitening: rhat={d2['rhat'].max():.4f} "
          f"mean={np.round(d2['mean'], 3)} "
          f"(data mean {np.round(X.double().mean(0).cpu().numpy(), 3)})",
          flush=True)

    # 3. The same target without data: SMC tempering crosses the density
    # hole and gives log Z.
    r3 = et.infer(t2.logpdf, dim=2, key=generator(dev, 2), method="smc",
                  precondition=None, num_particles=args.particles,
                  mutation_steps=args.mutation_steps, device=dev)
    d3 = r3.diagnostics
    print(f"[3] SMC: logZ={d3['log_z']:.4f} (true 0.0) "
          f"weight_ess={d3['weight_ess']:.0f} "
          f"mean={np.round(d3['mean'], 3)}", flush=True)
    report.update(r1=r1, r2=r2, r3=r3, X=X)
    return 0


if __name__ == "__main__":
    sys.exit(main())
