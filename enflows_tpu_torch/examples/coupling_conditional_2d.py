"""Conditional structure with coupling flows: the banana target.

Counterpart of ``examples/coupling_conditional_2d.py``. Elementwise warps
and rotations cannot whiten a target whose second coordinate depends
nonlinearly on the first; the banana density

    x1 ~ N(0, 1),     x2 | x1 ~ N(0.5 * x1^2 - 1, 0.3^2)

is the canonical case. The script

1. fits a coupling-stack whitening flow to draws from the banana by
   maximum likelihood (``optimize_whitening``, forward KL: the fit covers
   the whole ridge);
2. checks that the whitened data's covariance is the identity and that
   both whitened coordinates are marginally standard normal;
3. hands the same data to ``infer(data=...)`` with the coupling template,
   which refits the whitening transport and samples the preconditioned
   banana with NUTS, and checks the draws' moments.

At d=2 and 2,000-row batches the port's row rule
(``ops.coupling.coupling_batch_held``) keeps every step on the plain path:
no kernel runs here.

Run: python -m enflows_tpu_torch.examples.coupling_conditional_2d [--cpu]
     [--data 60000] [--batches 30] [--epochs 60] [--chains 32]
     [--warmup 400] [--samples 600]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.train import optimize_whitening

N_LAYERS, HIDDEN = 6, (48, 48)


def banana_logp(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized banana log density, (n, 2) -> (n,)
    (``coupling_conditional_2d.py:44-48``)."""
    x1, x2 = q[..., 0], q[..., 1]
    mu2 = 0.5 * x1 ** 2 - 1.0
    return -0.5 * x1 ** 2 - 0.5 * ((x2 - mu2) / 0.3) ** 2


def banana_draws(gen: torch.Generator, n: int,
                 dtype=torch.float32) -> torch.Tensor:
    """n exact draws from the banana, (n, 2), on the generator's device."""
    x1 = torch.randn(n, generator=gen, dtype=dtype, device=gen.device)
    x2 = 0.5 * x1 ** 2 - 1.0 + 0.3 * torch.randn(
        n, generator=gen, dtype=dtype, device=gen.device)
    return torch.stack([x1, x2], dim=-1)


def stack(gen: torch.Generator, dtype=torch.float32) -> et.Chain:
    """The whitening flow: six identity-initialized affine couplings with
    (48, 48) conditioners and reversal permutes
    (``coupling_conditional_2d.py:65-66``)."""
    return et.coupling_stack(gen, 2, n_layers=N_LAYERS, hidden=HIDDEN,
                             dtype=dtype, device=gen.device)


def adam(params) -> torch.optim.Optimizer:
    """``optax.adam(2e-3)``'s counterpart."""
    return torch.optim.Adam(params, lr=2e-3)


def whiten(X: torch.Tensor, flow, nbatches: int = 30, nepochs: int = 60):
    """The maximum-likelihood fit of ``flow`` to ``X`` with Adam(2e-3)
    (``coupling_conditional_2d.py:67-68``)."""
    return optimize_whitening(X, flow, adam, nbatches=nbatches,
                              nepochs=nepochs)


def whitening_gate(Y: np.ndarray):
    """(ok, covariance, +-1 sd quantiles) of the whitened data
    (``coupling_conditional_2d.py:71-78``)."""
    C = np.cov(Y, rowvar=False)
    q = np.quantile(Y, [0.159, 0.841], axis=0)
    ok = bool(np.abs(C - np.eye(2)).max() < 0.15
              and np.abs(np.abs(q) - 1.0).max() < 0.25)
    return ok, C, q


def sampling_gate(draws: np.ndarray):
    """(ok, x1 mean, x1 sd, residual mean, residual sd) of the draws
    (``coupling_conditional_2d.py:89-100``)."""
    x1, x2 = draws[:, 0], draws[:, 1]
    resid = (x2 - 0.5 * x1 ** 2 + 1.0) / 0.3
    stats = (x1.mean(), x1.std(), resid.mean(), resid.std())
    ok = bool(abs(stats[0]) < 0.15 and abs(stats[1] - 1.0) < 0.2
              and abs(stats[2]) < 0.2 and abs(stats[3] - 1.0) < 0.3)
    return (ok, *stats)


def main(argv=None, report: dict | None = None) -> int:
    """Runs the script; 0 if both gates hold, else 1. ``report``: a dict
    that receives the gates' values, for a caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", type=int, default=60_000)
    p.add_argument("--batches", type=int, default=30)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--samples", type=int, default=600)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)

    X = banana_draws(generator(dev, 0), args.data)

    # 1. Coupling-stack whitening (identity-initialized; the reversal
    #    permutes give both coordinates a conditioning turn).
    fit = whiten(X, stack(generator(dev, 1)), args.batches, args.epochs)
    with torch.no_grad():
        Y = fit.result(X).double().cpu().numpy()
    white_ok, C, q = whitening_gate(Y)
    print(f"whitened cov       : [[{C[0, 0]:.3f} {C[0, 1]:+.3f}] "
          f"[{C[1, 0]:+.3f} {C[1, 1]:.3f}]] (want I)")
    print(f"whitened +-1sd qts : {q[0].round(2)} / {q[1].round(2)} "
          f"(want ~[-1 -1] / [1 1])", flush=True)

    # 2. One-call inference with the data-driven (mode-covering)
    #    preconditioner: infer refits the coupling whitening on X and
    #    samples the preconditioned banana with NUTS.
    result = et.infer(
        banana_logp, dim=2, key=generator(dev, 2), method="nuts",
        num_chains=args.chains, num_warmup=args.warmup,
        num_samples=args.samples, data=X,
        flow_template=et.coupling_flow_template(N_LAYERS, HIDDEN),
        whiten_batches=args.batches, whiten_epochs=args.epochs, device=dev)

    draws = result.draws.double().cpu().numpy().reshape(-1, 2)
    samp_ok, m1, s1, mr, sr = sampling_gate(draws)
    rhat = float(result.diagnostics["rhat"].max())
    print(f"rhat max           : {rhat:.4f}")
    print(f"min bulk ESS       : {result.diagnostics['min_bulk_ess']:.0f}")
    print(f"x1 mean/sd         : {m1:+.3f} / {s1:.3f} (want 0 / 1)")
    print(f"conditional resid  : {mr:+.3f} / {sr:.3f} (want 0 / 1)")

    ok = white_ok and samp_ok
    print("PASS" if ok else
          f"FAIL (whitening {'ok' if white_ok else 'BAD'}, "
          f"sampling {'ok' if samp_ok else 'BAD'})", flush=True)
    if report is not None:
        report.update(cov=C, quantiles=q, rhat=rhat, x1=(m1, s1),
                      resid=(mr, sr), white_ok=white_ok, samp_ok=samp_ok,
                      history=fit.negll_history)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
