"""Fused-leapfrog HMC on a declared flow-pushforward target.

Counterpart of ``examples/fused_pushforward_hmc.py``: a target declared as
an exact pushforward, X = T(Z) with Z ~ N(mu, diag(var)), rather than
closed over in an opaque function, lets ``infer(method="hmc")`` run every
trajectory through the whitening chain T^{-1} in one launch of the fused
leapfrog kernel B6 on the card; no VI fit is needed, because the declared
chain is the exact transport. The draws are checked against Monte-Carlo
moments from the generative definition.

Run: python -m enflows_tpu_torch.examples.fused_pushforward_hmc [--cpu]
     [--chains 256] [--warmup 200] [--samples 500]
"""
from __future__ import annotations

import argparse
import sys

import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.mcmc import FlowPushforwardTarget

DIM = 8


def transport(V: torch.Tensor) -> et.Chain:
    """The ground-truth transport, base -> data: rotate by the canonicalized
    reflections ``V`` (4, 8), stretch the tails, shift and scale
    (``fused_pushforward_hmc.py:34-42``)."""
    like = dict(dtype=V.dtype, device=V.device)
    v = lambda val: torch.full((DIM,), val, **like)
    lin = lambda a, b: torch.linspace(a, b, DIM, **like)
    return et.compose(
        et.ScaleShift(lin(0.5, 2.0), lin(-1.0, 1.0)),
        et.invert(et.Johnson(v(0.0), v(4.0), v(0.0), v(4.0))),
        et.Householder(V).canonicalize())


def base(device, dtype=torch.float32):
    """(mean, variance) of the diagonal-Gaussian base
    (``fused_pushforward_hmc.py:43-44``)."""
    return (0.3 * torch.ones(DIM, dtype=dtype, device=device),
            torch.linspace(0.8, 1.4, DIM, dtype=dtype, device=device))


def target(V: torch.Tensor) -> FlowPushforwardTarget:
    """The declared target (``fused_pushforward_hmc.py:46``)."""
    mu, var = base(V.device, V.dtype)
    return FlowPushforwardTarget(transport(V), base_mean=mu, base_var=var)


def moment_errors(draws: torch.Tensor, tgt: FlowPushforwardTarget,
                  gen: torch.Generator, n: int = 200_000):
    """(max mean error, max sd relative error) of ``draws`` against n
    Monte-Carlo draws of T(Z) (``fused_pushforward_hmc.py:53-59``)."""
    with torch.no_grad():
        z = tgt.base_mean + torch.sqrt(tgt.base_var) * torch.randn(
            n, DIM, generator=gen, dtype=draws.dtype, device=draws.device)
        xs = tgt.transport(z).double()
    got = draws.reshape(-1, DIM).double()
    mean_err = float((got.mean(0) - xs.mean(0)).abs().max())
    sd_rel = float((got.std(0, unbiased=False) / xs.std(0, unbiased=False)
                    - 1).abs().max())
    return mean_err, sd_rel


def main(argv=None, report: dict | None = None) -> int:
    """Runs the script; 0 if the moments hold, else 1. ``report``: a dict
    that receives the ``InferenceResult`` ("result") and the gate's
    values, for a caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--chains", type=int, default=256)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--samples", type=int, default=500)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)

    V = torch.randn(4, DIM, generator=generator(dev, 0), device=dev)
    tgt = target(V)
    if not tgt.fused_kernel_available(DIM):
        raise RuntimeError("the declared chain is not one B6 takes")

    result = et.infer(tgt, dim=DIM, key=generator(dev, 1), method="hmc",
                      num_chains=args.chains, num_warmup=args.warmup,
                      num_samples=args.samples, device=dev)
    mean_err, sd_rel = moment_errors(result.draws, tgt, generator(dev, 2))
    dg = result.diagnostics
    print(f"fused-route HMC: mean err {mean_err:.4f}, "
          f"sd rel err {sd_rel:.4f}, "
          f"min bulk ESS {dg['min_bulk_ess']:.0f}, "
          f"accept {dg['accept_prob']:.2f}")
    ok = mean_err < 0.1 and sd_rel < 0.1
    print("OK" if ok else "FAIL", flush=True)
    if report is not None:
        report.update(result=result, mean_err=mean_err, sd_rel=sd_rel)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
