"""End to end: train, precondition, sample.

Counterpart of ``examples/full_pipeline.py``, on the 2-D example target
(ScaleShift o Householder o CenterStretch):

1. observe data from the warped target and fit a whitening flow (on the
   card B3 a step, 250 rows);
2. run NUTS on the target raw and preconditioned by the fitted flow; the
   preconditioned chains mix far faster;
3. cross-check with tempered SMC;
4. the three agree on the target's medians.

Run: python -m enflows_tpu_torch.examples.full_pipeline [--cpu]
     [--data 50000] [--batches 200] [--epochs 10] [--chains 64]
     [--warmup 400] [--samples 500] [--particles 32768]
     [--mutation-steps 10]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
# The generative flow, base -> data (``full_pipeline.py:38-42``): the 2-D
# example's.
from enflows_tpu_torch.examples.nf_example_2d import ground_truth
from enflows_tpu_torch.mcmc import ess_per_dim, flow_preconditioned, sample
from enflows_tpu_torch.smc import smc_sample
from enflows_tpu_torch.train import optimize_whitening


def _vec(device, dtype):
    return lambda *a: torch.tensor(a, dtype=dtype, device=device)


def model(V: torch.Tensor) -> et.Chain:
    """The whitening flow, data -> base: Johnson stages for the heavy tails,
    an inverted CenterStretch, the inverted reflection ``V`` (2,) drawn by
    the caller, a ScaleShift (``full_pipeline.py:54-62``)."""
    v = _vec(V.device, V.dtype)
    return et.compose(
        et.Johnson(v(0.0, 0.0), v(5.0, 5.0), v(0.0, 0.0), v(5.0, 5.0)),
        et.invert(et.CenterStretch(v(0.0, 0.0), v(1.0, 1.0), v(0.0, 0.0))),
        et.invert(et.Householder(V)),
        et.ScaleShift(v(1.0, 1.0), v(0.0, 0.0)))


def fit(X: torch.Tensor, flow, nbatches: int = 200, nepochs: int = 10):
    """``optimize_whitening`` with the default optimizer, ``optax.adagrad(
    0.1)``'s counterpart (``full_pipeline.py:64-65``)."""
    return optimize_whitening(X, flow, nbatches=nbatches, nepochs=nepochs)


def weighted_median(vals: np.ndarray, w: np.ndarray) -> float:
    """The weighted median of ``vals`` (``full_pipeline.py:110-112``)."""
    o = np.argsort(vals)
    cw = np.cumsum(w[o])
    return vals[o][np.searchsorted(cw, 0.5)]


def main(argv=None, report: dict | None = None) -> int:
    """Runs the pipeline; 0 if the agreement gate holds, else 1.
    ``report``: a dict that receives the gate's values, for a caller that
    checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", type=int, default=50_000)
    p.add_argument("--batches", type=int, default=200)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--warmup", type=int, default=400)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--particles", type=int, default=32768)
    p.add_argument("--mutation-steps", type=int, default=10)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    target = et.FlowDistribution(ground_truth(dev)).requires_grad_(False)
    logp = target.logpdf
    with torch.no_grad():
        X = target.sample(generator(dev, 0), (args.data,), dim=2)
    Xh = X.double().cpu().numpy()
    true_mean = Xh.mean(0)

    # 1. Whitening fit.
    t0 = time.perf_counter()
    res = fit(X, model(torch.randn(2, generator=generator(dev, 1),
                                   device=dev)), args.batches, args.epochs)
    hist = res.negll_history.double().cpu().numpy()
    print(f"[1] whitening fit in {time.perf_counter() - t0:.1f}s; "
          f"final negll {hist[-50:].mean():.3f}", flush=True)

    # 2. NUTS raw against preconditioned.
    kw = dict(dim=2, num_chains=args.chains, num_warmup=args.warmup,
              num_samples=args.samples, device=dev)
    t0 = time.perf_counter()
    s_raw, _, st_raw = sample(logp, generator(dev, 2), **kw)
    sync()
    t_raw = time.perf_counter() - t0
    ess_raw = float(ess_per_dim(s_raw).min())

    pre = flow_preconditioned(logp, et.invert(res.result))
    t0 = time.perf_counter()
    s_pre, _, st_pre = sample(pre.logdensity_fn, generator(dev, 3),
                              target_accept=0.9, **kw)
    sync()
    t_pre = time.perf_counter() - t0
    with torch.no_grad():
        x_pre = pre.push_forward(s_pre)
    z_pre = x_pre.double().cpu().numpy().reshape(-1, 2)
    ess_pre = float(ess_per_dim(x_pre).min())
    div_raw = int(st_raw.divergent.sum())
    div_pre = int(st_pre.divergent.sum())
    print(f"[2] NUTS raw: min-ESS {ess_raw:.0f} in {t_raw:.1f}s "
          f"({div_raw} div) | preconditioned: min-ESS {ess_pre:.0f} in "
          f"{t_pre:.1f}s ({div_pre} div, "
          f"{ess_pre / t_pre / (ess_raw / t_raw):.0f}x ESS/s)", flush=True)

    # 3. SMC cross-check.
    parts, lw, logz, infos = smc_sample(
        logp, generator(dev, 4), dim=2, num_particles=args.particles,
        mutation_steps=args.mutation_steps, leapfrog_steps=20)
    w = torch.softmax(lw.double(), 0).cpu().numpy()
    ph = parts.double().cpu().numpy()
    smc_mean = (w[:, None] * ph).sum(0)
    logz = float(logz)
    print(f"[3] SMC: {len(infos)} temperatures, logZ {logz:.3f} "
          f"(target is normalized: 0 expected)", flush=True)

    # 4. Agreement. The target is heavy-tailed (CenterStretch a=4), so the
    # medians are the robust statistic; means carry large Monte-Carlo
    # error at these sample counts.
    nuts_mean = z_pre.mean(0)
    data_med = np.median(Xh, axis=0)
    nuts_med = np.median(z_pre, axis=0)
    smc_med = np.array([weighted_median(ph[:, d], w) for d in range(2)])
    print(f"[4] means:   data {true_mean.round(3)} | "
          f"NUTS {nuts_mean.round(3)} | SMC {smc_mean.round(3)}")
    print(f"    medians: data {data_med.round(3)} | "
          f"NUTS {nuts_med.round(3)} | SMC {smc_med.round(3)}")
    ok = bool(np.abs(nuts_med - data_med).max() < 0.15
              and np.abs(smc_med - data_med).max() < 0.15
              and abs(logz) < 0.2
              and ess_pre > 10 * ess_raw)
    print("PASS" if ok else "FAIL", flush=True)
    if report is not None:
        report.update(nuts_med=nuts_med, smc_med=smc_med, data_med=data_med,
                      logz=logz, ess_raw=ess_raw, ess_pre=ess_pre,
                      temperatures=len(infos), t_raw=t_raw, t_pre=t_pre,
                      div_raw=div_raw, div_pre=div_pre)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
