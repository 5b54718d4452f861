"""Multimodal marginals with rational-quadratic spline couplings.

Counterpart of ``examples/spline_multimodal_2d.py``. No affine or linear
map whitens a bimodal marginal; a spline coupling gives each transformed
coordinate a K-bin monotone warp that places the split directly. On

    x0 ~ 1/2 N(-2, 0.5^2) + 1/2 N(+2, 0.5^2),   x1 | x0 ~ N(0.5 x0, 0.8^2)

the script

1. fits spline and affine coupling whitening flows of equal size by
   maximum likelihood and checks that the spline beats the best linear
   map (the Gaussian MLE negll) clearly and the affine stack measurably;
2. samples the fitted flow's exact inverse and checks the pushforward's
   mode balance and mid-gap mass;
3. refines the transport by VI (``optimize_elbo(stl=True)``) warm-started
   from the inverted fit, and checks that both modes stay covered.

At d=2 and 1,024-row batches the port's row rule
(``ops.coupling.coupling_batch_held``) keeps every step on the plain path:
no kernel runs here.

Run: python -m enflows_tpu_torch.examples.spline_multimodal_2d [--cpu]
     [--data 65536] [--batches 64] [--epochs 30] [--vi-steps 300]
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.train import (mvnormal_negll, optimize_elbo,
                                     optimize_whitening)

N_LAYERS, HIDDEN = 3, (32,)


def make_data(n: int, seed: int = 0) -> np.ndarray:
    """n draws from the target, (n, 2) float32, from numpy's generator
    (``spline_multimodal_2d.py:54-59``): the same data as the JAX
    script's."""
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, 2, n)
    x0 = rng.normal(0, 0.5, n) + np.where(comp, 2.0, -2.0)
    x1 = 0.5 * x0 + rng.normal(0, 0.8, n)
    return np.stack([x0, x1], 1).astype(np.float32)


def log_density(z: torch.Tensor) -> torch.Tensor:
    """The target's normalized log density, (n, 2) -> (n,)
    (``spline_multimodal_2d.py:62-69``)."""
    x0, x1 = z[..., 0], z[..., 1]
    half_log_2pi = 0.5 * math.log(2 * math.pi)
    m = torch.logaddexp(-0.5 * ((x0 - 2.0) / 0.5) ** 2,
                        -0.5 * ((x0 + 2.0) / 0.5) ** 2) \
        - math.log(2.0) - half_log_2pi - math.log(0.5)
    c = -0.5 * ((x1 - 0.5 * x0) / 0.8) ** 2 - half_log_2pi - math.log(0.8)
    return m + c


def gaussian_bound(X: np.ndarray) -> float:
    """The Gaussian MLE negll of X: the best any linear map can do
    (``spline_multimodal_2d.py:74-76``)."""
    cov = np.cov(X.T)
    return float(0.5 * 2 * (1 + np.log(2 * np.pi))
                 + 0.5 * np.linalg.slogdet(cov)[1])


def spline_stack(gen: torch.Generator, dtype=torch.float32) -> et.Chain:
    """Three spline couplings, (32,) conditioners, 8 bins on [-6, 6]
    (``spline_multimodal_2d.py:80-81``)."""
    return et.spline_coupling_stack(gen, 2, n_layers=N_LAYERS, hidden=HIDDEN,
                                    n_bins=8, bound=6.0, dtype=dtype,
                                    device=gen.device)


def affine_stack(gen: torch.Generator, dtype=torch.float32) -> et.Chain:
    """The affine stack of the same size (``spline_multimodal_2d.py:82-83``).
    """
    return et.coupling_stack(gen, 2, n_layers=N_LAYERS, hidden=HIDDEN,
                             dtype=dtype, device=gen.device)


def whiten(X: torch.Tensor, flow, nbatches: int = 64, nepochs: int = 30):
    """The maximum-likelihood fit with Adam(5e-3)
    (``spline_multimodal_2d.py:79-85``)."""
    return optimize_whitening(X, flow,
                              lambda p: torch.optim.Adam(p, lr=5e-3),
                              nbatches=nbatches, nepochs=nepochs)


def refine(flow, gen: torch.Generator, nsteps: int = 300, dtype=None):
    """VI from the inverted fit ``flow`` (base -> data): Adam(3e-4), 512
    antithetic pairs a step, sticking-the-landing gradients
    (``spline_multimodal_2d.py:110-112``)."""
    return optimize_elbo(log_density, flow,
                         lambda p: torch.optim.Adam(p, lr=3e-4), dim=2,
                         batch_size=512, nsteps=nsteps, stl=True, key=gen,
                         dtype=dtype or et.param_dtype(flow))


def mode_balance(x: np.ndarray) -> float:
    return float((x[:, 0] > 0).mean())


def main(argv=None, report: dict | None = None) -> int:
    """Runs the script; 0 if every check holds, else 1 after the first
    that fails. ``report``: a dict that receives the checks' values, for a
    caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", type=int, default=65536)
    p.add_argument("--batches", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--vi-steps", type=int, default=300)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)
    report = {} if report is None else report

    def check(ok, what):
        if not ok:
            print(f"FAIL: {what}", flush=True)
        return ok

    Xn = make_data(args.data)
    X = torch.from_numpy(Xn).to(dev)
    bound = gaussian_bound(Xn.astype(np.float64))

    # 1. Maximum-likelihood whitening: spline against affine, equal size.
    r_spl = whiten(X, spline_stack(generator(dev, 0)), args.batches,
                   args.epochs)
    r_aff = whiten(X, affine_stack(generator(dev, 0)), args.batches,
                   args.epochs)
    with torch.no_grad():
        n_spl = float(mvnormal_negll(r_spl.result, X))
        n_aff = float(mvnormal_negll(r_aff.result, X))
    print(f"negll  spline {n_spl:.4f}  affine {n_aff:.4f}  "
          f"gaussian-bound {bound:.4f}", flush=True)
    report.update(n_spl=n_spl, n_aff=n_aff, bound=bound)
    if not (check(n_spl < bound - 0.25, "spline did not beat the linear "
                  "bound")
            and check(n_spl < n_aff - 0.05, "spline did not beat the "
                      "affine stack")):
        return 1

    # 2. The sampling direction: the exact inverse pushes base normals to
    # the data.
    z = torch.randn(65536, 2, generator=generator(dev, 1), device=dev)
    with torch.no_grad():
        samp = r_spl.result.inverse()(z).double().cpu().numpy()
    bal = mode_balance(samp)
    gap = float((np.abs(samp[:, 0]) < 0.7).mean())
    print(f"pushforward: mode balance {bal:.3f}, mid-gap mass {gap:.4f}, "
          f"mean {samp.mean(0).round(3)}, sd {samp.std(0).round(3)}",
          flush=True)
    report.update(balance=bal, gap=gap)
    if not check(0.4 < bal < 0.6 and gap < 0.05, "pushforward modes"):
        return 1

    # 3. VI refinement with sticking-the-landing gradients, warm-started
    # from the inverted fit (base -> data). Gentle: reverse KL pulls
    # toward one mode wherever the family cannot hold the target exactly,
    # so the steps and the rate polish rather than re-tilt the fit.
    r_vi = refine(et.invert(r_spl.result), generator(dev, 3), args.vi_steps)
    zv = torch.randn(65536, 2, generator=generator(dev, 4), device=dev)
    with torch.no_grad():
        zvi = r_vi.result(zv).double().cpu().numpy()
    bal_vi = mode_balance(zvi)
    tail = float(r_vi.nelbo_history[-50:].double().mean())
    print(f"VI(stl): tail nELBO {tail:.4f}, mode balance {bal_vi:.3f}",
          flush=True)
    report.update(balance_vi=bal_vi, tail_nelbo=tail)
    if not check(0.25 < bal_vi < 0.75, "VI collapsed to one mode"):
        return 1
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
