"""2-D density estimation with a Householder rotation stage.

Counterpart of ``examples/nf_example_2d.py``: the ground truth is
ScaleShift o Householder o CenterStretch; the model is built from inverted
stages and fitted with Adagrad (1,000 batches x 10 epochs over 10^5
samples), then checked by cov(f(X)) ~ I and mean(f(X)) ~ 0. On the card
every step is one launch of the fused kernel B3 (d=2, 100 rows).

Run: python -m enflows_tpu_torch.examples.nf_example_2d [--cpu]
     [--data 100000] [--batches 1000] [--epochs 10]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.train import optimize_whitening


def _vec(device, dtype):
    return lambda *a: torch.tensor(a, dtype=dtype, device=device)


def ground_truth(device, dtype=torch.float32) -> et.Chain:
    """The generative flow, base -> data (``nf_example_2d.py:29-34``)."""
    v = _vec(device, dtype)
    return et.compose(et.ScaleShift(v(1.3, 0.4), v(2.5, -1.2)),
                      et.Householder(v(1.0, 0.3)),
                      et.CenterStretch(v(4.0, 4.1), v(2.0, 2.1),
                                       v(3.0, 3.1)))


def model(V: torch.Tensor) -> et.Chain:
    """The whitening flow, data -> base, its one reflection ``V`` (2,)
    drawn by the caller (``nf_example_2d.py:38-44``)."""
    v = _vec(V.device, V.dtype)
    return et.compose(
        et.invert(et.CenterStretch(v(0.0, 0.0), v(1.0, 1.0), v(0.0, 0.0))),
        et.invert(et.Householder(V)),
        et.ScaleShift(v(1.0, 1.0), v(0.0, 0.0)))


def fit(X: torch.Tensor, flow, nbatches: int = 1000, nepochs: int = 10):
    """``optimize_whitening`` with the default optimizer, ``optax.adagrad(
    0.1)``'s counterpart (``nf_example_2d.py:46-47``)."""
    return optimize_whitening(X, flow, nbatches=nbatches, nepochs=nepochs)


def main(argv=None, report: dict | None = None) -> int:
    """Runs the script; 0 if the gate holds, else 1. ``report``: a dict
    that receives the gate's values, for a caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", type=int, default=10 ** 5)
    p.add_argument("--batches", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=10)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)

    XW = torch.randn(args.data, 2, generator=generator(dev, 0), device=dev)
    with torch.no_grad():
        X = ground_truth(dev)(XW)
    V = torch.randn(2, generator=generator(dev, 1), device=dev)
    res = fit(X, model(V), args.batches, args.epochs)

    with torch.no_grad():
        XW2 = res.result(X).double().cpu().numpy()
    cov = np.cov(XW2.T)
    mean = XW2.mean(0)
    print("cov(f(X)) =\n", cov.round(4))
    print("mean(f(X)) =", mean.round(4))
    ok = bool(np.abs(cov - np.eye(2)).max() < 0.1
              and np.abs(mean).max() < 0.1)
    print("PASS" if ok else "FAIL", flush=True)
    if report is not None:
        report.update(cov=cov, mean=mean)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
