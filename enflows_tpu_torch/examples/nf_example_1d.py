"""1-D density estimation by maximum-likelihood whitening.

Counterpart of ``examples/nf_example_1d.py``: a ground-truth
CenterStretch o Johnson flow warps N(0, 1) into a heavy-tailed 1-D
target; a 4-stage flow is fitted from an identity-like start with Adagrad
(100 batches x 10 epochs over 10^5 samples) and checked against the
analytic negll of the true inverse and by the whitened data's quantiles.
On the card every step is one launch of the fused kernel B3 (d=1, 1,000
rows).

Run: python -m enflows_tpu_torch.examples.nf_example_1d [--cpu]
     [--data 100000] [--batches 100] [--epochs 10]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import example_device, generator
from enflows_tpu_torch.train import mvnormal_negll, optimize_whitening

QUANTILES = [5, 25, 50, 75, 95]


def _vec(device, dtype):
    return lambda v: torch.full((1,), v, dtype=dtype, device=device)


def ground_truth(device, dtype=torch.float32) -> et.Chain:
    """The generative flow, base -> data (``nf_example_1d.py:33-37``)."""
    v = _vec(device, dtype)
    return et.compose(et.CenterStretch(v(4.0), v(1.0), v(0.0)),
                      et.Johnson(v(10.0), v(3.5), v(10.0), v(1.0)))


def model(device, dtype=torch.float32) -> et.Chain:
    """The 4-stage whitening flow, data -> base, from an identity-like start
    (``nf_example_1d.py:42-47``)."""
    v = _vec(device, dtype)
    johnson = lambda: et.Johnson(v(0.0), v(5.0), v(0.0), v(5.0))
    stretch_inv = lambda: et.invert(et.CenterStretch(v(0.0), v(1.0),
                                                     v(0.0)))
    return et.compose(johnson(), stretch_inv(), johnson(), stretch_inv())


def fit(X: torch.Tensor, flow, nbatches: int = 100, nepochs: int = 10):
    """``optimize_whitening`` with the default optimizer, ``optax.adagrad(
    0.1)``'s counterpart (``nf_example_1d.py:49-50``)."""
    return optimize_whitening(X, flow, nbatches=nbatches, nepochs=nepochs)


def main(argv=None, report: dict | None = None) -> int:
    """Runs the script; 0 if the gate holds, else 1. ``report``: a dict
    that receives the gate's values, for a caller that checks them."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--data", type=int, default=10 ** 5)
    p.add_argument("--batches", type=int, default=100)
    p.add_argument("--epochs", type=int, default=10)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    dev = example_device(args.cpu)

    f_true = ground_truth(dev)
    XW = torch.randn(args.data, 1, generator=generator(dev, 0), device=dev)
    with torch.no_grad():
        X = f_true(XW)
    res = fit(X, model(dev), args.batches, args.epochs)

    # The negll against the analytic line, and the whitened quantiles.
    hist = res.negll_history.double().cpu().numpy()
    with torch.no_grad():
        target_negll = float(mvnormal_negll(et.invert(f_true), X))
        XW2 = res.result(X).double().cpu().numpy()
    final_negll = float(hist[-100:].mean())
    q_model = np.percentile(XW2, QUANTILES)
    q_base = np.percentile(XW.double().cpu().numpy(), QUANTILES)

    print(f"negll: initial {hist[0]:.4f} -> final {final_negll:.4f} "
          f"(analytic target {target_negll:.4f})")
    print(f"whitened quantiles {QUANTILES}: {q_model.round(3)}")
    print(f"  N(0,1) quantiles       : {q_base.round(3)}")
    # Central quantiles tight, the 5/95% tails looser: 1,000 Adagrad steps
    # leave visible tail slack.
    ok = bool(final_negll < target_negll + 0.05
              and np.abs(q_model[1:4] - q_base[1:4]).max() < 0.12
              and np.abs(q_model - q_base).max() < 0.3)
    print("PASS" if ok else "FAIL", flush=True)
    if report is not None:
        report.update(final_negll=final_negll, target_negll=target_negll,
                      q_model=q_model, q_base=q_base)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
