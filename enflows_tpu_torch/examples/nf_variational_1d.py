"""Flow-based variational inference against a 1D Gaussian mixture.

Counterpart of ``examples/nf_variational_1d.py``: negative-ELBO training of
a 4-stage elementwise transport (the inverse of Johnson -> inverted
CenterStretch, twice) with antithetic base draws, checked by pushing 10^5
base draws through the learned transport and comparing their moments with
the analytic mixture's. On the card every step runs the transport in the
fused kernel B1, with B2 as its backward.

Run: python -m enflows_tpu_torch.examples.nf_variational_1d [--cpu]
"""
from __future__ import annotations

import math
import sys

import torch

import enflows_tpu_torch as et
from enflows_tpu_torch.train import optimize_elbo

# The mixture: weights, means, unit variances.
WEIGHTS = (0.3, 0.5, 0.2)
MEANS = (2.0, 5.0, -1.0)
MEAN_TRUE = sum(w * m for w, m in zip(WEIGHTS, MEANS))
VAR_TRUE = sum(w * (1.0 + m * m) for w, m in zip(WEIGHTS, MEANS)) \
    - MEAN_TRUE ** 2


def mixture_logpdf(z: torch.Tensor) -> torch.Tensor:
    """Normalized log density of the mixture, (n, 1) -> (n,)."""
    x = z[..., 0]
    comps = torch.stack([math.log(w) + et.std_normal_logpdf(x - m)
                         for w, m in zip(WEIGHTS, MEANS)], dim=-1)
    return torch.logsumexp(comps, dim=-1)


def model(device, dtype=torch.float32):
    """The transport VI trains: the inverse of the reference's forward flow
    (``examples/nf_variational_1d.py:38-44``)."""
    vec = lambda v: torch.full((1,), v, dtype=dtype, device=device)

    def johnson():
        return et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0))

    def stretch_inv():
        return et.invert(et.CenterStretch(vec(0.0), vec(1.0), vec(0.0)))

    return et.invert(et.compose(johnson(), stretch_inv(), johnson(),
                                stretch_inv()))


def fit(key: torch.Generator, *, nsteps: int = 1000, lr: float = 0.1,
        batch_size: int = 100, dtype=torch.float32):
    """``optimize_elbo`` of the model with Adagrad(lr) on the generator's
    device; returns the ``VIResult``."""
    opt = lambda p: torch.optim.Adagrad(p, lr=lr,
                                        initial_accumulator_value=0.1)
    return optimize_elbo(mixture_logpdf, model(key.device, dtype), opt,
                         dim=1, batch_size=batch_size, nsteps=nsteps,
                         key=key, dtype=dtype)


def pushforward_moments(flow, key: torch.Generator, n: int = 10 ** 5,
                        dtype=torch.float32):
    """(mean, variance) of ``flow`` applied to n base draws from ``key``,
    through the flow's plain path."""
    xi = torch.randn(n, 1, generator=key, dtype=dtype, device=key.device)
    with torch.no_grad():
        z = flow(xi)[:, 0].double()
    return float(z.mean()), float(z.var(unbiased=False))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    res = fit(torch.Generator(device=device).manual_seed(0))
    mean, var = pushforward_moments(
        res.result, torch.Generator(device=device).manual_seed(1))
    hist = res.nelbo_history.cpu()
    print(f"nELBO: {float(hist[0]):.3f} -> {float(hist[-50:].mean()):.3f} "
          f"(0 = perfect fit, mixture is normalized)")
    print(f"pushforward mean {mean:.3f} (true {MEAN_TRUE}), var {var:.3f} "
          f"(true {VAR_TRUE:.2f})")
    ok = abs(mean - MEAN_TRUE) < 0.3 and abs(var - VAR_TRUE) < 1.5
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
