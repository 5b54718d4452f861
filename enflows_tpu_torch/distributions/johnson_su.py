"""Johnson SU distribution: a standard normal pushed through JohnsonInv.

PyTorch counterpart of ``enflows_tpu/distributions/johnson_su.py``: pdf,
cdf, logpdf and quantile map through the Johnson transform and its
derivative; sampling pushes standard-normal draws from a
``torch.Generator`` through the inverse transform. Parameter defaults
gamma=10, delta=3.5, xi=10, lambda=1.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.special import log_ndtr, ndtr, ndtri

from ..bijectors.johnson import johnson_forward, johnson_inverse, johnson_ladj
from .base import std_normal_logpdf


class JohnsonSU(nn.Module):
    """``enflows_tpu/distributions/johnson_su.py:27``. The four parameters
    are buffers, so the distribution moves with ``.to()`` and
    ``utils.param_dtype`` reads their dtype."""

    def __init__(self, gamma, delta, xi, lam):
        super().__init__()
        for name, value in (("gamma", gamma), ("delta", delta), ("xi", xi),
                            ("lam", lam)):
            self.register_buffer(name, torch.as_tensor(value))

    @classmethod
    def init(cls, gamma=10.0, delta=3.5, xi=10.0, lam=1.0,
             dtype=torch.float32, device="cuda") -> "JohnsonSU":
        """The parameters as 0-d tensors of ``dtype`` on ``device`` (the
        card unless the caller asks for the CPU)."""
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return cls(t(gamma), t(delta), t(xi), t(lam))

    def _z(self, x):
        return johnson_forward(x, self.gamma, self.delta, self.xi, self.lam)

    def logpdf(self, x):
        return (johnson_ladj(x, self.gamma, self.delta, self.xi, self.lam)
                + std_normal_logpdf(self._z(x)))

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        return ndtr(self._z(x))

    def logcdf(self, x):
        return log_ndtr(self._z(x))

    def ccdf(self, x):
        return ndtr(-self._z(x))

    def logccdf(self, x):
        return log_ndtr(-self._z(x))

    def quantile(self, p):
        return johnson_inverse(ndtri(p), self.gamma, self.delta, self.xi,
                               self.lam)

    def sample(self, generator: torch.Generator, shape=()):
        """Draws of ``shape`` on the generator's device, in the parameters'
        dtype."""
        z = torch.randn(tuple(shape), generator=generator,
                        dtype=self.gamma.dtype, device=generator.device)
        return johnson_inverse(z, self.gamma, self.delta, self.xi, self.lam)

    def minimum(self):
        return -math.inf

    def maximum(self):
        return math.inf

    def params(self):
        """(gamma, delta, xi, lambda)."""
        return (self.gamma, self.delta, self.xi, self.lam)

    def location(self):
        return self.mean()

    def scale(self):
        """The variance, as the JAX version returns."""
        return self.var()

    def mean(self):
        d2 = 1.0 / (self.delta * self.delta)
        return (self.xi - self.lam * torch.exp(d2 / 2.0)
                * torch.sinh(self.gamma / self.delta))

    def median(self):
        return self.xi + self.lam * torch.sinh(-self.gamma / self.delta)

    def var(self):
        d2 = 1.0 / (self.delta * self.delta)
        return (self.lam ** 2 / 2.0 * (torch.exp(d2) - 1.0)
                * (torch.exp(d2) * torch.cosh(2.0 * self.gamma / self.delta)
                   + 1.0))
