"""Johnson SU bijector pair: tail-shaping map to/from normality.

PyTorch counterpart of ``enflows_tpu/bijectors/johnson.py``:

    forward:  y = gamma + delta * asinh((x - xi) / lambda)
    inverse:  x = lambda * sinh((y - gamma) / delta) + xi

The inverse-direction ladj uses the stable
``logcosh(u) = |u| + log1p(e^{-2|u|}) - log 2``.
"""
from __future__ import annotations

import torch

from .base import Bijector, as_parameter, sum_ladjs

_LOG2 = 0.6931471805599453


def johnson_forward(x, gamma, delta, xi, lam):
    """``enflows_tpu/bijectors/johnson.py:26``."""
    return gamma + delta * torch.asinh((x - xi) / lam)


def johnson_inverse(y, gamma, delta, xi, lam):
    """``enflows_tpu/bijectors/johnson.py:30``."""
    return lam * torch.sinh((y - gamma) / delta) + xi


def johnson_ladj(x, gamma, delta, xi, lam):
    """``enflows_tpu/bijectors/johnson.py:34``."""
    u = (x - xi) / lam
    return (torch.log(torch.abs(delta)) - torch.log(torch.abs(lam))
            - 0.5 * torch.log1p(u * u))


def _logcosh(u):
    """``enflows_tpu/bijectors/johnson.py:58``."""
    au = torch.abs(u)
    return au + torch.log1p(torch.exp(-2.0 * au)) - _LOG2


def johnson_inv_ladj(y, gamma, delta, xi, lam):
    """``enflows_tpu/bijectors/johnson.py:63``."""
    u = (y - gamma) / delta
    return torch.log(torch.abs(lam)) - torch.log(torch.abs(delta)) \
        + _logcosh(u)


class _JohnsonParams(Bijector):
    def __init__(self, gamma=10.0, delta=3.5, xi=10.0, lam=1.0):
        super().__init__()
        self.gamma = as_parameter(gamma)
        self.delta = as_parameter(delta)
        self.xi = as_parameter(xi)
        self.lam = as_parameter(lam)

    def fields(self):
        return {"gamma": self.gamma, "delta": self.delta, "xi": self.xi,
                "lam": self.lam}


class Johnson(_JohnsonParams):
    """Forward Johnson SU transform (``enflows_tpu/bijectors/johnson.py:70``).
    Defaults gamma=10, delta=3.5, xi=10, lambda=1."""

    def forward(self, x):
        return johnson_forward(x, self.gamma, self.delta, self.xi, self.lam)

    def forward_and_ladj(self, x):
        y = self.forward(x)
        elem = johnson_ladj(x, self.gamma, self.delta, self.xi, self.lam)
        return y, sum_ladjs(elem.expand(y.shape))

    def inverse(self):
        return JohnsonInv(self.gamma, self.delta, self.xi, self.lam)


class JohnsonInv(_JohnsonParams):
    """Inverse Johnson SU transform
    (``enflows_tpu/bijectors/johnson.py:100``)."""

    def forward(self, y):
        return johnson_inverse(y, self.gamma, self.delta, self.xi, self.lam)

    def forward_and_ladj(self, y):
        x = self.forward(y)
        elem = johnson_inv_ladj(y, self.gamma, self.delta, self.xi, self.lam)
        return x, sum_ladjs(elem.expand(x.shape))

    def inverse(self):
        return Johnson(self.gamma, self.delta, self.xi, self.lam)
