"""CenterStretch / CenterContract: smooth move-mass-from/toward-center pair.

PyTorch counterpart of ``enflows_tpu/bijectors/center_stretch.py`` (see its
module doc for the derivation). The contract direction is a double softplus;
the stretch direction is its closed-form inverse, computed

* in f32 by the single-exp form (one exp, one log, one sqrt, plus one log
  for the ladj), which assumes ``a * b >= 0`` and clamps ``m = |b x|`` at
  ``1e-6``;
* in f64 by the fully log-domain form, the high-precision oracle.

The stretch ladj is the contract ladj at the output, negated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Bijector, as_parameter, sum_ladjs

_LOG2 = 0.6931471805599453
_LOG4 = 1.3862943611198906


def center_contract(x, a, b, c):
    """``enflows_tpu/bijectors/center_stretch.py:52``."""
    xu = x - c
    return (F.softplus(b * (xu - a)) - F.softplus(-b * (xu + a))) / b


def center_contract_ladj(x, a, b, c):
    """Elementwise log|dy/dx| of ``center_contract``
    (``enflows_tpu/bijectors/center_stretch.py:58``)."""
    xu = x - c
    dy_dx = torch.sigmoid(b * (xu - a)) + torch.sigmoid(-b * (xu + a))
    return torch.log(torch.abs(dy_dx))


def _center_stretch_logdomain(x, a, b, c):
    """``enflows_tpu/bijectors/center_stretch.py:65``."""
    m = torch.clamp(torch.abs(b * x), min=1e-6)
    ab = a * b
    log_a_ = torch.log1p(-torch.exp(-m))
    log_b_ = _LOG4 - 2.0 * ab - m
    log_s = m + ab - _LOG2 + torch.logaddexp(
        log_a_, 0.5 * torch.logaddexp(2.0 * log_a_, log_b_))
    return c + torch.sign(x) * log_s / b


def _is_f64(*ts) -> bool:
    return any(t.dtype == torch.float64 for t in ts)


def center_stretch(x, a, b, c):
    """Closed-form inverse of ``center_contract``
    (``enflows_tpu/bijectors/center_stretch.py:79``): f64 takes the
    log-domain form, f32 the single-exp form."""
    if _is_f64(x, a, b, c):
        return _center_stretch_logdomain(x, a, b, c)
    m = torch.clamp(torch.abs(b * x), min=1e-6)
    ab = a * b
    em = torch.exp(-m)
    one_m = 1.0 - em
    c1 = 4.0 * torch.exp(-2.0 * ab)
    r = torch.sqrt(one_m * one_m + c1 * em)
    log_s = m + ab - _LOG2 + torch.log(one_m + r)
    return c + torch.sign(x) * log_s / b


class CenterStretch(Bijector):
    """Stretch mass away from the center
    (``enflows_tpu/bijectors/center_stretch.py:103``). Params ``a``
    (half-width), ``b`` (sharpness, > 0), ``c`` (center)."""

    def __init__(self, a=0.0, b=1.0, c=0.0):
        super().__init__()
        self.a = as_parameter(a)
        self.b = as_parameter(b)
        self.c = as_parameter(c)

    def fields(self):
        return {"a": self.a, "b": self.b, "c": self.c}

    def forward(self, x):
        return center_stretch(x, self.a, self.b, self.c)

    def forward_and_ladj(self, x):
        """``enflows_tpu/bijectors/center_stretch.py:122-147``."""
        a, b, c = self.a, self.b, self.c
        if _is_f64(x, a, b, c):
            y = _center_stretch_logdomain(x, a, b, c)
            elem = -center_contract_ladj(y, a, b, c)
            return y, sum_ladjs(elem.expand(y.shape))
        m = torch.clamp(torch.abs(b * x), min=1e-6)
        ab = a * b
        em = torch.exp(-m)
        one_m = 1.0 - em
        c1 = 4.0 * torch.exp(-2.0 * ab)
        r = torch.sqrt(one_m * one_m + c1 * em)
        denom = one_m + r
        log_s = m + ab - _LOG2 + torch.log(denom)
        y = c + torch.sign(x) * log_s / b
        ae = 2.0 * em / denom
        a2 = torch.exp(2.0 * ab)
        s_sum = 1.0 / (1.0 + ae) + ae / (ae + a2)
        elem = -torch.log(s_sum)
        return y, sum_ladjs(elem.expand(y.shape))

    def inverse(self):
        return CenterContract(self.a, self.b, self.c)


class CenterContract(Bijector):
    """Contract mass toward the center
    (``enflows_tpu/bijectors/center_stretch.py:154``)."""

    def __init__(self, a=0.0, b=1.0, c=0.0):
        super().__init__()
        self.a = as_parameter(a)
        self.b = as_parameter(b)
        self.c = as_parameter(c)

    def fields(self):
        return {"a": self.a, "b": self.b, "c": self.c}

    def forward(self, x):
        return center_contract(x, self.a, self.b, self.c)

    def forward_and_ladj(self, x):
        y = self.forward(x)
        elem = center_contract_ladj(x, self.a, self.b, self.c)
        return y, sum_ladjs(elem.expand(y.shape))

    def inverse(self):
        return CenterStretch(self.a, self.b, self.c)
