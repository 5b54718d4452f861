"""Base densities and flow-pushforward distributions.

PyTorch counterpart of ``enflows_tpu/distributions/base.py``. Samples come
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..bijectors.base import Bijector

_LOG_2PI = 1.8378770664093453


def std_normal_logpdf(x: torch.Tensor) -> torch.Tensor:
    """Elementwise standard-normal log-density
    (``enflows_tpu/distributions/base.py:20``)."""
    return -(x * x + _LOG_2PI) / 2.0


def std_normal_logpdf_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-sample N(0, I) log-density, summed over the trailing event axis
    (``enflows_tpu/distributions/base.py:25``)."""
    elem = std_normal_logpdf(x)
    if elem.dim() == 0:
        return elem
    return elem.sum(-1)


class FlowDistribution(nn.Module):
    """Pushforward of N(0, I_dim) through ``bijector`` (base -> target)
    (``enflows_tpu/distributions/base.py:34``)."""

    def __init__(self, bijector: Bijector):
        super().__init__()
        self.bijector = bijector

    def _base_draws(self, generator, shape, dim, dtype, device):
        return torch.randn(tuple(shape) + (dim,), generator=generator,
                           dtype=dtype, device=device)

    def sample(self, generator: torch.Generator, shape, dim: int,
               dtype=torch.float32, device=None):
        """``enflows_tpu/distributions/base.py:43``; ``device`` defaults to
        the generator's."""
        device = generator.device if device is None else device
        z = self._base_draws(generator, shape, dim, dtype, device)
        return self.bijector(z)

    def sample_and_logpdf(self, generator: torch.Generator, shape, dim: int,
                          dtype=torch.float32, device=None):
        """``enflows_tpu/distributions/base.py:47``."""
        device = generator.device if device is None else device
        z = self._base_draws(generator, shape, dim, dtype, device)
        x, ladj = self.bijector.forward_and_ladj(z)
        return x, std_normal_logpdf_sum(z) - ladj

    def logpdf(self, x):
        """``enflows_tpu/distributions/base.py:52``."""
        z, ladj = self.bijector.inverse().forward_and_ladj(x)
        return std_normal_logpdf_sum(z) + ladj
