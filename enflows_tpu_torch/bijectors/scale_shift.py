"""Elementwise affine bijector ``y = a * x + b``.

PyTorch counterpart of ``enflows_tpu/bijectors/scale_shift.py``. Params may be
scalars or per-dimension vectors. The inverse shares the Parameters ``a`` and
``b`` and computes ``1/a`` and ``-b/a`` from them at call time.
"""
from __future__ import annotations

import torch

from .base import Bijector, as_parameter, sum_ladjs


class ScaleShift(Bijector):
    """``enflows_tpu/bijectors/scale_shift.py:21``.

    ``inverted=True`` makes the module the map ``y = (x - b) / a`` over the
    same Parameters; ``inverse()`` flips the flag on a sibling.
    """

    def __init__(self, a, b, *, inverted: bool = False):
        super().__init__()
        self.a = as_parameter(a)
        self.b = as_parameter(b)
        self.inverted = inverted

    def fields(self):
        """Effective ``(a, b)`` of ``y = a * x + b``: for the inverse these are
        ``1/a`` and ``-b/a`` (``scale_shift.py:36-38``)."""
        if not self.inverted:
            return {"a": self.a, "b": self.b}
        a_inv = 1.0 / self.a
        return {"a": a_inv, "b": -a_inv * self.b}

    def forward(self, x):
        f = self.fields()
        return x * f["a"] + f["b"]

    def forward_and_ladj(self, x):
        f = self.fields()
        y = x * f["a"] + f["b"]
        elem = torch.log(torch.abs(f["a"])).expand(y.shape)
        return y, sum_ladjs(elem)

    def inverse(self):
        """``enflows_tpu/bijectors/scale_shift.py:36``."""
        return ScaleShift(self.a, self.b, inverted=not self.inverted)
