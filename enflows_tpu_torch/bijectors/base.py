"""Bijector protocol: composable trainable transforms with analytic ladjs.

PyTorch counterpart of ``enflows_tpu/bijectors/base.py``. The contracts are
the same:

* ``forward_and_ladj`` returns the transformed batch together with the
  per-sample log-abs-det-Jacobian, computed analytically.
* ``inverse()`` returns a parameter-*sharing* sibling: a module that holds
  the very same ``nn.Parameter`` objects. Where the inverse needs a derived
  value (``ScaleShift``'s ``1/a``, ``Householder``'s reversed rows) it
  computes it from those Parameters at call time, so gradients and
  optimizer updates reach one set of leaves.
* Arrays are ``(..., dim)`` with the event dimension last; per-sample ladjs
  have shape ``x.shape[:-1]``.

Bijectors are ``nn.Module`` s, so ``parameters()`` does the job that
``utils/pytree.py`` does for JAX: optimizers and autograd reach every leaf,
and a Parameter shared by two stages is listed once.
"""
from __future__ import annotations

import torch
from torch import nn


def as_parameter(value) -> nn.Parameter:
    """``value`` itself when it already is a Parameter (so siblings share it),
    otherwise a new floating-point Parameter holding a copy of it."""
    if isinstance(value, nn.Parameter):
        return value
    t = torch.as_tensor(value)
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    return nn.Parameter(t.detach().clone())


def sum_ladjs(elementwise_ladjs: torch.Tensor) -> torch.Tensor:
    """Collapse per-element ladjs to per-sample ladjs: a 0-d input stays as
    it is, otherwise sum over the trailing event axis.

    Counterpart of ``enflows_tpu/bijectors/base.py:36``."""
    if elementwise_ladjs.dim() == 0:
        return elementwise_ladjs
    return elementwise_ladjs.sum(-1)


def _ladj_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


class Bijector(nn.Module):
    """Base class (``enflows_tpu/bijectors/base.py:48``).

    Subclasses implement ``forward_and_ladj`` and ``inverse``; ``forward``
    (also reached through ``__call__``), ``>>`` composition and
    ``canonicalize`` are shared.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.forward_and_ladj(x)
        return y

    def forward_and_ladj(self, x: torch.Tensor):
        raise NotImplementedError

    def inverse(self) -> "Bijector":
        raise NotImplementedError

    def inverse_and_ladj(self, y: torch.Tensor):
        return self.inverse().forward_and_ladj(y)

    def canonicalize(self) -> "Bijector":
        """Normalize parameters after an optimizer step; returns ``self``.

        Counterpart of ``enflows_tpu/bijectors/base.py:70``. The JAX version
        returns a new pytree; here a stage that needs normalizing
        (``Householder``) updates its Parameters in place under
        ``torch.no_grad()``. Default: nothing to do."""
        return self

    def fields(self) -> dict:
        """The stage's parameters as the JAX dataclass of the same name holds
        them, keyed by its field names (derived values computed from the
        shared Parameters). Used by the fused kernels and by ``interop``."""
        raise NotImplementedError

    def __rshift__(self, other: "Bijector") -> "Chain":
        """``f >> g`` applies f first, then g (data-flow order)."""
        return Chain.of(self, other)


class Identity(Bijector):
    """``enflows_tpu/bijectors/base.py:89``."""

    def forward(self, x):
        return x

    def forward_and_ladj(self, x):
        shape = x.shape[:-1] if x.dim() else ()
        return x, torch.zeros(shape, dtype=_ladj_dtype(x), device=x.device)

    def inverse(self):
        return self


class Chain(Bijector):
    """Composition of bijectors, applied ``stages[0]`` first
    (``enflows_tpu/bijectors/base.py:102``)."""

    def __init__(self, stages=()):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    @classmethod
    def of(cls, *stages: Bijector) -> "Chain":
        """Flatten nested chains and drop ``Identity`` stages
        (``enflows_tpu/bijectors/base.py:114-124``)."""
        flat: list[Bijector] = []
        for s in stages:
            if isinstance(s, Chain):
                flat.extend(s.stages)
            elif isinstance(s, Identity):
                continue
            else:
                flat.append(s)
        return cls(flat)

    def forward(self, x):
        for s in self.stages:
            x = s(x)
        return x

    def forward_and_ladj(self, x):
        y, ladj = x, None
        for s in self.stages:
            y, l = s.forward_and_ladj(y)
            ladj = l if ladj is None else ladj + l
        if ladj is None:
            return Identity().forward_and_ladj(x)
        return y, ladj

    def inverse(self):
        """Stages in reverse order, each inverted
        (``enflows_tpu/bijectors/base.py:140-141``)."""
        return Chain([s.inverse() for s in reversed(self.stages)])

    def canonicalize(self):
        for s in self.stages:
            s.canonicalize()
        return self

    def __len__(self):
        return len(self.stages)

    def __getitem__(self, i):
        return self.stages[i]


def compose(*fs: Bijector) -> Chain:
    """Mathematical composition ``compose(f, g)(x) == f(g(x))``: the *last*
    argument is applied first (``enflows_tpu/bijectors/base.py:153-160``)."""
    return Chain.of(*reversed(fs))


def invert(f: Bijector) -> Bijector:
    """``f.inverse()`` (``enflows_tpu/bijectors/base.py:163``)."""
    return f.inverse()


def forward_and_ladj(f: Bijector, x: torch.Tensor):
    """``f.forward_and_ladj(x)`` (``enflows_tpu/bijectors/base.py:168``)."""
    return f.forward_and_ladj(x)
