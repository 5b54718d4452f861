"""Carry weights between the JAX package and this one.

``from_jax`` turns a JAX bijector (a ``Chain`` or one stage of the whitening
slice) into this package's modules; ``to_numpy`` gives the reverse view, for
comparing trained parameters. The JAX objects are read by class name and
their leaves converted with ``numpy.asarray``, so this module does not import
``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bijectors.base import Bijector, Chain
from .bijectors.center_stretch import CenterContract, CenterStretch
from .bijectors.householder import Householder
from .bijectors.johnson import Johnson, JohnsonInv
from .bijectors.scale_shift import ScaleShift

_KINDS = {cls.__name__: cls for cls in (ScaleShift, CenterStretch,
                                        CenterContract, Johnson, JohnsonInv)}
_FIELDS = {
    "ScaleShift": ("a", "b"),
    "CenterStretch": ("a", "b", "c"),
    "CenterContract": ("a", "b", "c"),
    "Johnson": ("gamma", "delta", "xi", "lam"),
    "JohnsonInv": ("gamma", "delta", "xi", "lam"),
}


def from_jax(bijector, device=None, dtype=None) -> Bijector:
    """This package's module for a JAX ``Chain`` or single bijector of the
    whitening slice (ScaleShift, CenterStretch, CenterContract, Johnson,
    JohnsonInv, Householder). Each leaf is read as numpy and becomes an
    ``nn.Parameter`` on ``device`` in ``dtype`` (default: the leaf's)."""

    def tensor(leaf):
        t = torch.as_tensor(np.array(leaf))
        return t.to(device=device, dtype=dtype or t.dtype)

    kind = type(bijector).__name__
    if kind == "Chain":
        return Chain([from_jax(s, device, dtype) for s in bijector.stages])
    if kind == "Householder":
        return Householder(tensor(bijector.V), mode=bijector.mode)
    if kind in _KINDS:
        return _KINDS[kind](*(tensor(getattr(bijector, f))
                              for f in _FIELDS[kind]))
    raise ValueError(f"no counterpart for JAX bijector {kind}")


def to_numpy(module: Bijector):
    """A Chain as a list of per-stage dicts, a single stage as a dict, of the
    stage's fields as the JAX dataclass would hold them (derived values of
    inverted stages computed), as float64-preserving numpy arrays."""
    if isinstance(module, Chain):
        return [to_numpy(s) for s in module.stages]
    return {k: v.detach().cpu().numpy() for k, v in module.fields().items()}
