"""Carry weights between the JAX package and this one.

``from_jax`` turns a JAX bijector (a ``Chain`` or one stage) into this
package's modules; ``to_numpy`` gives the reverse view, for comparing
trained parameters. The JAX objects are read by class name and their leaves
converted with ``numpy.asarray``, so this module does not import ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .bijectors.base import Bijector, Chain
from .bijectors.center_stretch import CenterContract, CenterStretch
from .bijectors.coupling import AffineCoupling, MLPConditioner, Permute
from .bijectors.householder import Householder
from .bijectors.johnson import Johnson, JohnsonInv
from .bijectors.scale_shift import ScaleShift
from .bijectors.spline import ElementwiseRQSpline, RQSplineCoupling
from .mcmc.logdensity import FlowPushforwardTarget

_KINDS = {cls.__name__: cls for cls in (ScaleShift, CenterStretch,
                                        CenterContract, Johnson, JohnsonInv,
                                        ElementwiseRQSpline)}
_FIELDS = {
    "ScaleShift": ("a", "b"),
    "CenterStretch": ("a", "b", "c"),
    "CenterContract": ("a", "b", "c"),
    "Johnson": ("gamma", "delta", "xi", "lam"),
    "JohnsonInv": ("gamma", "delta", "xi", "lam"),
    "ElementwiseRQSpline": ("w_raw", "h_raw", "d_raw"),
}


def from_jax(bijector, device="cuda", dtype=None):
    """This package's module for a JAX ``Chain`` or single bijector:
    ScaleShift, CenterStretch, CenterContract, Johnson, JohnsonInv,
    Householder, AffineCoupling, RQSplineCoupling, Permute,
    ElementwiseRQSpline, or an ``MLPConditioner``; or for a JAX
    ``mcmc.FlowPushforwardTarget`` (its transport converted, its base mean
    and variance as tensors). Each leaf is read as numpy and becomes an
    ``nn.Parameter`` on ``device`` (the card unless the caller asks for the
    CPU) in ``dtype`` (default: the leaf's; a bf16 leaf, which numpy holds
    as ml_dtypes' bfloat16, becomes torch.bfloat16)."""

    def tensor(leaf):
        a = np.array(leaf)
        if a.dtype.name == "bfloat16":
            t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.as_tensor(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    kind = type(bijector).__name__
    if kind == "FlowPushforwardTarget":
        return FlowPushforwardTarget(
            from_jax(bijector.transport, device, dtype),
            *(None if v is None else tensor(v)
              for v in (bijector.base_mean, bijector.base_var)))
    if kind == "Chain":
        return Chain([from_jax(s, device, dtype) for s in bijector.stages])
    if kind == "Householder":
        return Householder(tensor(bijector.V), mode=bijector.mode)
    if kind == "MLPConditioner":
        return MLPConditioner([(tensor(W), tensor(b))
                               for W, b in bijector.layers],
                              activation=bijector.activation,
                              compute_dtype=bijector.compute_dtype)
    if kind == "AffineCoupling":
        return AffineCoupling(from_jax(bijector.conditioner, device, dtype),
                              bijector.split, inverted=bijector.inverted,
                              max_log_scale=bijector.max_log_scale)
    if kind == "RQSplineCoupling":
        return RQSplineCoupling(from_jax(bijector.conditioner, device, dtype),
                                bijector.split, n_bins=bijector.n_bins,
                                inverted=bijector.inverted,
                                bound=bijector.bound)
    if kind == "Permute":
        return Permute(bijector.perm)
    if kind == "ElementwiseRQSpline":
        return ElementwiseRQSpline(*(tensor(getattr(bijector, f))
                                     for f in _FIELDS[kind]),
                                   inverted=bijector.inverted,
                                   bound=bijector.bound)
    if kind in _KINDS:
        return _KINDS[kind](*(tensor(getattr(bijector, f))
                              for f in _FIELDS[kind]))
    raise ValueError(f"no counterpart for JAX bijector {kind}")


def to_numpy(module: Bijector):
    """A Chain as a list of per-stage dicts, a single stage as a dict, of the
    stage's fields as the JAX dataclass would hold them (derived values of
    inverted stages computed), as float64-preserving numpy arrays. A
    coupling gives ``{"layers": [(W, b), ...]}``, a Permute
    ``{"perm": perm}``."""
    if isinstance(module, Chain):
        return [to_numpy(s) for s in module.stages]
    if isinstance(module, (AffineCoupling, RQSplineCoupling)):
        return {"layers": [(d.W.detach().cpu().numpy(),
                            d.b.detach().cpu().numpy())
                           for d in module.conditioner.layers]}
    if isinstance(module, Permute):
        return {"perm": module.perm}
    return {k: v.detach().cpu().numpy() for k, v in module.fields().items()}
