"""Log-density API and flow-preconditioned targets.

Counterpart of ``enflows_tpu/mcmc/logdensity.py``, batch-first: a target
log-density is a function ``(n, dim) -> (n,)`` of a batch of chains (the JAX
samplers ``vmap`` a per-sample ``(dim,) -> scalar`` instead). ``per_sample``
turns a per-sample function into the batched form. Gradients come from
autograd of the batch's sum (``hmc.value_and_grad``).

Flow preconditioning: if ``f`` maps whitened space -> data space, MCMC runs in
whitened coordinates xi with

    logp_white(xi) = logp(f(xi)) + ladj(f, xi)

and samples map back through ``f``.

``FlowPushforwardTarget.batched_value_and_grad`` (a ``custom_vmap`` shim for
the JAX tree samplers) is not ported: a batch-first sampler calls the batched
density directly.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..bijectors.base import Bijector, invert
from ..ops.leapfrog import is_fusible_leapfrog


class PreconditionedTarget(NamedTuple):
    """Whitened-space log-density plus the map back to data space."""
    logdensity_fn: Callable      # (n, dim) -> (n,), whitened coordinates
    push_forward: Callable       # (..., dim) whitened -> (..., dim) data


def per_sample(fn: Callable) -> Callable:
    """The batched form ``(n, dim) -> (n,)`` of a per-sample log-density
    ``(dim,) -> scalar``, by ``torch.func.vmap``."""
    return torch.func.vmap(fn)


def flow_preconditioned(logdensity_fn: Callable, flow: Bijector
                        ) -> PreconditionedTarget:
    """Precondition ``logdensity_fn`` ((n, dim) -> (n,)) with ``flow``
    (whitened -> data): the inverse of a trained whitening transform, or a
    transport learned by VI."""

    def logdensity_white(xi):
        z, ladj = flow.forward_and_ladj(xi)
        return logdensity_fn(z) + ladj

    return PreconditionedTarget(logdensity_fn=logdensity_white,
                                push_forward=flow.forward)


class FlowPushforwardTarget:
    """A target declared exactly as a flow pushforward: X = T(Z) with
    Z ~ N(base_mean, diag(base_var)) and ``transport`` T base -> data.

    Callable like any batched log-density ((n, dim) -> (n,)):

        logp(x) = diag_normal_logpdf(T^{-1}(x)) + ladj_{T^{-1}}(x)

    Declaring the structure lets ``infer`` route HMC on such targets to the
    fused leapfrog kernel B6 (``ops.leapfrog``), whose trajectories run through
    the whitening chain ``T^{-1}`` on chip. ``base_mean``/``base_var``:
    None (0 / 1), a scalar or a (dim,) tensor.
    """

    def __init__(self, transport: Bijector, base_mean=None, base_var=None):
        self.transport = transport
        self.whiten = invert(transport)
        self.base_mean = base_mean
        self.base_var = base_var

    def fused_kernel_available(self, dim: int, dtype=torch.float32) -> bool:
        return is_fusible_leapfrog(self.whiten, dim, dtype)

    def __call__(self, x):
        z, ladj = self.whiten.forward_and_ladj(x)
        like = dict(dtype=z.dtype, device=z.device)
        mu = torch.as_tensor(0.0 if self.base_mean is None
                             else self.base_mean, **like)
        var = torch.as_tensor(1.0 if self.base_var is None
                              else self.base_var, **like)
        d = z - mu
        lp = -0.5 * (d * d / var + torch.log(2 * math.pi * var)
                     * torch.ones_like(z)).sum(-1)
        return lp + ladj
