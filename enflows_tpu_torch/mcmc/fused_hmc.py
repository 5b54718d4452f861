"""HMC on fusible-chain targets through the fused leapfrog kernel B6.

Counterpart of ``enflows_tpu/mcmc/fused_hmc.py``. Samples the density
``N(f(q); base_mean, diag(base_var)) + ladj_f(q)`` of a fusible ``chain`` f
(the pullback of a diagonal-Gaussian base through f). Each transition runs
its whole trajectory in one launch of B6 (``ops.leapfrog``), which keeps the
chains' state on chip across the L steps.

This samples exactly the targets expressible as a fusible chain over such a
base: a target declared as ``FlowPushforwardTarget`` (which ``infer`` routes
here with ``method='hmc'``) or ``chain = invert(truth_flow)``. It is not a
sampler for arbitrary log densities; use ``mcmc.sample`` / ``infer`` for
those. Draws live in the domain of ``chain``: data space for a pushforward
target, whitened space for a whitening chain fit to data.

``fused_flow_hmc_sample``: dual-averaging step-size warmup
(``adaptation.da_update``) toward a target acceptance, then fixed-step
sampling with step-size jitter; identity mass. The step size, the
dual-averaging state and the draws stay on the device: the loops read
nothing back to the host, and B6 reads the step size from device memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.leapfrog import flow_hmc_transition, fused_leapfrog
from .adaptation import da_init, da_update


class FusedHMCStats(NamedTuple):
    accept_prob: torch.Tensor   # (steps, chains)
    step_size: torch.Tensor
    num_steps: int


def _sample(leapfrog, chain, generator, q0, base_mean, base_var, *,
            num_warmup, num_samples, num_steps, jitter_steps,
            initial_step_size, target_accept):
    """The sampler over a given ``leapfrog`` (``fused_leapfrog``, or
    ``leapfrog_plain`` to hold the kernel against its plain version).
    ``fused_hmc.py:55-106``."""
    n, dim = q0.shape
    like = dict(dtype=q0.dtype, device=q0.device)

    def transition(q, eps):
        if jitter_steps:
            # Step-size jitter (uniform [2/3, 1] x eps): breaks periodic
            # resonances of the fixed trajectory length.
            u = torch.rand((), generator=generator, **like)
            eps = eps * (2.0 / 3.0 + u / 3.0)
        noise = torch.randn(n, dim, generator=generator, **like)
        u_acc = torch.rand(n, generator=generator, **like)
        q, _, acc, _ = flow_hmc_transition(
            leapfrog, chain, q, noise, u_acc, eps, num_steps,
            base_mean=base_mean, base_var=base_var)
        return q, acc

    da = da_init(initial_step_size, **like)
    q = q0
    for _ in range(num_warmup):
        q, acc = transition(q, torch.exp(da.log_step))
        da = da_update(da, acc.mean(), target=target_accept)
    eps = torch.exp(da.log_step_avg)
    draws = torch.empty(n, num_samples, dim, **like)
    accs = torch.empty(num_samples, n, **like)
    for t in range(num_samples):
        q, accs[t] = transition(q, eps)
        draws[:, t] = q
    return draws, q, FusedHMCStats(accept_prob=accs, step_size=eps,
                                   num_steps=num_steps)


def fused_flow_hmc_sample(chain, generator, *, dim: int,
                          num_chains: int = 128, num_warmup: int = 200,
                          num_samples: int = 1000, num_steps: int = 16,
                          jitter_steps: bool = True,
                          initial_step_size: float = 0.2,
                          target_accept: float = 0.8,
                          initial_position=None,
                          base_mean=None, base_var=None,
                          dtype=torch.float32, device="cuda"):
    """Sample the flow-preconditioned target with kernel B6.

    ``chain``: a fusible bijector (whitened -> base). ``generator``: the
    ``torch.Generator`` of every draw, on the device the chains run on:
    ``device`` (the card unless the caller asks for the CPU), or
    ``initial_position``'s when that is a tensor; a CPU run takes the plain
    version of B6. ``base_mean``/``base_var`` (scalar or (dim,), default
    N(0, I)) select the diagonal-Gaussian base.

    Returns (draws (chains, steps, dim), final_q, stats). Draws are in the
    domain of ``chain`` (see the module docstring).
    """
    if isinstance(initial_position, torch.Tensor):
        device = initial_position.device
    like = dict(dtype=dtype, device=device)
    if initial_position is None:
        q0 = 0.1 * torch.randn(num_chains, dim, generator=generator, **like)
    else:
        q0 = torch.as_tensor(initial_position, **like)
    # The base stays at least float32 with bf16 chains, as JAX hands its
    # base to the kernel in float32 (leapfrog.py:268-277).
    base_like = dict(like, dtype=torch.promote_types(dtype, torch.float32))
    base = [None if v is None else torch.as_tensor(v, **base_like)
            for v in (base_mean, base_var)]
    return _sample(fused_leapfrog, chain, generator, q0.contiguous(), *base,
                   num_warmup=num_warmup, num_samples=num_samples,
                   num_steps=num_steps, jitter_steps=jitter_steps,
                   initial_step_size=initial_step_size,
                   target_accept=target_accept)
