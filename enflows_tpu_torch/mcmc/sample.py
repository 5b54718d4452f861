"""Running chains: windowed warmup + sampling over a batch of chains.

Counterpart of ``enflows_tpu/mcmc/sample.py``. The JAX warmup and sampling
are one jitted ``lax.scan`` each over a ``vmap``-ed single-chain kernel;
here a kernel transitions all chains at once and warmup and sampling are
Python loops over transitions. The adaptation state and every
per-transition statistic stay in device tensors (draws and statistics in
preallocated buffers), so the loops read nothing back to the host but
what a kernel reads itself: NUTS its stop flags (``nuts.py``), ChEES its
step counts (``chees.py``).

``sample`` runs ``algorithm="nuts"`` (the default), ``"hmc"`` and
``"chees"`` (``chees.chees_sample``). The ``metrics=`` stream raises
``NotImplementedError`` (ROADMAP A.11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .adaptation import (build_schedule, da_init, da_update, welford_init,
                         welford_update_batch, welford_variance)
from .chees import chees_sample
from .hmc import HMCState, hmc_kernel, init_state, initial_positions
from .nuts import nuts_kernel


class WarmupResult(NamedTuple):
    states: HMCState                 # (chains, ...) final warmup states
    step_size: torch.Tensor
    inv_mass_diag: torch.Tensor      # (dim,)


class SampleStats(NamedTuple):
    accept_prob: torch.Tensor    # (steps, chains)
    divergent: torch.Tensor      # (steps, chains)
    num_steps: torch.Tensor      # (steps, chains)
    step_size: torch.Tensor
    inv_mass_diag: torch.Tensor
    energy: torch.Tensor         # (chains, steps) total H at accepted states,
                                 # chains-leading to feed diagnostics.bfmi


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to enflows_tpu_torch "
                               f"yet (ROADMAP {item})")


def window_adaptation(kernel, initial_states: HMCState, generator,
                      num_warmup: int, *, initial_step_size=0.1,
                      target_accept=0.8) -> WarmupResult:
    """Stan-style warmup. ``kernel(generator, states, step_size, inv_mass)``
    transitions all chains of ``initial_states`` at once."""
    q = initial_states.q
    dim, dtype, dev = q.shape[-1], q.dtype, q.device
    in_slow, window_end = build_schedule(num_warmup)
    states = initial_states
    da = da_init(initial_step_size, dtype, dev)
    wf = welford_init(dim, dtype, dev)
    inv_mass = torch.ones(dim, dtype=dtype, device=dev)
    for t in range(num_warmup):
        states, info = kernel(generator, states, torch.exp(da.log_step),
                              inv_mass)
        # Cross-chain consensus before the update: one shared step size.
        da = da_update(da, info.accept_prob.mean(), target=target_accept)
        # Slow windows accumulate position moments over all chains.
        if in_slow[t]:
            wf = welford_update_batch(wf, states.q)
        # Window end: set the mass matrix, restart Welford and dual
        # averaging.
        if window_end[t]:
            inv_mass = welford_variance(wf)
            da = da_init(torch.exp(da.log_step), dtype)
            wf = welford_init(dim, dtype, dev)
    return WarmupResult(states=states, step_size=torch.exp(da.log_step_avg),
                        inv_mass_diag=inv_mass)


def run_chains(kernel, states: HMCState, generator, num_samples: int,
               step_size, inv_mass_diag):
    """Sample ``num_samples`` transitions; returns
    (positions (chains, steps, dim), final states, stats)."""
    n, dim = states.q.shape
    like = dict(device=states.q.device)
    draws = torch.empty(n, num_samples, dim, dtype=states.q.dtype, **like)
    acc = torch.empty(num_samples, n, dtype=states.q.dtype, **like)
    div = torch.empty(num_samples, n, dtype=torch.bool, **like)
    nsteps = torch.empty(num_samples, n, dtype=torch.int64, **like)
    energy = torch.empty(n, num_samples, dtype=states.q.dtype, **like)
    for t in range(num_samples):
        states, info = kernel(generator, states, step_size, inv_mass_diag)
        draws[:, t] = states.q
        acc[t], div[t], nsteps[t] = (info.accept_prob, info.divergent,
                                     info.num_steps)
        energy[:, t] = info.energy
    stats = SampleStats(accept_prob=acc, divergent=div, num_steps=nsteps,
                        step_size=step_size, inv_mass_diag=inv_mass_diag,
                        energy=energy)
    return draws, states, stats


def sample(logdensity_fn: Callable, generator, *, dim: int,
           num_chains: int = 8, num_warmup: int = 500,
           num_samples: int = 1000, algorithm: str = "nuts",
           max_depth: int = 10, num_steps: int = 32, initial_position=None,
           initial_step_size: float = 0.1, target_accept: float = 0.8,
           dtype=torch.float32, metrics=None, device="cuda"):
    """Adaptive MCMC: windowed warmup then sampling.

    Returns (samples (chains, num_samples, dim), final_states, stats).
    ``logdensity_fn``: (n, dim) -> (n,) (``per_sample`` adapts a
    (dim,) -> scalar function). ``generator``: the ``torch.Generator`` of
    every draw, on the device the chains run on: ``device`` (the card unless
    the caller asks for the CPU), or ``initial_position``'s when that is a
    tensor. ``algorithm``: 'nuts' | 'hmc' | 'chees' (adaptive fixed-length
    HMC, ``mcmc.chees``; it uses its own optimal acceptance target 0.651
    and ignores ``target_accept``: call ``chees_sample`` to set it).
    """
    if algorithm not in ("nuts", "hmc", "chees"):
        raise ValueError(f"algorithm must be 'nuts', 'hmc' or 'chees', got "
                         f"{algorithm!r}")
    if metrics is not None:
        raise _unported("metrics=", "A.11")
    if algorithm == "chees":
        return chees_sample(
            logdensity_fn, generator, dim=dim, num_chains=num_chains,
            num_warmup=num_warmup, num_samples=num_samples,
            initial_position=initial_position,
            initial_step_size=initial_step_size, dtype=dtype, device=device)
    q0 = initial_positions(initial_position, generator, num_chains, dim,
                           dtype, device)
    if algorithm == "nuts":
        kernel = nuts_kernel(logdensity_fn, max_depth=max_depth)
    else:
        kernel = hmc_kernel(logdensity_fn, num_steps=num_steps)
    warm = window_adaptation(kernel, init_state(logdensity_fn, q0),
                             generator, num_warmup,
                             initial_step_size=initial_step_size,
                             target_accept=target_accept)
    return run_chains(kernel, warm.states, generator, num_samples,
                      warm.step_size, warm.inv_mass_diag)
