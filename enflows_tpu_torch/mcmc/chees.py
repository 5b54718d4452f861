"""ChEES-HMC: adaptive fixed-length HMC whose chains share one trajectory.

Counterpart of ``enflows_tpu/mcmc/chees.py`` (Hoffman, Radul & Sountsov,
AISTATS 2021): every chain runs the same jittered number of leapfrog steps
per iteration, and the expected trajectory length h is tuned by Adam ascent
on the ChEES criterion 1/4 E[(||q' - E q'||^2 - ||q - E q||^2)^2], whose
gradient per chain is c <q' - E q', v'> (c the bracket, v' = M^-1 p' the
endpoint velocity); the expectations are means over the chains. The step
size follows dual averaging on the mean acceptance toward 0.651, the
diagonal inverse mass Stan's doubling slow windows (``adaptation``), with
dual averaging restarted at each window end. The jitter is the base-2 van
der Corput sequence, shared by all chains.

Where the JAX warmup and sampling are one ``lax.scan`` each over a ``vmap``-ed
single-chain kernel, here a kernel transitions all chains at once and the
phases are Python loops. The trajectory's step count is a device scalar
that the host reads once per warmup iteration, as the loop count of
``hmc.leapfrog``; the sampling phase reads all of its counts at once (the
settings are fixed by then). The value-and-grad route that JAX switches off
(``CHEES_VG_MIN_ELEMENTS``) is not ported; ``value_and_grad_fn=`` takes a
batched q -> (logp, grad) in its place.

Random numbers come from a ``torch.Generator``: per transition the unit
normals of the momentum, then the acceptance uniforms (``_draws``);
``hmc_proposal_transition`` takes its draws as arguments.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .adaptation import (build_schedule, da_init, da_update, welford_init,
                         welford_update_batch, welford_variance)
from ..utils.profiling import annotate
from .hmc import (HMCState, init_state, initial_positions,
                  metropolis_proposal, rand, randn, value_and_grad)

OPTIMAL_ACCEPT = 0.651   # optimal acceptance rate for fixed-length HMC


class ChEESInfo(NamedTuple):
    accept_prob: torch.Tensor    # per chain
    accepted: torch.Tensor
    divergent: torch.Tensor
    energy: torch.Tensor
    q_prop: torch.Tensor         # proposal endpoint (accept or not)
    v_prop: torch.Tensor         # endpoint velocity M^-1 p'
    num_steps: int               # shared by all chains (leapfrog steps)


class ChEESAdaptState(NamedTuple):
    """Adam state on log max-trajectory-length."""
    log_h: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


class ChEESWarmupResult(NamedTuple):
    states: HMCState
    step_size: torch.Tensor
    trajectory_length: torch.Tensor   # adapted max trajectory length h
    inv_mass_diag: torch.Tensor


class ChEESSampleStats(NamedTuple):
    accept_prob: torch.Tensor    # (steps, chains)
    divergent: torch.Tensor      # (steps, chains)
    num_steps: torch.Tensor      # (steps,) shared trajectory per iteration
    step_size: torch.Tensor
    trajectory_length: torch.Tensor
    inv_mass_diag: torch.Tensor
    energy: torch.Tensor         # (chains, steps) total H at accepted
                                 # states, chains-leading for bfmi


def halton_base2(n: int, offset: int = 0) -> np.ndarray:
    """First ``n`` van der Corput base-2 points (bit-reversed t+1 in (0,1)),
    in numpy on the host."""
    t = np.arange(offset + 1, offset + n + 1, dtype=np.uint64)
    u = np.zeros(n, np.float64)
    f = 0.5
    while t.any():
        u += f * (t & 1)
        t >>= 1
        f *= 0.5
    return u


def hmc_proposal_transition(value_grad_fn: Callable, state: HMCState,
                            step_size, inv_mass_diag, num_steps: int, p, u,
                            divergence_threshold: float = 1000.0):
    """One fixed-length HMC transition of all chains given its draws (the
    momenta p (n, dim) and the acceptance uniforms ``u`` (n,)) that also
    exposes the proposal (``chees.py:122-150``). Returns (state, info)."""
    new_state, accept_prob, accepted, divergent, energy, q_new, p_new = \
        metropolis_proposal(value_grad_fn, state, step_size, inv_mass_diag,
                            num_steps, p, u, divergence_threshold)
    info = ChEESInfo(accept_prob=accept_prob, accepted=accepted,
                     divergent=divergent, energy=energy, q_prop=q_new,
                     v_prop=p_new * inv_mass_diag, num_steps=num_steps)
    return new_state, info


def _draws(generator, q):
    """A transition's draws: the momentum's unit normals (n, dim), then the
    acceptance uniforms (n,)."""
    noise = randn(generator, q.shape, q.dtype, q.device)
    u = rand(generator, (q.shape[0],), q.dtype, q.device)
    return noise, u


def hmc_proposal_kernel(logdensity_fn: Callable,
                        divergence_threshold: float = 1000.0,
                        value_and_grad_fn: Callable | None = None):
    """``kernel(generator, state, step_size, inv_mass_diag, num_steps)``:
    one fixed-length HMC transition of all chains, ``num_steps`` (an int)
    shared by them. ``logdensity_fn``: (n, dim) -> (n,);
    ``value_and_grad_fn``: a batched q -> (logp, grad) that overrides
    autograd of it."""
    value_grad_fn = value_and_grad_fn or (
        lambda q: value_and_grad(logdensity_fn, q))

    def kernel(generator, state: HMCState, step_size, inv_mass_diag,
               num_steps: int):
        noise, u = _draws(generator, state.q)
        return hmc_proposal_transition(
            value_grad_fn, state, step_size, inv_mass_diag, num_steps,
            noise * torch.rsqrt(inv_mass_diag), u, divergence_threshold)

    return kernel


def _num_leapfrog_steps(traj_len, step_size, max_num_steps):
    n = torch.ceil(traj_len / step_size).to(torch.int32)
    return torch.clamp(n, 1, max_num_steps)


def _chees_grad(q0, info: ChEESInfo, traj_len, axis=None):
    """Ascent direction for log h; every mean is over the chains (over all
    ranks' chains when ``axis``, a ``parallel`` mesh axis, is given)."""
    dq0 = q0 - _chain_mean(q0, axis)
    dq1 = info.q_prop - _chain_mean(info.q_prop, axis)
    c = (dq1 * dq1).sum(-1) - (dq0 * dq0).sum(-1)
    dtau = c * (dq1 * info.v_prop).sum(-1)       # d/dtau of c^2/4
    w = info.accept_prob
    sums = torch.stack([(w * dtau).sum(), w.sum()])
    if axis is not None:
        from ..parallel.collectives import psum
        sums = psum(sums, axis)
    g_tau = sums[0] / torch.clamp(sums[1], min=1e-6)
    # chain rule: tau = u * h  =>  d/dlog h = tau * d/dtau
    return g_tau * traj_len


def _chain_mean(x, axis=None):
    """The mean over the chains axis 0, over every rank's chains when
    ``axis`` is given (equal blocks: the mean of the ranks' means)."""
    m = x.mean(0)
    if axis is None:
        return m
    from ..parallel.collectives import pmean
    return pmean(m, axis)


def _adam_ascent(adapt: ChEESAdaptState, grad, lr=0.025, b1=0.9, b2=0.999,
                 eps=1e-8):
    t = adapt.t + 1.0
    m = b1 * adapt.m + (1.0 - b1) * grad
    v = b2 * adapt.v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    log_h = adapt.log_h + lr * m_hat / (torch.sqrt(v_hat) + eps)
    return ChEESAdaptState(log_h=log_h, m=m, v=v, t=t)


def chees_warmup(logdensity_fn: Callable, initial_states: HMCState,
                 generator, num_warmup: int, *, initial_step_size=0.1,
                 target_accept=OPTIMAL_ACCEPT, max_num_steps: int = 512,
                 adam_lr: float = 0.025,
                 value_and_grad_fn: Callable | None = None, axis=None
                 ) -> ChEESWarmupResult:
    """Joint step size, trajectory length and mass matrix adaptation
    (``chees.py:183-256``). Every per-iteration scalar (jitter, step size,
    step count, log h) is shared by the chains and stays on the device but
    the step count, read once per iteration. ``axis`` (a ``parallel`` mesh
    axis): the chains are this rank's block, and the acceptance mean, the
    ChEES gradient and the Welford moments are taken over every rank's
    chains, so every rank holds the same settings."""
    q = initial_states.q
    dim, dtype, dev = q.shape[-1], q.dtype, q.device
    in_slow, window_end = build_schedule(num_warmup)
    jitter = torch.as_tensor(halton_base2(num_warmup), dtype=dtype,
                             device=dev)
    kernel = hmc_proposal_kernel(logdensity_fn,
                                 value_and_grad_fn=value_and_grad_fn)
    max_log_h = math.log(max_num_steps)
    states = initial_states
    da = da_init(initial_step_size, dtype, dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    adapt = ChEESAdaptState(log_h=torch.log(torch.as_tensor(
        initial_step_size, dtype=dtype, device=dev)), m=zero, v=zero, t=zero)
    wf = welford_init(dim, dtype, dev)
    inv_mass = torch.ones(dim, dtype=dtype, device=dev)
    with annotate("enflows.mcmc.chees_warmup"):
        for t in range(num_warmup):
            step_size = torch.exp(da.log_step)
            traj = jitter[t] * torch.exp(adapt.log_h)
            num_steps = int(_num_leapfrog_steps(traj, step_size,
                                                max_num_steps))
            q0 = states.q
            states, info = kernel(generator, states, step_size, inv_mass,
                                  num_steps)
            da = da_update(da, _chain_mean(info.accept_prob, axis),
                           target=target_accept)
            adapt = _adam_ascent(adapt, _chees_grad(q0, info, traj, axis),
                                 lr=adam_lr)
            # Keep h within [step, max_num_steps * step] so the step count
            # stays sane.
            adapt = adapt._replace(log_h=torch.clamp(
                adapt.log_h, da.log_step, max_log_h + da.log_step))
            if in_slow[t]:
                wf = welford_update_batch(wf, states.q, axis=axis)
            if window_end[t]:
                inv_mass = welford_variance(wf)
                da = da_init(torch.exp(da.log_step), dtype)
                wf = welford_init(dim, dtype, dev)
    return ChEESWarmupResult(states=states,
                             step_size=torch.exp(da.log_step_avg),
                             trajectory_length=torch.exp(adapt.log_h),
                             inv_mass_diag=inv_mass)


def run_chains_chees(logdensity_fn: Callable, states: HMCState, generator,
                     num_samples: int, step_size, trajectory_length,
                     inv_mass_diag, max_num_steps: int = 512,
                     value_and_grad_fn: Callable | None = None):
    """Sampling phase: jittered fixed-length HMC at the adapted settings,
    the jitter continuing the van der Corput sequence (constant lengths
    resonate on near-Gaussian targets). Returns (positions (chains, steps,
    dim), final states, stats)."""
    n, dim = states.q.shape
    dtype, dev = states.q.dtype, states.q.device
    jitter = torch.as_tensor(halton_base2(num_samples, offset=1 << 20),
                             dtype=dtype, device=dev)
    kernel = hmc_proposal_kernel(logdensity_fn,
                                 value_and_grad_fn=value_and_grad_fn)
    nsteps = _num_leapfrog_steps(jitter * trajectory_length, step_size,
                                 max_num_steps)
    draws = torch.empty(n, num_samples, dim, dtype=dtype, device=dev)
    acc = torch.empty(num_samples, n, dtype=dtype, device=dev)
    div = torch.empty(num_samples, n, dtype=torch.bool, device=dev)
    energy = torch.empty(n, num_samples, dtype=dtype, device=dev)
    with annotate("enflows.mcmc.chees_sampling"):
        for t, num_steps in enumerate(nsteps.tolist()):
            states, info = kernel(generator, states, step_size,
                                  inv_mass_diag, num_steps)
            draws[:, t] = states.q
            acc[t], div[t] = info.accept_prob, info.divergent
            energy[:, t] = info.energy
    stats = ChEESSampleStats(accept_prob=acc, divergent=div,
                             num_steps=nsteps, step_size=step_size,
                             trajectory_length=trajectory_length,
                             inv_mass_diag=inv_mass_diag, energy=energy)
    return draws, states, stats


def chees_sample(logdensity_fn: Callable, generator, *, dim: int,
                 num_chains: int = 64, num_warmup: int = 500,
                 num_samples: int = 1000, max_num_steps: int = 512,
                 initial_position=None, initial_step_size: float = 0.1,
                 target_accept: float = OPTIMAL_ACCEPT,
                 dtype=torch.float32, device="cuda", axis=None):
    """ChEES-HMC: adaptive warmup then jittered fixed-length sampling.

    Same return contract as ``mcmc.sample``: (samples (chains, steps,
    dim), final states, stats). ``logdensity_fn``: (n, dim) -> (n,).
    ``generator``: the ``torch.Generator`` of every draw, on the device the
    chains run on: ``device`` (the card unless the caller asks for the
    CPU), or ``initial_position``'s when that is a tensor. Meant for many
    chains: the ChEES expectation is a mean over them (16 or more).
    ``axis``: see ``chees_warmup`` (``parallel.sample_sharded`` passes it,
    with a ``hmc.Rows`` generator and this rank's initial positions).
    """
    q0 = initial_positions(initial_position, generator, num_chains, dim,
                           dtype, device)
    warm = chees_warmup(logdensity_fn, init_state(logdensity_fn, q0),
                        generator, num_warmup,
                        initial_step_size=initial_step_size,
                        target_accept=target_accept,
                        max_num_steps=max_num_steps, axis=axis)
    return run_chains_chees(logdensity_fn, warm.states, generator,
                            num_samples, warm.step_size,
                            warm.trajectory_length, warm.inv_mass_diag,
                            max_num_steps=max_num_steps)
