"""Hamiltonian Monte Carlo: leapfrog integrator and Metropolis HMC kernel.

Counterpart of ``enflows_tpu/mcmc/hmc.py``, batch-first: the state holds all
chains, (n, dim) positions and (n,) log densities, and the Metropolis step
accepts or rejects each chain by a mask. The JAX kernel is written for one
chain and ``vmap``-ed.

Conventions: a diagonal mass matrix is carried as ``inv_mass_diag`` (M^-1,
(dim,)). Momentum p ~ N(0, M); kinetic energy 0.5 * p^T M^-1 p; velocity
v = M^-1 p. ``step_size`` and ``inv_mass_diag`` may be device tensors, so a
warmup loop adapts them without reading them back to the host.

Random numbers come from a ``torch.Generator``; ``hmc_transition`` takes its
draws as arguments, so a test can hand it the JAX kernel's own draws. A
sharded sampler passes its kernels a :class:`Rows` in the generator's
place: ``randn`` and ``rand`` then draw the chains axis at the global size
and keep the rank's block, so the rank's chains see the draws the
single-process run gives them.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Rows(NamedTuple):
    """A generator of which a rank keeps rows ``[start, stop)`` of every
    draw's chains axis, drawn at ``total`` rows on every rank."""
    generator: torch.Generator
    start: int
    stop: int
    total: int


def _draw(fn, generator, shape, dtype, device, dim):
    if not isinstance(generator, Rows):
        return fn(tuple(shape), generator=generator, dtype=dtype,
                  device=device)
    full = list(shape)
    full[dim] = generator.total
    return fn(tuple(full), generator=generator.generator, dtype=dtype,
              device=device).narrow(dim, generator.start,
                                    generator.stop - generator.start)


def randn(generator, shape, dtype, device=None, dim: int = 0):
    """Standard normals of ``shape`` from ``generator`` (a
    ``torch.Generator``, or :class:`Rows`: the chains axis ``dim`` drawn at
    the global size, the rank's block kept)."""
    return _draw(torch.randn, generator, shape, dtype, device, dim)


def rand(generator, shape, dtype, device=None, dim: int = 0):
    """Uniforms on [0, 1), drawn as ``randn`` draws."""
    return _draw(torch.rand, generator, shape, dtype, device, dim)


class HMCState(NamedTuple):
    q: torch.Tensor          # positions (n, dim)
    logp: torch.Tensor       # target log-density at q, (n,)
    grad: torch.Tensor       # d logp / dq, (n, dim)


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    divergent: torch.Tensor
    energy: torch.Tensor
    num_steps: torch.Tensor


def value_and_grad(logdensity_fn: Callable, q: torch.Tensor):
    """(logp (n,), grad (n, dim)) of a batched log-density, by autograd of
    the batch's sum (chains are independent)."""
    with torch.enable_grad():
        x = q.detach().requires_grad_(True)
        logp = logdensity_fn(x)
        grad, = torch.autograd.grad(logp.sum(), x)
    return logp.detach(), grad


# Densities captured by ``graphed_value_and_grad``, their replays, and the
# densities it ran eagerly because they synchronize with the host.
GRAPHS = {"captured": 0, "replays": 0, "eager": 0}


def graphed_value_and_grad(logdensity_fn: Callable) -> Callable:
    """``value_and_grad`` of ``logdensity_fn`` for a sampler's leaves: on a
    CUDA tensor, the density and its backward are captured once per batch
    shape and dtype as a CUDA graph and replayed, one launch where eager
    autograd launches every op of both from Python (a 2-D flow density is
    a few hundred). On a CPU tensor it is ``value_and_grad``.

    A density that synchronizes with the host (reads a tensor's value,
    copies from host memory) cannot be captured: its warm-up, run with
    CUDA's synchronization check set to raise, finds that, and it runs
    eagerly (``GRAPHS["eager"]``). A captured density must not change
    between calls: its tensors are read in place, and a Python number it
    closes over keeps its value at capture. The samplers build one per
    kernel, around a density fixed for the run."""
    graphs = {}

    def capture(q):
        static_q = q.detach().clone()
        device = q.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        mode = torch.cuda.get_sync_debug_mode()
        try:
            torch.cuda.set_sync_debug_mode("error")
            # Warm up on a side stream (autograd's buffers, lazy inits).
            with torch.cuda.stream(side):
                for _ in range(2):
                    value_and_grad(logdensity_fn, static_q)
        except RuntimeError:
            GRAPHS["eager"] += 1
            return None
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = value_and_grad(logdensity_fn, static_q)
        GRAPHS["captured"] += 1
        return graph, static_q, out

    def fn(q):
        if q.device.type != "cuda":
            return value_and_grad(logdensity_fn, q)
        key = (tuple(q.shape), q.dtype, q.device)
        if key not in graphs:
            graphs[key] = capture(q)
        if graphs[key] is None:
            return value_and_grad(logdensity_fn, q)
        graph, static_q, (logp, grad) = graphs[key]
        static_q.copy_(q)
        graph.replay()
        GRAPHS["replays"] += 1
        # The graph's outputs are overwritten by its next replay.
        return logp.clone(), grad.clone()

    return fn


def init_state(logdensity_fn: Callable, q: torch.Tensor) -> HMCState:
    logp, grad = value_and_grad(logdensity_fn, q)
    return HMCState(q=q, logp=logp, grad=grad)


def sample_momentum(generator, inv_mass_diag, shape, dtype, device=None):
    """p ~ N(0, M) with M = diag(1/inv_mass_diag)."""
    eps = randn(generator, shape, dtype, device)
    return eps * torch.rsqrt(inv_mass_diag)


def kinetic_energy(p, inv_mass_diag):
    return 0.5 * (p * p * inv_mass_diag).sum(-1)


def leapfrog(value_grad_fn: Callable, q, p, grad, step_size, inv_mass_diag,
             num_steps: int):
    """``num_steps`` leapfrog steps; returns (q, p, logp, grad).

    Velocity-Verlet with one gradient evaluation per step, positions updated
    with the mass-scaled momentum (v = M^-1 p). ``value_grad_fn``:
    q -> (logp, grad)."""
    logp = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for _ in range(num_steps):
        p = p + 0.5 * step_size * grad
        q = q + step_size * p * inv_mass_diag
        logp, grad = value_grad_fn(q)
        p = p + 0.5 * step_size * grad
    return q, p, logp, grad


def metropolis_proposal(value_grad_fn: Callable, state: HMCState, step_size,
                        inv_mass_diag, num_steps: int, p, u,
                        divergence_threshold: float = 1000.0):
    """``num_steps`` leapfrog steps of all chains from momenta ``p`` and the
    Metropolis step with uniforms ``u`` (n,); a NaN energy change rejects.
    Returns (state, accept_prob, accepted, divergent, energy, q_prop,
    p_prop), ``energy`` the H of the accepted state (on rejection: the
    initial point with its fresh momentum), the energy marginal that BFMI
    is defined over."""
    energy0 = -state.logp + kinetic_energy(p, inv_mass_diag)
    q_new, p_new, logp_new, grad_new = leapfrog(
        value_grad_fn, state.q, p, state.grad, step_size, inv_mass_diag,
        num_steps)
    energy1 = -logp_new + kinetic_energy(p_new, inv_mass_diag)
    delta = energy0 - energy1
    delta = delta.masked_fill(torch.isnan(delta), -math.inf)
    divergent = -delta > divergence_threshold
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accepted = u < accept_prob
    new_state = HMCState(
        q=torch.where(accepted[:, None], q_new, state.q),
        logp=torch.where(accepted, logp_new, state.logp),
        grad=torch.where(accepted[:, None], grad_new, state.grad))
    return (new_state, accept_prob, accepted, divergent,
            torch.where(accepted, energy1, energy0), q_new, p_new)


def hmc_transition(value_grad_fn: Callable, state: HMCState, step_size,
                   inv_mass_diag, num_steps: int, p, u,
                   divergence_threshold: float = 1000.0):
    """One HMC transition of all chains given its draws: the momenta p
    (n, dim) (``sample_momentum``) and the acceptance uniforms ``u`` (n,).
    A NaN energy change rejects. Returns (state, info)."""
    new_state, accept_prob, accepted, divergent, energy, _, _ = \
        metropolis_proposal(value_grad_fn, state, step_size, inv_mass_diag,
                            num_steps, p, u, divergence_threshold)
    info = HMCInfo(accept_prob=accept_prob, accepted=accepted,
                   divergent=divergent, energy=energy,
                   num_steps=torch.full_like(accept_prob, num_steps,
                                             dtype=torch.int64))
    return new_state, info


def initial_positions(initial_position, generator, num_chains: int,
                      dim: int, dtype, device):
    """Where the chains start: ``initial_position`` in ``dtype`` (a tensor
    keeps its device, anything else lands on ``device``), or 0.1 N(0, I)
    draws from ``generator`` on ``device``."""
    if isinstance(initial_position, torch.Tensor):
        return initial_position.to(dtype)
    if initial_position is None:
        return 0.1 * randn(generator, (num_chains, dim), dtype, device)
    return torch.as_tensor(initial_position, dtype=dtype, device=device)


def hmc_kernel(logdensity_fn: Callable, num_steps: int = 32,
               divergence_threshold: float = 1000.0):
    """Build a one-transition HMC kernel over all chains:
    (generator, state, step_size, inv_mass_diag) -> (state, info).
    ``logdensity_fn``: (n, dim) -> (n,)."""
    value_grad_fn = graphed_value_and_grad(logdensity_fn)

    def kernel(generator, state: HMCState, step_size, inv_mass_diag):
        q = state.q
        p = sample_momentum(generator, inv_mass_diag, q.shape, q.dtype,
                            q.device)
        u = rand(generator, (q.shape[0],), q.dtype, q.device)
        return hmc_transition(value_grad_fn, state, step_size, inv_mass_diag,
                              num_steps, p, u, divergence_threshold)

    return kernel
