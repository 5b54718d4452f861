"""Stan-style windowed warmup: dual-averaging step size + Welford mass matrix.

Counterpart of ``enflows_tpu/mcmc/adaptation.py``. Stan's three-phase schedule
(fast initial buffer, doubling slow windows accumulating a diagonal mass
matrix, fast terminal buffer) is computed on the host as numpy flags; the
adaptation state lives in device tensors (0-d and (dim,)), so a sampler's
warmup loop reads nothing back to the host.

All chains share one step size and one mass matrix: the dual-averaging
statistic and the Welford moments are averaged over the chains axis before
the update. The JAX version's ``axis_name`` (explicit collectives under
``shard_map``) is ``axis=``, a ``parallel`` mesh axis: the chains are the
rank's block and the averages are all-reduced.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# -------------------------------------------------------------------------
# Dual averaging (Nesterov primal-dual; Stan defaults).

class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(initial_step_size, dtype=torch.float32,
            device=None) -> DualAveragingState:
    """``initial_step_size``: a float or a 0-d tensor. The state lies on
    ``device``; without one, on the tensor's device, and for a float on the
    card."""
    if device is None and not isinstance(initial_step_size, torch.Tensor):
        device = "cuda"
    s = torch.as_tensor(initial_step_size, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=s.device)
    return DualAveragingState(log_step=torch.log(s),
                              log_step_avg=torch.log(s), h_bar=zero, t=zero,
                              mu=torch.log(10.0 * s))


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * h_bar
    eta_x = t ** (-kappa)
    log_step_avg = eta_x * log_step + (1.0 - eta_x) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, t, state.mu)


# -------------------------------------------------------------------------
# Welford running moments (over chains and steps) for the mass matrix.

class WelfordState(NamedTuple):
    mean: torch.Tensor     # (dim,)
    m2: torch.Tensor       # (dim,)
    count: torch.Tensor    # scalar


def welford_init(dim, dtype=torch.float32, device="cuda") -> WelfordState:
    """Empty running moments of ``dim`` coordinates on ``device`` (the card
    unless the caller asks for the CPU)."""
    return WelfordState(mean=torch.zeros(dim, dtype=dtype, device=device),
                        m2=torch.zeros(dim, dtype=dtype, device=device),
                        count=torch.zeros((), dtype=dtype, device=device))


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Add one observation x (dim,)."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_update_batch(state: WelfordState, X: torch.Tensor,
                         axis=None) -> WelfordState:
    """Add a batch of observations X (chains, dim) via Chan's parallel
    merge. ``axis`` (a ``parallel`` mesh axis, ``adaptation.py:80-105``'s
    ``axis_name``): X is this rank's block of chains, and the batch
    moments are taken over every rank's chains (a mean and a sum
    all-reduced), so every rank merges the same global batch."""
    nb = X.shape[0]
    mean_b = X.mean(0)
    if axis is not None:
        from ..parallel.collectives import pmean, psum
        nb = nb * axis.size
        mean_b = pmean(mean_b, axis)
        m2_b = psum(((X - mean_b) ** 2).sum(0), axis)
    else:
        m2_b = ((X - mean_b) ** 2).sum(0)
    delta = mean_b - state.mean
    count = state.count + nb
    mean = state.mean + delta * nb / count
    m2 = state.m2 + m2_b + delta * delta * state.count * nb / count
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize: bool = True):
    """Sample variance with Stan's shrink-to-unit regularization."""
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
    if regularize:
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


# -------------------------------------------------------------------------
# Stan's window schedule (numpy, on the host).

def build_schedule(num_warmup: int, init_buffer: int = 75,
                   term_buffer: int = 50, first_window: int = 25):
    """Per-step flags: (in_slow_window, is_window_end) as numpy bool arrays.

    Mirrors Stan's logic: if warmup is too short for the three phases, the
    buffers shrink proportionally.
    """
    if num_warmup < 20:
        return (np.zeros(num_warmup, bool), np.zeros(num_warmup, bool))
    if init_buffer + term_buffer + first_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        first_window = num_warmup - init_buffer - term_buffer

    in_slow = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    pos = init_buffer
    size = first_window
    slow_end = num_warmup - term_buffer
    while pos < slow_end:
        # last window absorbs the remainder
        if pos + 2 * size > slow_end:
            size = slow_end - pos
        in_slow[pos:pos + size] = True
        window_end[pos + size - 1] = True
        pos += size
        size *= 2
    return in_slow, window_end
