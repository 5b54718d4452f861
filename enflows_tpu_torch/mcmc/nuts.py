"""Multinomial No-U-Turn Sampler, batch-first.

Counterpart of ``enflows_tpu/mcmc/nuts.py``: multinomial NUTS (trajectories
double in a random direction up to ``max_depth`` times, leaves weighted by
exp(-H), proposals by progressive multinomial sampling with the biased
merge rule, doubling stops at a U-turn or a divergence), with the same
checkpoint stacks for the U-turn checks inside a subtree and Stan's
merge-boundary checks (that module's docstring derives both).

The JAX kernel is written for one chain: two nested ``lax.while_loop`` s
(the doublings, and the leaves of a subtree), ``vmap``-ed over the chains.
Under ``vmap`` the loops run in lockstep: every chain still running is at
the same depth and the same leaf index, and a stopped chain's carry is
frozen by a select. Here a transition moves all chains at once, so the
depth, the leaf index n, popcount(n), the trailing ones of n, the
checkpoint slots and the subtree checks are Python ints shared by all
chains, and per chain there are only masks: a doubling runs while any
chain is neither turning nor divergent, a subtree's leaves while any chain
of it has not stopped. The host reads one flag after each leaf but a
subtree's last and one after each doubling but the first; ``LOCKSTEP``
counts them.

A chain that has stopped keeps computing with the others (its rows may
hold inf or NaN; nothing reduces over the chains axis before a mask). What
decides its result is masked where JAX's loop would have stopped it: the
leaf count, the acceptance statistic, the turning and divergence flags,
the depth, and the merge of a subtree's proposal into the trajectory's.
The rest of a subtree's state (the leaf, the momentum sums, the checkpoint
stacks, the subtree's proposal and weight) is updated unmasked: a chain
that stopped inside a subtree never reads it again, since its subtree's
proposal is not merged and the trajectory stops there.

Random numbers: ``nuts_transition`` takes its draws as arguments (the
momentum's unit normals, and per doubling a callable's direction bits,
merge uniforms and leaf-selection uniforms), so a test can hand it the
JAX kernel's own per-chain draws. ``nuts_kernel`` draws them from a
``torch.Generator`` a doubling at a time, in an order that does not
depend on which chains are still running.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import HMCState, kinetic_energy, value_and_grad

# Lockstep cost of the transitions run so far: doublings, leaves (each one
# gradient evaluation of every chain) and host reads of a stop flag.
LOCKSTEP = {"transitions": 0, "doublings": 0, "leaves": 0, "host_reads": 0}


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor   # (n,) mean leaf acceptance statistic
    divergent: torch.Tensor     # (n,) bool
    depth: torch.Tensor         # (n,) tree depth reached
    num_steps: torch.Tensor     # (n,) leapfrog steps taken
    energy: torch.Tensor        # (n,) H at the accepted proposal


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    # trailing ones of n == popcount(n & ~(n+1))
    return _popcount(n & ~(n + 1))


def _dot(a, b):
    return (a * b).sum(-1)


def _is_turning(v_left, v_right, rho):
    return (_dot(v_left, rho) <= 0.0) | (_dot(v_right, rho) <= 0.0)


def _slots(stack, slots):
    """``stack[slots]`` for a list of slot indices: a slice where they run
    consecutively up or down."""
    a, b = slots[0], slots[-1]
    if slots == list(range(a, b + 1)):
        return stack[a:b + 1]
    if slots == list(range(a, b - 1, -1)):
        return stack[b:a + 1].flip(0)
    return stack[torch.tensor(slots, device=stack.device)]


def _subtree_turning(k, ckpt_p, ckpt_S, ckpt_podd, S_new, v, inv_mass,
                     max_depth, extra_uturn_checks):
    """Whether a sub-subtree closing at odd leaf ``k`` turns (``nuts.py:
    155-188``): the tau = trailing_ones(k) sub-subtrees [m..k] whose left
    ends sit at slots popcount(k)-tau .. popcount(k)-1, all checked at
    once, with Stan's two merge-boundary checks for those of size 4 and
    more. Returns a (n,) mask."""
    pc, tau = _popcount(k), _trailing_ones(k)
    # Sub-subtree j = 0 .. tau-1 has its left end at slot pc-1-j; here in
    # ascending slot order, so j runs down from tau-1 to 0.
    idx = list(range(pc - tau, pc))
    p_m, S_m = ckpt_p[pc - tau:pc], ckpt_S[pc - tau:pc]
    v_m = p_m * inv_mass
    rho = S_new - S_m
    turn = _is_turning(v_m, v, rho).any(0)
    if extra_uturn_checks and tau > 1:
        # j >= 1: the rows of idx but the last.
        js = [pc - 1 - i for i in idx[:-1]]
        safe = [min(i + 1, max_depth) for i in idx[:-1]]
        p_b = _slots(ckpt_p, safe)           # momentum at mid+1 (even)
        S_mid = _slots(ckpt_S, safe)         # prefix through mid
        p_mid = _slots(ckpt_podd, [min(max(j, 1), max_depth) for j in js])
        rho_bck = S_mid - S_m[:-1]
        rho_fwd = S_new - S_mid
        t_a = _is_turning(v_m[:-1], p_b * inv_mass, rho_bck + p_b)
        t_b = _is_turning(p_mid * inv_mass, v, rho_fwd + p_mid)
        turn = turn | (t_a | t_b).any(0)
    return turn


def _build_subtree(value_grad_fn, q, p, grad, eps, depth, energy0, running,
                   u_leaf, inv_mass, max_depth, divergence_threshold,
                   extra_uturn_checks):
    """Extend 2^depth leapfrog steps from (q, p) with step ``eps`` ((n, 1))
    for the chains in ``running`` (``nuts.py:98-217``): progressive
    multinomial proposal, checkpointed U-turn checks, divergence check.
    ``u_leaf``: (2^depth, n) selection uniforms."""
    n, dim = q.shape
    like = dict(dtype=q.dtype, device=q.device)
    ckpt_p = torch.zeros(max_depth + 1, n, dim, **like)
    ckpt_S = torch.zeros(max_depth + 1, n, dim, **like)
    ckpt_podd = torch.zeros(max_depth + 1, n, dim, **like)
    log_u = torch.log(u_leaf)
    half = 0.5 * eps
    prop_q, prop_grad, prop_h = q, grad, energy0
    prop_logp = torch.zeros(n, **like)
    log_w = torch.full((n,), -math.inf, **like)
    S = torch.zeros_like(q)
    p_first = p
    count = torch.zeros(n, dtype=torch.int64, device=q.device)
    turning = torch.zeros(n, dtype=torch.bool, device=q.device)
    divergent = torch.zeros_like(turning)
    sum_prob = torch.zeros(n, **like)
    num_leaves = 1 << depth
    for k in range(num_leaves):
        p = p + half * grad
        q = q + eps * p * inv_mass
        logp, grad = value_grad_fn(q)
        p = p + half * grad
        h = -logp + kinetic_energy(p, inv_mass)
        delta = energy0 - h
        delta = delta.masked_fill(torch.isnan(delta), -math.inf)
        count += running
        divergent |= running & (-delta > divergence_threshold)
        sum_prob += torch.where(running, torch.clamp(torch.exp(delta),
                                                     max=1.0), 0.0)

        # Progressive multinomial sampling within the subtree.
        log_w_new = torch.logaddexp(log_w, delta)
        take = log_u[k] < delta - log_w_new
        log_w = log_w_new
        prop_q = torch.where(take[:, None], q, prop_q)
        prop_logp = torch.where(take, logp, prop_logp)
        prop_grad = torch.where(take[:, None], grad, prop_grad)
        prop_h = torch.where(take, h, prop_h)
        if k == 0:
            p_first = p

        if k % 2 == 0:
            # Checkpoint at even leaves (slot popcount(k)); S is the
            # momentum prefix sum before this leaf.
            ckpt_p[_popcount(k)] = p
            ckpt_S[_popcount(k)] = S
            S = S + p
        else:
            S = S + p
            turning |= running & _subtree_turning(
                k, ckpt_p, ckpt_S, ckpt_podd, S, p * inv_mass, inv_mass,
                max_depth, extra_uturn_checks)
            # This odd leaf's momentum for later boundary checks (slot =
            # its trailing ones; written after the checks).
            ckpt_podd[min(_trailing_ones(k), max_depth)] = p
        running = running & ~turning & ~divergent
        if k + 1 < num_leaves:
            LOCKSTEP["host_reads"] += 1
            if not bool(running.any()):
                LOCKSTEP["leaves"] += k + 1
                break
    else:
        LOCKSTEP["leaves"] += num_leaves
    return dict(n=count, q_end=q, p_end=p, grad_end=grad, prop_q=prop_q,
                prop_logp=prop_logp, prop_grad=prop_grad, prop_h=prop_h,
                log_w=log_w, rho=S, p_first=p_first, turning=turning,
                divergent=divergent, sum_prob=sum_prob)


def nuts_transition(value_grad_fn: Callable, state: HMCState, step_size,
                    inv_mass_diag, noise, doubling_draws: Callable, *,
                    max_depth: int = 10, divergence_threshold: float = 1000.0,
                    extra_uturn_checks: bool = True):
    """One NUTS transition of all chains given its draws (``nuts.py:221-
    332``): the momentum's unit normals ``noise`` (n, dim), scaled by
    rsqrt(inv_mass_diag), and ``doubling_draws(depth)`` -> (direction
    bits (n,) bool, merge uniforms (n,), leaf-selection uniforms
    (2^depth, n)) for each doubling. ``value_grad_fn``: q -> (logp, grad).
    Returns (state, info)."""
    q0 = state.q
    n = q0.shape[0]
    inv_mass = inv_mass_diag
    step = torch.as_tensor(step_size, dtype=q0.dtype, device=q0.device)
    p0 = noise * torch.rsqrt(inv_mass)
    energy0 = -state.logp + kinetic_energy(p0, inv_mass)
    q_left, p_left, g_left = q0, p0, state.grad
    q_right, p_right, g_right = q0, p0, state.grad
    rho = p0
    prop_q, prop_logp, prop_grad = q0, state.logp, state.grad
    prop_energy = energy0
    log_w = torch.zeros(n, dtype=q0.dtype, device=q0.device)
    depth = torch.zeros(n, dtype=torch.int64, device=q0.device)
    num_steps = torch.zeros_like(depth)
    turning = torch.zeros(n, dtype=torch.bool, device=q0.device)
    divergent = torch.zeros_like(turning)
    sum_prob = torch.zeros_like(log_w)
    LOCKSTEP["transitions"] += 1
    for d in range(max_depth):
        active = ~turning & ~divergent
        if d > 0:
            LOCKSTEP["host_reads"] += 1
            if not bool(active.any()):
                break
        LOCKSTEP["doublings"] += 1
        go_right, u_merge, u_leaf = doubling_draws(d)
        right = go_right[:, None]
        sub = _build_subtree(
            value_grad_fn, torch.where(right, q_right, q_left),
            torch.where(right, p_right, p_left),
            torch.where(right, g_right, g_left),
            torch.where(go_right, step, -step)[:, None], d, energy0, active,
            u_leaf, inv_mass, max_depth, divergence_threshold,
            extra_uturn_checks)
        stop_bad = sub["turning"] | sub["divergent"]

        # Stan's merge-boundary checks between the old trajectory and the
        # new subtree (left half = old trajectory when going right, = new
        # subtree when going left); p_first is the subtree's leaf next to
        # the old endpoint. They read the old endpoints.
        if extra_uturn_checks:
            p_lh_l = torch.where(right, p_left, sub["p_end"])
            p_rh_l = torch.where(right, sub["p_first"], p_left)
            rho_lh = torch.where(right, rho, sub["rho"])
            t_a = _is_turning(p_lh_l * inv_mass, p_rh_l * inv_mass,
                              rho_lh + p_rh_l)
            p_lh_r = torch.where(right, p_right, sub["p_first"])
            p_rh_r = torch.where(right, sub["p_end"], p_right)
            rho_rh = torch.where(right, sub["rho"], rho)
            t_b = _is_turning(p_lh_r * inv_mass, p_rh_r * inv_mass,
                              rho_rh + p_lh_r)

        # Merge endpoints.
        q_right = torch.where(right, sub["q_end"], q_right)
        p_right = torch.where(right, sub["p_end"], p_right)
        g_right = torch.where(right, sub["grad_end"], g_right)
        q_left = torch.where(right, q_left, sub["q_end"])
        p_left = torch.where(right, p_left, sub["p_end"])
        g_left = torch.where(right, g_left, sub["grad_end"])

        # Biased progressive merge: prefer the new subtree.
        take = (torch.log(u_merge) < sub["log_w"] - log_w) & ~stop_bad \
            & active
        prop_q = torch.where(take[:, None], sub["prop_q"], prop_q)
        prop_logp = torch.where(take, sub["prop_logp"], prop_logp)
        prop_grad = torch.where(take[:, None], sub["prop_grad"], prop_grad)
        prop_energy = torch.where(take, sub["prop_h"], prop_energy)

        rho = rho + sub["rho"]
        turning_total = _is_turning(p_left * inv_mass, p_right * inv_mass,
                                    rho)
        if extra_uturn_checks:
            turning_total = turning_total | t_a | t_b
        log_w = torch.where(stop_bad, log_w,
                            torch.logaddexp(log_w, sub["log_w"]))
        depth = depth + active
        num_steps = num_steps + sub["n"]
        turning = turning | (active & (sub["turning"] | turning_total))
        divergent = divergent | sub["divergent"]
        sum_prob = sum_prob + sub["sum_prob"]

    new_state = HMCState(q=prop_q, logp=prop_logp, grad=prop_grad)
    info = NUTSInfo(
        accept_prob=sum_prob / torch.clamp(num_steps.to(q0.dtype), min=1.0),
        divergent=divergent, depth=depth, num_steps=num_steps,
        energy=prop_energy)
    return new_state, info


def _generator_draws(generator, n, dtype, device):
    """A doubling's draws from ``generator``, drawn when the doubling
    starts: one (2 + 2^depth, n) block of uniforms, whichever chains are
    still running."""

    def draws(depth):
        u = torch.rand(2 + (1 << depth), n, generator=generator, dtype=dtype,
                       device=device)
        return u[0] < 0.5, u[1], u[2:]

    return draws


def nuts_kernel(logdensity_fn: Callable, max_depth: int = 10,
                divergence_threshold: float = 1000.0,
                extra_uturn_checks: bool = True,
                value_and_grad_fn: Callable | None = None):
    """Build a one-transition NUTS kernel over all chains:
    (generator, state, step_size, inv_mass_diag) -> (state, info).

    ``logdensity_fn``: (n, dim) -> (n,). ``extra_uturn_checks``: Stan's
    merge-boundary conditions, on by default. ``value_and_grad_fn``:
    a batched q -> (logp, grad) that overrides autograd of
    ``logdensity_fn``."""
    value_grad_fn = value_and_grad_fn or (
        lambda q: value_and_grad(logdensity_fn, q))

    def kernel(generator, state: HMCState, step_size, inv_mass_diag):
        q = state.q
        noise = torch.randn(q.shape, generator=generator, dtype=q.dtype,
                            device=q.device)
        return nuts_transition(
            value_grad_fn, state, step_size, inv_mass_diag, noise,
            _generator_draws(generator, q.shape[0], q.dtype, q.device),
            max_depth=max_depth, divergence_threshold=divergence_threshold,
            extra_uturn_checks=extra_uturn_checks)

    return kernel
