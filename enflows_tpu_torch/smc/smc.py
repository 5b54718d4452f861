"""Tempered Sequential Monte Carlo with learned annealing flow transports.

Counterpart of ``enflows_tpu/smc/smc.py``, batch-first: the particles are
an (n, dim) tensor on the generator's device, the densities are batched,
(n, dim) -> (n,), and every random number comes from a
``torch.Generator``. Geometric annealing path between a tractable base
(standard normal by default) and the target:

    log pi_beta(x) = (1 - beta) * log p0(x) + beta * log p1(x)

Each temperature step has three pieces, run eagerly; the ladder over
temperatures is a Python loop that reads beta back once a temperature to
stop at beta = 1:

1. **Adaptive tempering** (``compute_next_beta``): bisection picks beta' so
   the incremental-weight ESS equals ``ess_target * n``. It runs on the
   device as a masked loop that freezes its bracket where JAX's
   ``lax.while_loop`` stops, so it reads nothing back.
2. **Optional learned transport** (Annealed Flow Transport, Arbel et al.
   2021): a flow T fit between temperatures moves the particles with the
   incremental weight ``log pi_beta'(T(x)) + ladj_T(x) - log pi_beta(x)``;
   without one the weight is ``(beta' - beta) * (log p1 - log p0)``.
3. **Resample + mutate** (``reweight_resample_mutate``): systematic
   resampling where the ESS falls to the threshold (a mask, not a host
   branch), then ``mutation_steps`` HMC transitions of all particles at
   once targeting pi_beta', preconditioned by the weighted ensemble
   variance, with Robbins-Monro step-size adaptation toward 65%
   acceptance.

The running log normalizing constant accumulates logsumexp(normalized
previous weights + incremental weights) each step.

Random numbers: the resampling uniform (``_resample_uniform``) and each
mutation's momentum normals and acceptance uniforms (``_mutation_draws``)
are drawn in one place each, so that a test can hand the step another
framework's draws. Torch compiles nothing, so the JAX factories'
identity-keyed ``lru_cache`` has no counterpart: every factory here builds
its closures anew and cheaply.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..bijectors.base import Bijector
from ..distributions.base import std_normal_logpdf_sum
from ..mcmc.hmc import hmc_transition, init_state, value_and_grad
from ..train.vi import _route


class SMCState(NamedTuple):
    particles: torch.Tensor      # (n, dim)
    log_weights: torch.Tensor    # (n,) unnormalized
    beta: torch.Tensor           # current inverse temperature, 0-d
    log_z: torch.Tensor          # running log normalizing-constant estimate
    step_size: torch.Tensor      # mutation step size (adapted), 0-d


class SMCInfo(NamedTuple):
    beta: torch.Tensor
    ess: torch.Tensor
    accept_prob: torch.Tensor
    resampled: torch.Tensor
    log_z: torch.Tensor


def log_ess(log_weights: torch.Tensor) -> torch.Tensor:
    """log ESS = 2*logsumexp(w) - logsumexp(2w)."""
    return (2.0 * torch.logsumexp(log_weights, 0)
            - torch.logsumexp(2.0 * log_weights, 0))


def _resample_uniform(generator, dtype, device) -> torch.Tensor:
    """The single uniform of systematic resampling, a 0-d tensor."""
    return torch.rand((), generator=generator, dtype=dtype, device=device)


def _mutation_draws(generator, q):
    """One mutation transition's draws for all particles: the momentum's
    unit normals (n, dim), then the acceptance uniforms (n,)."""
    noise = torch.randn(q.shape, generator=generator, dtype=q.dtype,
                        device=q.device)
    u = torch.rand(q.shape[0], generator=generator, dtype=q.dtype,
                   device=q.device)
    return noise, u


def systematic_resample(generator, log_weights, particles):
    """Systematic (single-uniform stratified) resampling
    (``enflows_tpu/smc/smc.py:67-80``): a search of the n evenly spaced
    points (u0 + i) / n in the weight CDF, each taking the first index whose
    CDF reaches it, clipped to n - 1."""
    n = log_weights.shape[0]
    w = torch.softmax(log_weights, 0)
    cdf = torch.cumsum(w, 0)
    u0 = _resample_uniform(generator, w.dtype, w.device)
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(cdf, pts, side="left")
    return particles[torch.clamp(idx, max=n - 1)]


def make_tempered(log_base: Callable, log_target: Callable):
    """``tempered(beta)`` is the batched density of pi_beta; ``beta`` may be
    a 0-d device tensor, so tempering never reads it back."""
    def tempered(beta):
        def logp(q):
            return (1.0 - beta) * log_base(q) + beta * log_target(q)
        return logp
    return tempered


class SMCKernels(NamedTuple):
    """The SMC pieces for one (base, target) pair, from
    :func:`build_smc_kernels`, for ``smc_sample(kernels=...)``.

    ``ladder(generator, state, max_temps) -> (state, temperatures,
    infos)`` runs the whole ladder with the fitter it was built with;
    ``infos`` is an :class:`SMCInfo` of (max_temps,) tensors, zero past the
    last temperature."""
    compute_next_beta: Callable   # (state) -> beta'
    step: Callable                # (generator, state, beta_new, lw_inc) -> ...
    tempered: Callable            # (beta) -> logp
    holdout_logz: bool
    ladder: Optional[Callable] = None


def _transport_forward(T: Bijector, x: torch.Tensor):
    """(T(x), ladj) without a graph, by the trainer's route: on a CUDA batch
    kernel B1 for a fusible elementwise chain (B4 for a fusible coupling
    stack, lanes in logical order), else T's own forward."""
    forward = _route(T, x.shape[1], x.dtype, x.device, None, x.shape[0])
    with torch.no_grad():
        return forward(T, x)


def _run_ladder(generator, state: SMCState, max_temps: int,
                compute_next_beta, step, tempered, log_base, log_target,
                fit_transport):
    """The temperature ladder: beta', the optional transport, the step, until
    beta reaches 1 or ``max_temps`` steps ran. One host read a temperature
    (beta, for the stop test). Returns (state, [SMCInfo])."""
    infos = []
    for _ in range(max_temps):
        beta_new = compute_next_beta(state)
        if fit_transport is not None:
            T = fit_transport(generator, state.particles, state.log_weights,
                              state.beta, beta_new)
            y, ladj = _transport_forward(T, state.particles)
            with torch.no_grad():
                lw_inc = (tempered(beta_new)(y) + ladj
                          - tempered(state.beta)(state.particles))
            state = state._replace(particles=y)
        else:
            with torch.no_grad():
                lw_inc = (beta_new - state.beta) * (
                    log_target(state.particles) - log_base(state.particles))
        state, info = step(generator, state, beta_new, lw_inc)
        infos.append(info)
        if float(state.beta) >= 1.0:
            break
    return state, infos


def _build_ladder(compute_next_beta, step, tempered, log_base, log_target,
                  fit_transport):
    """The whole-ladder runner of ``SMCKernels.ladder``
    (``enflows_tpu/smc/smc.py:106-158``): the same eager ladder as
    ``smc_sample``'s, its infos stacked into (max_temps,) buffers as the
    JAX ``lax.while_loop`` ladder returns them."""

    def ladder(generator, state: SMCState, max_temps: int):
        state, infos = _run_ladder(generator, state, max_temps,
                                   compute_next_beta, step, tempered,
                                   log_base, log_target, fit_transport)
        if not infos:
            return state, 0, None
        pad = max_temps - len(infos)
        bufs = SMCInfo(*(torch.cat([torch.stack(v), torch.zeros(
            pad, dtype=v[0].dtype, device=v[0].device)])
            for v in zip(*infos)))
        return state, len(infos), bufs

    ladder.has_transport = fit_transport is not None
    return ladder


def make_smc_ladder(log_base: Callable, log_target: Callable,
                    fit_transport: Optional[Callable] = None, *,
                    ess_target: float = 0.5, mutation_steps: int = 5,
                    leapfrog_steps: int = 10,
                    resample_threshold: float = 0.5,
                    target_accept: float = 0.65):
    """Whole-ladder runner ``(generator, state, max_temps) -> (state,
    temperatures, infos)`` (``enflows_tpu/smc/smc.py:161-181``)."""
    compute_next_beta = make_compute_next_beta(log_base, log_target,
                                               ess_target)
    step = make_reweight_resample_mutate(
        log_base, log_target, mutation_steps=mutation_steps,
        leapfrog_steps=leapfrog_steps,
        resample_threshold=resample_threshold,
        target_accept=target_accept,
        holdout_logz=fit_transport is not None)
    return _build_ladder(compute_next_beta, step,
                         make_tempered(log_base, log_target),
                         log_base, log_target, fit_transport)


def build_smc_kernels(log_base: Callable, log_target: Callable, *,
                      mutation_steps: int = 5, leapfrog_steps: int = 10,
                      ess_target: float = 0.5,
                      resample_threshold: float = 0.5,
                      target_accept: float = 0.65,
                      holdout_logz: bool = False,
                      fit_transport: Optional[Callable] = None
                      ) -> SMCKernels:
    """The SMC pieces for a (base, target) pair, built once
    (``enflows_tpu/smc/smc.py:184-220``). Nothing is compiled here; the
    function keeps JAX's signature so that code written against it ports.

    ``fit_transport`` (optional) is baked into ``ladder``; when given,
    ``holdout_logz`` is forced True to keep the log Z estimate unbiased.
    """
    holdout_logz = holdout_logz or (fit_transport is not None)
    compute_next_beta = make_compute_next_beta(log_base, log_target,
                                               ess_target)
    step = make_reweight_resample_mutate(
        log_base, log_target, mutation_steps=mutation_steps,
        leapfrog_steps=leapfrog_steps,
        resample_threshold=resample_threshold,
        target_accept=target_accept, holdout_logz=holdout_logz)
    tempered = make_tempered(log_base, log_target)
    return SMCKernels(
        compute_next_beta=compute_next_beta,
        step=step,
        tempered=tempered,
        holdout_logz=holdout_logz,
        ladder=_build_ladder(compute_next_beta, step, tempered, log_base,
                             log_target, fit_transport),
    )


# JAX's bisection stops after 60 halvings or once hi - lo <= 1e-6. From a
# bracket of width 1 - beta <= 1, each halving leaves at most half the
# width plus one rounding of the midpoint (6e-8 in float32), so in float32
# and float64 the rule stops within 21 halvings; 24 masked halvings give
# its iterates exactly. Coarser dtypes run all 60.
_HALVINGS = 24


def make_compute_next_beta(log_base: Callable, log_target: Callable,
                           ess_target: float = 0.5):
    """``compute_next_beta(state) -> beta'``, a 0-d tensor: bisection on the
    incremental-weight ESS (``enflows_tpu/smc/smc.py:223-265``), with JAX's
    stopping rule and its full-step short cut (beta' = 1 where the ESS at
    1 already meets the target). The loop runs a fixed number of masked
    halvings on the device, each freezing the bracket once the rule has
    stopped, so it reads nothing back."""

    def compute_next_beta(state: SMCState):
        x = state.particles
        n, dtype = x.shape[0], x.dtype
        with torch.no_grad():
            log_ratio = log_target(x) - log_base(x)
        # A fill, not a copy from the host: no synchronization.
        target_log_ess = torch.full((), ess_target * n, dtype=dtype,
                                    device=x.device).log()

        def ess_at(b):
            return log_ess(state.log_weights + (b - state.beta) * log_ratio)

        one = torch.ones((), dtype=dtype, device=x.device)
        full = ess_at(one) >= target_log_ess
        lo, hi = state.beta, one
        halvings = _HALVINGS if torch.finfo(dtype).eps <= 2.4e-7 else 60
        for _ in range(halvings):
            live = hi - lo > 1e-6
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target_log_ess
            lo = torch.where(live & ok, mid, lo)
            hi = torch.where(live & ~ok, mid, hi)
        return torch.where(full, one, lo)

    return compute_next_beta


def make_reweight_resample_mutate(
        log_base: Callable, log_target: Callable, *,
        mutation_steps: int = 5, leapfrog_steps: int = 10,
        resample_threshold: float = 0.5, target_accept: float = 0.65,
        holdout_logz: bool = False):
    """``step(generator, state, beta_new, lw_inc) -> (state, info)``
    (``enflows_tpu/smc/smc.py:268-354``).

    ``holdout_logz``: estimate the log Z increment from the odd-index half
    of the population only, as needed when ``lw_inc`` came from a learned
    transport fit on the even-index half (see ``flow_transport``).
    """
    tempered = make_tempered(log_base, log_target)

    def step(generator, state: SMCState, beta_new, lw_inc):
        n = state.particles.shape[0]
        # log Z: weighted mean of incremental weights under prev weights
        # (restricted to the held-out half when the transport was fit on
        # the training half).
        lw_prev = state.log_weights[1::2] if holdout_logz else \
            state.log_weights
        lw_i = lw_inc[1::2] if holdout_logz else lw_inc
        log_w_prev_norm = lw_prev - torch.logsumexp(lw_prev, 0)
        log_z = state.log_z + torch.logsumexp(log_w_prev_norm + lw_i, 0)

        log_weights = state.log_weights + lw_inc
        cur_ess = torch.exp(log_ess(log_weights))
        # Inclusive: adaptive tempering drives ESS exactly TO the target,
        # so a strict < would never fire and beta would stall at the
        # boundary (ess_target == resample_threshold is the default).
        do_resample = cur_ess <= resample_threshold * n * (1.0 + 1e-6)
        particles = torch.where(
            do_resample,
            systematic_resample(generator, log_weights, state.particles),
            state.particles)
        log_weights = torch.where(do_resample, torch.zeros_like(log_weights),
                                  log_weights)

        logp_fn = tempered(beta_new)
        value_grad_fn = lambda q: value_and_grad(logp_fn, q)
        states = init_state(logp_fn, particles)

        # Particle-ensemble mass matrix: the weighted population variance
        # preconditions the mutation kernel (M^-1 = var).
        w_norm = torch.softmax(log_weights, 0)
        mean_p = w_norm @ particles
        var_p = w_norm @ (particles - mean_p) ** 2
        inv_mass = torch.clamp(var_p, 1e-6, 1e6)
        inv_sd = torch.rsqrt(inv_mass)

        step_size, accs = state.step_size, []
        for _ in range(mutation_steps):
            noise, u = _mutation_draws(generator, states.q)
            states, info = hmc_transition(value_grad_fn, states, step_size,
                                          inv_mass, leapfrog_steps,
                                          noise * inv_sd, u)
            acc = info.accept_prob.mean()
            step_size = step_size * torch.exp(0.5 * (acc - target_accept))
            accs.append(acc)
        accept_prob = (torch.stack(accs).mean() if accs else
                       torch.full_like(step_size, float("nan")))

        new_state = SMCState(particles=states.q, log_weights=log_weights,
                             beta=beta_new, log_z=log_z,
                             step_size=step_size)
        info = SMCInfo(beta=beta_new, ess=cur_ess, accept_prob=accept_prob,
                       resampled=do_resample, log_z=log_z)
        return new_state, info

    return step


def smc_sample(log_target: Callable, key: Optional[torch.Generator] = None,
               *, dim: int, num_particles: int = 1024,
               log_base: Optional[Callable] = None,
               base_sampler: Optional[Callable] = None,
               mutation_steps: int = 5, leapfrog_steps: int = 10,
               ess_target: float = 0.5, resample_threshold: float = 0.5,
               initial_step_size: float = 0.2, max_temps: int = 200,
               fit_transport: Optional[Callable] = None,
               kernels: Optional[SMCKernels] = None,
               metrics=None,
               in_graph: Optional[bool] = None,
               dtype=torch.float32):
    """Adaptive tempered SMC from base to ``log_target``
    (``enflows_tpu/smc/smc.py:357-479``).

    Returns (particles, log_weights, log_z, infos), ``infos`` a list of
    :class:`SMCInfo`, one a temperature.

    ``log_target``: a batched density, (n, dim) -> (n,). ``key``: the
    ``torch.Generator`` of every draw; the particles live on its device.
    Without one, a generator seeded 0 on the card. ``base_sampler(generator,
    n)`` draws the (n, dim) starting particles from the density
    ``log_base`` (default: the standard normal and its sampler).

    ``fit_transport(generator, particles, log_weights, beta, beta_next) ->
    Bijector`` (optional): learned annealing transport, applied with the
    AFT-corrected incremental weight. ``flow_transport`` builds one whose
    fit (and the transport's application to all particles) runs kernels B1
    and B2 on the card.

    ``kernels`` (optional): :class:`SMCKernels` from
    :func:`build_smc_kernels`. When they bake in a ``fit_transport``, pass
    the same fitter here too: its presence selects their ladder, which runs
    the baked one.

    ``in_graph`` is accepted for JAX's signature; both values run the same
    eager ladder, whose one host read a temperature is beta. ``metrics``
    (streaming one record a temperature) is not ported yet.
    """
    if key is None:
        key = torch.Generator(device="cuda").manual_seed(0)
    device = key.device
    if log_base is None:
        log_base = std_normal_logpdf_sum
        base_sampler = lambda g, n: torch.randn(n, dim, generator=g,
                                                dtype=dtype, device=device)
    if base_sampler is None:
        raise ValueError("a custom log_base needs base_sampler")

    particles = base_sampler(key, num_particles)
    zero = torch.zeros((), dtype=dtype, device=device)
    state = SMCState(
        particles=particles,
        log_weights=torch.zeros(num_particles, dtype=dtype, device=device),
        beta=zero,
        log_z=zero,
        step_size=torch.full((), initial_step_size, dtype=dtype,
                             device=device),
    )
    if fit_transport is not None and num_particles % 2:
        raise ValueError("learned transports need an even particle count "
                         "(train/estimation split)")
    if kernels is not None:
        if kernels.holdout_logz != (fit_transport is not None):
            raise ValueError("kernels.holdout_logz must match fit_transport "
                             "presence")
        compute_next_beta, step, tempered = (
            kernels.compute_next_beta, kernels.step, kernels.tempered)
        ladder = kernels.ladder
        if ladder is not None and \
                ladder.has_transport != (fit_transport is not None):
            ladder = None       # kernels built for the other mode
    else:
        compute_next_beta = make_compute_next_beta(log_base, log_target,
                                                   ess_target)
        step = make_reweight_resample_mutate(
            log_base, log_target, mutation_steps=mutation_steps,
            leapfrog_steps=leapfrog_steps,
            resample_threshold=resample_threshold,
            holdout_logz=fit_transport is not None)
        tempered = make_tempered(log_base, log_target)
        ladder = None

    use_in_graph = (metrics is None) if in_graph is None else in_graph
    if use_in_graph and metrics is not None:
        raise ValueError(
            "in_graph=True cannot stream metrics (the ladder runs in one "
            "jit); drop metrics= or pass in_graph=False")
    if metrics is not None:
        raise NotImplementedError("smc_sample(metrics=...) is not ported to "
                                  "enflows_tpu_torch yet (ROADMAP A.11)")
    if use_in_graph and ladder is not None:
        state, n_t, bufs = ladder(key, state, max_temps)
        infos = [SMCInfo(*(b[i] for b in bufs)) for i in range(n_t)]
    else:
        state, infos = _run_ladder(key, state, max_temps, compute_next_beta,
                                   step, tempered, log_base, log_target,
                                   fit_transport)
    return state.particles, state.log_weights, state.log_z, infos
