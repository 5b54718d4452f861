"""Tempered SMC with the particles sharded over a mesh axis.

PyTorch counterpart of ``enflows_tpu/parallel/smc_sharded.py``: the
single-process ``smc.smc`` pieces with ``axis=`` given. Every per-particle
computation stays on the rank that holds the particle; the ranks exchange
only

* the global log-ESS and logsumexp (each rank's max and shifted sums,
  gathered in one collective),
* the adaptive-tempering bisection, on those all-reduced scalars: every
  rank runs the same fixed number of masked halvings, so all take the same
  number of collectives and reach the same beta,
* the distributed systematic resampler (``parallel.resample``), where the
  global ESS asks for it,
* the ensemble mass matrix (two sums) and the mutations' acceptance mean
  (step-size consensus),
* the learned annealing transport's fit (optional,
  ``smc.flow_transport``): the AFT loss is a sum over particles, so its
  gradient is the all-reduced sum of the ranks' gradients, and every rank
  runs the same Adam update: the flow stays replicated. Each rank's fit
  and application run the flow-VI route on its block, kernels B1 + B2 on
  the card for the default per-dimension transport.

RNG contract: every rank passes the same generator and draws each random
tensor at the global particle count, keeping its block (``mcmc.hmc.Rows``
through ``smc.smc._mutation_draws``); the resampling uniform is drawn by
all and rank 0's used. A sharded run therefore follows the
single-process ``smc.smc_sample`` draw for draw (the reductions differ in
their order only), and the draw hooks can feed it JAX's draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..distributions.base import std_normal_logpdf_sum
from ..mcmc.hmc import randn
from ..smc import smc as _smc
from ..smc.flow_transport import make_transport_fitter
from ..smc.smc import SMCState
from ..utils.profiling import annotate
from .mesh import Mesh, block_range


def build_sharded_smc_step(log_base: Callable, log_target: Callable,
                           mesh: Mesh, *, axis_name: str = "chains",
                           mutation_steps: int = 5,
                           leapfrog_steps: int = 10,
                           ess_target: float = 0.5,
                           resample_threshold: float = 0.5,
                           resample_method: str | None = None,
                           target_accept: float = 0.65,
                           transport_steps: int = 0,
                           transport_lr: float = 5e-2):
    """The sharded one-temperature step
    (``enflows_tpu/parallel/smc_sharded.py:61-259``): ``step(generator,
    state)``, or with ``transport_steps > 0`` ``step(generator, state,
    flow)``, -> (state, info). ``state.particles`` and ``log_weights`` are
    this rank's block; beta, log Z and the step size, and every field of
    the :class:`smc.SMCInfo`, are replicated. ``flow``: an
    identity-initialized transport (e.g. ``smc.flow_transport.
    default_template``), fit in place for ``transport_steps`` Adam(
    ``transport_lr``) steps between the temperatures and applied with the
    AFT-corrected incremental weight, the log Z increment taken on the
    held-out odd half. Torch compiles nothing, so building is cheap; JAX's
    ``make_sharded_smc_step`` cache has no counterpart."""
    axis = mesh.axis(axis_name)
    compute_next_beta = _smc.make_compute_next_beta(
        log_base, log_target, ess_target, axis=axis)
    reweight = _smc.make_reweight_resample_mutate(
        log_base, log_target, mutation_steps=mutation_steps,
        leapfrog_steps=leapfrog_steps,
        resample_threshold=resample_threshold, target_accept=target_accept,
        holdout_logz=transport_steps > 0, axis=axis,
        resample_method=resample_method)
    tempered = _smc.make_tempered(log_base, log_target)

    def step(generator, state: SMCState, flow=None):
        fit = None
        if flow is not None:
            fit = make_transport_fitter(
                log_base, log_target, lambda _: flow, transport_steps,
                lambda p: torch.optim.Adam(p, lr=transport_lr), axis=axis)
        return _smc._temperature(compute_next_beta, reweight, tempered,
                                 log_base, log_target, fit)(generator, state)

    step.has_transport = transport_steps > 0
    return step


def make_sharded_smc_step(*args, **kwargs):
    """``build_sharded_smc_step``: JAX caches its compiled step by the
    identity of the densities; nothing is compiled here, so this builds
    anew."""
    return build_sharded_smc_step(*args, **kwargs)


def _temperature(step: Callable, template_fn: Optional[Callable]):
    """``(generator, state) -> (state, info)`` over a sharded step, a fresh
    transport from ``template_fn`` a temperature where it has one."""
    if not getattr(step, "has_transport", False):
        return step
    if template_fn is None:
        raise ValueError("a transport step needs a transport_template_fn")
    return lambda g, state: step(g, state, template_fn(state.particles))


def make_sharded_smc_ladder(step: Callable,
                            transport_template_fn: Optional[Callable] = None):
    """The whole-ladder runner ``(generator, state, max_temps) -> (state,
    temperatures, infos)`` over a sharded step
    (``enflows_tpu/parallel/smc_sharded.py:275-328``), its infos stacked
    into (max_temps,) buffers as JAX's ``lax.while_loop`` ladder returns
    them; the same eager ladder as ``smc_sample_sharded``'s."""
    return _smc._build_ladder(_temperature(step, transport_template_fn),
                              getattr(step, "has_transport", False))


def smc_sample_sharded(log_target: Callable, key: torch.Generator,
                       mesh: Mesh, *, dim: int, num_particles: int = 8192,
                       log_base: Optional[Callable] = None,
                       base_sampler: Optional[Callable] = None,
                       axis_name: str = "chains", mutation_steps: int = 5,
                       leapfrog_steps: int = 10, ess_target: float = 0.5,
                       resample_threshold: float = 0.5,
                       resample_method: str | None = None,
                       initial_step_size: float = 0.2,
                       max_temps: int = 200,
                       transport_template_fn: Optional[Callable] = None,
                       transport_steps: int = 100,
                       transport_lr: float = 5e-2, metrics=None,
                       step: Optional[Callable] = None,
                       in_graph: Optional[bool] = None,
                       dtype=torch.float32):
    """Adaptive tempered SMC with the particles sharded over ``mesh``
    (``enflows_tpu/parallel/smc_sharded.py:331-453``); the semantics of
    ``smc.smc_sample``. Returns this rank's (particles (n_local, dim), log
    weights (n_local,)), the replicated log Z and the list of
    :class:`smc.SMCInfo`.

    Every rank passes the same arguments, ``key`` a generator on the rank's
    device seeded the same. ``base_sampler(generator, n)`` draws the
    global (n, dim) start, of which each rank keeps its block.
    ``transport_template_fn(particles) -> Bijector`` enables learned
    annealing transports (fit data-parallel, ``transport_steps`` Adam
    steps at ``transport_lr``, the counterpart of ``smc_sample(
    fit_transport=make_transport_fitter(...))``); the per-rank particle
    count must then be even. ``step``: a step from
    ``build_sharded_smc_step`` in place of one built from the keywords.
    ``in_graph`` is accepted for JAX's signature: both values run the same
    eager ladder; as in JAX, ``metrics`` needs it None or False."""
    if log_base is None:
        log_base = std_normal_logpdf_sum
        base_sampler = lambda g, n: randn(g, (n, dim), dtype, g.device)
    if base_sampler is None:
        raise ValueError("a custom log_base needs base_sampler")
    axis = mesh.axis(axis_name)
    if num_particles % axis.size:
        raise ValueError(f"num_particles {num_particles} must divide over "
                         f"{axis.size} shards")
    use_transport = transport_template_fn is not None
    if use_transport and (num_particles // axis.size) % 2:
        raise ValueError("learned transports need an even per-shard particle"
                         " count (train/estimation split aligned with the "
                         "single-process path)")
    lo, hi = block_range(num_particles, axis)
    device = key.device
    particles = base_sampler(key, num_particles)[lo:hi].contiguous()
    zero = torch.zeros((), dtype=dtype, device=device)
    state = SMCState(particles=particles,
                     log_weights=torch.zeros(hi - lo, dtype=dtype,
                                             device=device),
                     beta=zero, log_z=zero,
                     step_size=torch.full((), initial_step_size, dtype=dtype,
                                          device=device))
    if step is None:
        step = build_sharded_smc_step(
            log_base, log_target, mesh, axis_name=axis_name,
            mutation_steps=mutation_steps, leapfrog_steps=leapfrog_steps,
            ess_target=ess_target, resample_threshold=resample_threshold,
            resample_method=resample_method,
            transport_steps=transport_steps if use_transport else 0,
            transport_lr=transport_lr)
    elif getattr(step, "has_transport", False) != use_transport:
        raise ValueError("pre-built step's transport mode must match "
                         "transport_template_fn presence")
    use_in_graph = (metrics is None) if in_graph is None else in_graph
    if use_in_graph and metrics is not None:
        raise ValueError(
            "in_graph=True cannot stream metrics (the ladder runs in one "
            "jit); drop metrics= or pass in_graph=False")
    with annotate("enflows.smc.sharded_ladder"):
        state, infos = _smc._run_ladder(
            key, state, max_temps, _temperature(step, transport_template_fn),
            metrics)
    return state.particles, state.log_weights, state.log_z, infos
