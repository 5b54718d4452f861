"""One-call inference: sample -> diagnose.

Counterpart of ``enflows_tpu/infer.py``. Ported routes:

* with ``method='smc'``, the raw target (``precondition=None``) or an
  explicit ``flow=``: tempered SMC (``smc.smc_sample``) over all particles,
  pushed forward through the flow, with weighted moments, log Z and the
  weights' ESS (``infer.py:454-485``);
* with ``method='hmc'``, a target declared as ``mcmc.FlowPushforwardTarget``
  whose whitening chain B6 takes: ``mcmc.fused_flow_hmc_sample`` over that
  chain, each trajectory in one launch of kernel B6, draws directly in data
  space (``infer.py:299-320``);
* with ``method='nuts'``, ``'hmc'`` or ``'chees'``, an explicit ``flow=``
  (whitened -> data): the flow-preconditioned target through
  ``mcmc.sample``, draws pushed back to data space; with
  ``precondition=None`` and no flow, the raw target (a declared
  pushforward with a tree method included).

It also holds the transport templates that ``precondition='auto'`` fits by
ELBO ascent: ``default_flow_template`` and ``coupling_flow_template``
(``enflows_tpu/infer.py:45-114``). Every other route raises
``NotImplementedError`` naming its ROADMAP item: ``precondition='auto'``
without a flow (the VI-fitted transport and its escalation ladder, A.9),
``data=`` (MLE-whitening preconditioner, A.9), ``mesh=`` (A.10) and
``refine_rounds`` (A.9).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .bijectors import (CenterStretch, Householder, JohnsonInv, ScaleShift,
                        coupling_stack, spline_coupling_stack)
from .bijectors.base import Bijector, Chain, compose
from .mcmc import FlowPushforwardTarget, flow_preconditioned, sample
from .mcmc.diagnostics import (_host, bfmi, bulk_ess,
                               rank_normalized_rhat_per_dim, tail_ess)
from .mcmc.fused_hmc import fused_flow_hmc_sample
from .mcmc.sample import _unported
from .smc import smc_sample


class InferenceResult(NamedTuple):
    draws: torch.Tensor       # (chains, steps, dim)
    diagnostics: dict         # host-side scalars/arrays (see summarize_draws)
    stats: Any                # raw sampler stats (SampleStats/FusedHMCStats)
    flow: Optional[Bijector]  # preconditioner used (whitened -> data), if any


def default_flow_template(dim: int, key: torch.Generator,
                          dtype=torch.float32) -> Bijector:
    """Identity-initialized base->data transport
    (``enflows_tpu/infer.py:45-66``): two (CenterStretch, JohnsonInv)
    blocks around a Householder rotation of min(dim, 4) reflections (dim >
    1), with ScaleShifts at both ends. The reflections are drawn from the
    ``torch.Generator`` ``key`` and canonicalized; every module lies on the
    generator's device."""
    device = key.device
    v = lambda val: torch.full((dim,), val, dtype=dtype, device=device)
    tail_block = lambda: (
        CenterStretch(v(0.0), v(1.0), v(0.0)),
        JohnsonInv(v(0.0), v(5.0), v(0.0), v(5.0)),
    )
    stages = [ScaleShift(v(1.0), v(0.0)), *tail_block()]
    if dim > 1:
        V = torch.randn(min(dim, 4), dim, generator=key, dtype=dtype,
                        device=device)
        stages.append(Householder(V).canonicalize())
    stages.extend(tail_block())
    stages.append(ScaleShift(v(1.0), v(0.0)))
    return compose(*stages)


def coupling_flow_template(n_layers: int = 4, hidden=(32, 32), *,
                           tails: bool = True, kind: str = "affine",
                           n_bins: int = 8, bound: float = 5.0):
    """Template factory of a coupling-stack base->data transport
    (``enflows_tpu/infer.py:69-114``): a callable ``(dim, key, dtype)``
    returning, in apply order, a ScaleShift, a JohnsonInv tail expansion
    (``tails``), ``n_layers`` identity-initialized couplings with reversal
    Permutes (``kind`` 'affine', or 'spline' with ``n_bins`` bins on
    [-bound, bound]) and a trailing ScaleShift, on the device of the
    ``torch.Generator`` ``key`` that draws the conditioner weights. Below
    dim 2 it returns ``default_flow_template``."""
    if kind not in ("affine", "spline"):
        raise ValueError(f"kind must be 'affine' or 'spline', got {kind!r}")

    def template(dim: int, key: torch.Generator,
                 dtype=torch.float32) -> Bijector:
        if dim < 2:
            return default_flow_template(dim, key, dtype)
        device = key.device
        v = lambda val: torch.full((dim,), val, dtype=dtype, device=device)
        stages = [ScaleShift(v(1.0), v(0.0))]
        if tails:
            stages.append(JohnsonInv(v(0.0), v(5.0), v(0.0), v(5.0)))
        if kind == "spline":
            stack = spline_coupling_stack(key, dim, n_layers, hidden,
                                          n_bins=n_bins, bound=bound,
                                          dtype=dtype, device=device)
        else:
            stack = coupling_stack(key, dim, n_layers, hidden, dtype=dtype,
                                   device=device)
        stages.extend(stack.stages)
        stages.append(ScaleShift(v(1.0), v(0.0)))
        return Chain.of(*stages)

    return template


def summarize_draws(draws, stats=None) -> dict:
    """Per-dimension convergence summary of (chains, steps, dim) draws.

    Keys: mean, sd, rhat (rank-normalized split-R-hat), bulk_ess, tail_ess,
    min_bulk_ess; plus divergences / accept_prob / bfmi when the sampler
    stats carry them. Computed on the host, in float64.
    """
    x = _host(draws, np.float64)
    dim = x.shape[-1]
    out = {
        "mean": x.reshape(-1, dim).mean(axis=0),
        "sd": x.reshape(-1, dim).std(axis=0),
        "rhat": rank_normalized_rhat_per_dim(x),
        "bulk_ess": np.array([bulk_ess(x[..., d]) for d in range(dim)]),
        "tail_ess": np.array([tail_ess(x[..., d]) for d in range(dim)]),
    }
    out["min_bulk_ess"] = float(out["bulk_ess"].min())
    if stats is not None:
        div = getattr(stats, "divergent", None)
        if div is not None:
            out["divergences"] = int(_host(div).sum())
        acc = getattr(stats, "accept_prob", None)
        if acc is not None:
            out["accept_prob"] = float(_host(acc).mean())
        energy = getattr(stats, "energy", None)
        if energy is not None:
            e = _host(energy)
            if e.ndim == 2 and e.shape[1] > 2:
                out["bfmi"] = bfmi(e)
    return out


def _fused_hmc_accepts(sampler_kw: dict) -> bool:
    """True iff every extra sampler kwarg is understood by
    ``fused_flow_hmc_sample``: declaring a target as FlowPushforwardTarget
    must not turn a valid call into a TypeError; with other kwargs the
    standard path handles the call."""
    accepted = set(inspect.signature(fused_flow_hmc_sample).parameters)
    accepted -= {"chain", "generator", "dim", "num_chains", "num_warmup",
                 "num_samples", "dtype", "base_mean", "base_var", "device"}
    return all(k in accepted for k in sampler_kw)


def _infer_smc(target, pre, flow, gen, dim, default_particles, dtype,
               sampler_kw) -> InferenceResult:
    """``infer``'s SMC route (``enflows_tpu/infer.py:454-485``): the
    particles of ``smc_sample`` on ``target``, pushed forward through the
    preconditioner ``pre`` if any, and their weighted moments."""
    n_particles = sampler_kw.pop("num_particles", default_particles)
    particles, log_w, log_z, infos = smc_sample(
        target, gen, dim=dim, num_particles=n_particles, dtype=dtype,
        **sampler_kw)
    if pre is not None:
        with torch.no_grad():
            particles = pre.push_forward(particles)
    x = _host(particles, np.float64)
    lw = _host(log_w, np.float64)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    mean_w = (w[:, None] * x).sum(axis=0)
    # Clamp the variance radicand: near-degenerate weights can make
    # E[x^2] - E[x]^2 slightly negative in floating point.
    var_w = np.maximum((w[:, None] * x**2).sum(axis=0) - mean_w**2, 0.0)
    diagnostics = {"mean": mean_w, "sd": np.sqrt(var_w),
                   "log_z": float(log_z),
                   "weight_ess": float(1.0 / np.sum(w**2))}
    return InferenceResult(draws=particles, diagnostics=diagnostics,
                           stats=infos, flow=flow)


def infer(logdensity_fn: Callable, *, dim: int, key=None,
          method: str = "nuts", num_chains: int = 16,
          num_warmup: int = 500, num_samples: int = 1000,
          precondition: Optional[str] = "auto",
          flow: Optional[Bijector] = None, data=None,
          refine_rounds: int = 0, mesh=None, dtype=torch.float32,
          device="cuda", **sampler_kw) -> InferenceResult:
    """Sample an unnormalized target density, end to end.

    ``logdensity_fn``: a batched target, (n, dim) -> (n,)
    (``mcmc.per_sample`` adapts a per-sample one), or a
    ``mcmc.FlowPushforwardTarget``. ``key``: the ``torch.Generator`` of every
    draw; its device is where the chains run. Without one, a generator
    seeded 0 on ``device`` (the card unless the caller asks for the CPU).
    ``method``: 'nuts', 'hmc', 'chees' or 'smc'; the sampler's keywords
    (``max_depth=``, ``num_steps=``, ``mutation_steps=``, ...) pass through
    ``sampler_kw``. For 'smc', ``num_chains * num_samples`` is the particle
    count unless ``num_particles`` is passed; the draws are the (n, dim)
    particles, ``stats`` the list of ``smc.SMCInfo``, and the diagnostics
    the weighted ``mean`` and ``sd``, ``log_z`` and ``weight_ess``, on the
    host in float64.

    A target declared as ``FlowPushforwardTarget`` with a chain that B6
    takes runs ``method='hmc'`` through the fused leapfrog kernel, with no
    flow fit (the declared chain is the exact transport). Otherwise ``flow``
    (whitened -> data) preconditions the target, or ``precondition=None``
    samples it raw. Draws are returned in data space.
    """
    if method not in ("nuts", "hmc", "chees", "smc"):
        raise ValueError(f"method must be 'nuts', 'hmc', 'chees' or 'smc', "
                         f"got {method!r}")
    if mesh is not None:
        raise _unported("mesh=", "A.10")
    if data is not None:
        raise _unported("data= (the MLE-whitening preconditioner)", "A.9")
    gen = key if key is not None else \
        torch.Generator(device=device).manual_seed(0)

    # Declared-structure route: the declared chain is the exact transport,
    # and its trajectories run in kernel B6. The sampler draws q with density
    # N(whiten(q)) + ladj_whiten(q) == logdensity_fn(q): data space.
    if (method == "hmc" and isinstance(logdensity_fn, FlowPushforwardTarget)
            and flow is None
            and logdensity_fn.fused_kernel_available(dim, dtype)
            and _fused_hmc_accepts(sampler_kw)):
        draws, _final, stats = fused_flow_hmc_sample(
            logdensity_fn.whiten, gen, dim=dim, num_chains=num_chains,
            num_warmup=num_warmup, num_samples=num_samples, dtype=dtype,
            base_mean=logdensity_fn.base_mean,
            base_var=logdensity_fn.base_var, device=gen.device, **sampler_kw)
        return InferenceResult(draws=draws,
                               diagnostics=summarize_draws(draws, stats),
                               stats=stats, flow=logdensity_fn.transport)

    if flow is None and precondition == "auto":
        raise _unported("precondition='auto' (the VI-fitted transport)",
                        "A.9")
    pre = None if flow is None else flow_preconditioned(logdensity_fn, flow)
    target = logdensity_fn if pre is None else pre.logdensity_fn
    if method == "smc":
        return _infer_smc(target, pre, flow, gen, dim,
                          num_chains * num_samples, dtype, sampler_kw)
    if refine_rounds > 0:
        raise _unported("refine_rounds", "A.9")
    draws, _final, stats = sample(
        target, gen, dim=dim, num_chains=num_chains, num_warmup=num_warmup,
        num_samples=num_samples, algorithm=method, dtype=dtype,
        device=gen.device, **sampler_kw)
    if pre is not None:
        with torch.no_grad():
            draws = pre.push_forward(draws)
    return InferenceResult(draws=draws,
                           diagnostics=summarize_draws(draws, stats),
                           stats=stats, flow=flow)
