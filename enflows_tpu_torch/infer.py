"""One-call inference: sample -> diagnose.

Counterpart of ``enflows_tpu/infer.py``. Ported routes, all ``method='hmc'``:

* a target declared as ``mcmc.FlowPushforwardTarget`` whose whitening chain
  B6 takes: ``mcmc.fused_flow_hmc_sample`` over that chain, each trajectory
  in one launch of kernel B6, draws directly in data space
  (``infer.py:299-320``);
* an explicit ``flow=`` (whitened -> data): the flow-preconditioned target
  through ``mcmc.sample``, draws pushed back to data space; with
  ``precondition=None`` and no flow, the raw target.

Every other route raises ``NotImplementedError`` naming its ROADMAP item:
``precondition='auto'`` without a flow (the VI-fitted transport and its
escalation ladder, A.6 and A.9), ``data=`` (MLE-whitening preconditioner,
A.9), ``method='nuts'``/``'chees'`` (A.7), ``'smc'`` (A.8), ``mesh=``
(A.10) and ``refine_rounds`` (A.9).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .bijectors.base import Bijector
from .mcmc import FlowPushforwardTarget, flow_preconditioned, sample
from .mcmc.diagnostics import (_host, bfmi, bulk_ess,
                               rank_normalized_rhat_per_dim, tail_ess)
from .mcmc.fused_hmc import fused_flow_hmc_sample
from .mcmc.sample import _unported


class InferenceResult(NamedTuple):
    draws: torch.Tensor       # (chains, steps, dim)
    diagnostics: dict         # host-side scalars/arrays (see summarize_draws)
    stats: Any                # raw sampler stats (SampleStats/FusedHMCStats)
    flow: Optional[Bijector]  # preconditioner used (whitened -> data), if any


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
    ``method``: 'hmc' ('nuts', 'chees' and 'smc' are not ported yet).

    A target declared as ``FlowPushforwardTarget`` with a chain that B6
    takes runs ``method='hmc'`` through the fused leapfrog kernel, with no
    flow fit (the declared chain is the exact transport). Otherwise ``flow``
    (whitened -> data) preconditions the target, or ``precondition=None``
    samples it raw. Draws are returned in data space.
    """
    if method in ("nuts", "chees"):
        raise _unported(f"method={method!r}", "A.7")
    if method == "smc":
        raise _unported("method='smc'", "A.8")
    if method != "hmc":
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
    if (isinstance(logdensity_fn, FlowPushforwardTarget) and flow is None
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

    if refine_rounds > 0:
        raise _unported("refine_rounds", "A.9")
    if flow is None and precondition == "auto":
        raise _unported("precondition='auto' (the VI-fitted transport)",
                        "A.6 and A.9")
    pre = None if flow is None else flow_preconditioned(logdensity_fn, flow)
    target = logdensity_fn if pre is None else pre.logdensity_fn
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
