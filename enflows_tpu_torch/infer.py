"""One-call inference: precondition -> sample -> diagnose.

Counterpart of ``enflows_tpu/infer.py``, batch-first: targets are batched,
``(n, dim) -> (n,)``, and every draw comes from a ``torch.Generator`` on the
device where the work runs. Routes:

* ``precondition='auto'`` (the default) without a flow: a transport fitted
  by ELBO ascent (``train.optimize_elbo``) along a family ladder judged by
  PSIS k-hat and the inflated-probe coverage gap, with a tempered-SMC
  rescue whitened by a spline stack (``infer.py:338-444``);
* ``data=``: a whitening flow fitted to the data by maximum likelihood
  (``train.optimize_whitening``), its inverse the transport
  (``infer.py:322-335``);
* an explicit ``flow=`` (whitened -> data), or ``precondition=None`` for the
  raw target;
* ``method='nuts'``, ``'hmc'`` or ``'chees'`` through ``mcmc.sample``, or
  ``'smc'`` through ``smc.smc_sample`` (weighted moments, log Z and the
  weights' ESS); ``refine_rounds`` re-fits the whitening transport on each
  round's draws and samples again (``infer.py:502-512``);
* with ``method='hmc'``, a target declared as ``mcmc.FlowPushforwardTarget``
  whose whitening chain B6 takes: ``mcmc.fused_flow_hmc_sample``, each
  trajectory one launch of kernel B6 (``infer.py:299-320``).

On the card the trainers dispatch by the port's rule: the elementwise
template's VI steps run B1 + B2 and the whitening of an inverted elementwise
template B3, at any size; a coupling template (the spline and affine rungs,
the rescue's inverted spline) takes B4 + B5 only at batches of at least
``ops.coupling.COUPLING_MIN_ROWS`` rows and ``COUPLING_MIN_DIM`` wide
(``ops.coupling.coupling_batch_held``, ROADMAP C-3), so at the ladder's
batches of 40-1,024 rows the coupling rungs and the rescue run the plain
path.
``mesh=`` raises ``NotImplementedError`` (ROADMAP A.10).
"""
from __future__ import annotations

import hashlib
import inspect
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .bijectors import (CenterStretch, Householder, JohnsonInv, ScaleShift,
                        coupling_stack, spline_coupling_stack)
from .bijectors.base import Bijector, Chain, compose, invert
from .distributions.base import std_normal_logpdf_sum
from .mcmc import FlowPushforwardTarget, flow_preconditioned, sample
from .mcmc.diagnostics import (_host, bfmi, bulk_ess, pareto_khat,
                               rank_normalized_rhat_per_dim, tail_ess)
from .mcmc.fused_hmc import fused_flow_hmc_sample
from .mcmc.sample import _unported
from .smc import smc_sample
from .train import optimize_elbo, optimize_whitening


_SMC_KEYWORDS = frozenset(inspect.signature(smc_sample).parameters)


class InferenceResult(NamedTuple):
    draws: torch.Tensor       # MCMC: (chains, steps, dim); SMC: (n, dim)
    diagnostics: dict         # host-side scalars/arrays (see summarize_draws)
    stats: Any                # raw sampler stats (SampleStats/.../SMCInfo)
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


# ------------------------------------------------------------------
# Generators of the ladder's roles.

class _Keys:
    """The generators of ``infer``'s roles, derived from the caller's
    generator ``gen`` without advancing it: a role's generator lies on
    ``gen``'s device and is seeded with the first 8 bytes (63 bits) of the
    BLAKE2b hash of ``gen.get_state()`` and the role's path. The paths
    follow JAX's keys (``enflows_tpu/infer.py:295``): ``fit()`` is k_fit,
    ``fit(n)`` is ``fold_in(k_fit, n)`` (the rung's template n, the probes
    101 + i and 201 + i, the rescue 7 and its template 8), ``refine(r)``
    the key of refinement round r. The sampler draws from ``gen``
    itself."""

    def __init__(self, gen: torch.Generator):
        self.device = gen.device
        self._state = gen.get_state().numpy().tobytes()

    def _child(self, *path) -> torch.Generator:
        digest = hashlib.blake2b(
            self._state + repr(path).encode(), digest_size=8).digest()
        seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def fit(self, *fold: int) -> torch.Generator:
        return self._child("fit", *fold)

    def refine(self, rounds: int) -> torch.Generator:
        return self._child("refine", rounds)


def _probe_draws(generator: torch.Generator, n: int, dim: int,
                 dtype) -> torch.Tensor:
    """A probe's (n, dim) standard normals from ``generator``. The one place
    the probes draw, so that a test can hand them another framework's
    draws (``train.vi._base_draws`` is the model)."""
    return torch.randn(n, dim, generator=generator, dtype=dtype,
                       device=generator.device)


def _rescue_resample(generator: torch.Generator,
                     weights: torch.Tensor) -> torch.Tensor:
    """The rescue's multinomial resample: len(weights) indices drawn with
    replacement by the normalized ``weights``, from ``generator``. JAX
    draws them from a fixed ``np.random.default_rng(0)`` whatever its key
    (``enflows_tpu/infer.py:407``, ROADMAP C-4); the port draws from the
    rescue's generator. A test hook, as ``_probe_draws``."""
    return torch.multinomial(weights, weights.numel(), replacement=True,
                             generator=generator)


def _transport_khat(logdensity_fn: Callable, flow: Bijector, dim: int,
                    key: torch.Generator, dtype, n: int = 2048) -> float:
    """PSIS k-hat of the transport fit (``enflows_tpu/infer.py:168-184``):
    z = flow(xi) for n base draws xi from ``key``, importance-weighted
    against the batched target ``logdensity_fn`` and the weight tail fitted
    (``mcmc.diagnostics.pareto_khat``). k-hat > 0.7: q's tail under-covers
    p where q has support; blind to a mode q misses entirely
    (``_transport_coverage_gap`` covers that)."""
    with torch.no_grad():
        xi = _probe_draws(key, n, dim, dtype)
        z, ladj = flow.forward_and_ladj(xi)
        log_q = std_normal_logpdf_sum(xi) - ladj
        return pareto_khat(logdensity_fn(z) - log_q)


def _transport_coverage_gap(logdensity_fn: Callable, flow: Bijector,
                            dim: int, key: torch.Generator, dtype,
                            n: int = 2048, inflate: float = 4.0) -> float:
    """Hard-mode-collapse detector (``enflows_tpu/infer.py:187-211``): probe
    with the pushforward r of the base scaled ``inflate`` x through the same
    flow and return the p-mass-weighted standard deviation of log q - log p
    (self-normalized importance sampling through r), in nats: ~0 where q
    tracks p, large where r reaches a mode q misses (threshold 3.0)."""
    with torch.no_grad():
        xi = _probe_draws(key, n, dim, dtype) * inflate
        z, ladj = flow.forward_and_ladj(xi)
        log_r = (-0.5 * ((xi / inflate) ** 2).sum(-1)
                 - dim * (0.5 * math.log(2 * math.pi) + math.log(inflate))
                 - ladj)
        log_q = std_normal_logpdf_sum(xi) - ladj
        logp = logdensity_fn(z)
        w = torch.softmax(logp - log_r, dim=0)
        # Probe points where the target is -inf (bounded support) carry
        # zero p-mass; mask them rather than evaluating 0 * inf -> NaN.
        ri = torch.where(w > 0.0, log_q - logp, torch.zeros_like(logp))
        mean = (w * ri).sum()
        return float(torch.sqrt((w * (ri - mean) ** 2).sum()))


def _fit_quality(logdensity_fn, flow, dim, keys: _Keys, i: int, dtype):
    """(severity, k-hat, gap) of a fitted transport, its probes from
    ``keys.fit(101 + i)`` and ``keys.fit(201 + i)``. The severity is
    scale-free: 1.0 is the threshold of the worse of the two diagnostics."""
    kh = _transport_khat(logdensity_fn, flow, dim, keys.fit(101 + i), dtype)
    gap = _transport_coverage_gap(logdensity_fn, flow, dim,
                                  keys.fit(201 + i), dtype)
    return max(kh / 0.7, gap / 3.0), kh, gap


def _ladder(precondition_kind: str, flow_template, dim: int) -> list:
    """The families to try, in cost order (``enflows_tpu/infer.py:
    345-364``)."""
    if flow_template is not None:
        return [("custom", flow_template)]
    if precondition_kind == "elementwise" or dim < 2:
        return [("elementwise", default_flow_template)]
    if precondition_kind in ("affine", "spline"):
        return [(precondition_kind,
                 coupling_flow_template(kind=precondition_kind))]
    if precondition_kind == "auto":
        return [("elementwise", default_flow_template),
                ("spline", coupling_flow_template(kind="spline"))]
    raise ValueError(f"precondition_kind must be 'auto'|'elementwise'|"
                     f"'affine'|'spline', got {precondition_kind!r}")


def _whitening_start(template: Bijector) -> Bijector:
    """The identity-initialized whitening flow ``invert(template)`` in JAX's
    parametrization: JAX inverts a ScaleShift into a new ScaleShift(1/a,
    -b/a) whose own leaves the optimizer moves
    (``enflows_tpu/bijectors/scale_shift.py:36``), where the port's inverse
    shares a and b. So each inverted ScaleShift becomes a plain one with
    those values, and a whitening fit takes JAX's steps."""
    white = invert(template)
    if not isinstance(white, Chain):
        return white
    return Chain([ScaleShift(1.0 / s.a.detach(), -s.b.detach() / s.a.detach())
                  if isinstance(s, ScaleShift) and s.inverted else s
                  for s in white.stages])


def _smc_rescue(logdensity_fn, dim, keys: _Keys, dtype, vi_optimizer,
                whiten_batches, whiten_epochs) -> Bijector:
    """The mode-covering rescue (``enflows_tpu/infer.py:391-419``): tempered
    SMC over 4096 particles from ``keys.fit(7)``, a multinomial resample by
    the weights from the same generator, then the inverted spline template
    (``keys.fit(8)``) whitened on those draws; its inverse is the
    transport."""
    gen = keys.fit(7)
    parts, log_w, _log_z, _ = smc_sample(logdensity_fn, gen, dim=dim,
                                         num_particles=4096, dtype=dtype)
    w = torch.exp(log_w.double() - log_w.double().max())
    draws = parts[_rescue_resample(gen, w / w.sum())].to(dtype)
    white = _whitening_start(coupling_flow_template(kind="spline")(
        dim, keys.fit(8), dtype))
    fit = optimize_whitening(draws, white, vi_optimizer,
                             nbatches=whiten_batches, nepochs=whiten_epochs)
    return invert(fit.result)


def _precondition_auto(logdensity_fn, dim, keys: _Keys, method: str,
                       precondition_kind, flow_template, vi_steps, vi_batch,
                       vi_optimizer, whiten_batches, whiten_epochs, dtype):
    """The family ladder (``enflows_tpu/infer.py:338-444``). Each rung fits
    its template (drawn from ``keys.fit(i)``) by ``vi_steps`` ELBO steps of
    ``vi_batch`` antithetic pairs (the VI draws from ``keys.fit()``, the
    same for every rung, as JAX's k_fit) and stops at the first severity
    <= 1.0. If the best is still > 1.0, the ladder has more than one rung
    and the method is not SMC, the SMC rescue runs and replaces the best
    fit when its severity is lower; if it wins for an MCMC method, the
    sampling escalates to SMC on the raw target.

    Returns (flow, diagnostics, method, raw_sampling)."""
    best = None                 # (severity, khat, gap, name, flow)
    ladder = _ladder(precondition_kind, flow_template, dim)
    for i, (name, template_fn) in enumerate(ladder):
        vi = optimize_elbo(logdensity_fn,
                           template_fn(dim, keys.fit(i), dtype),
                           vi_optimizer, dim=dim, batch_size=vi_batch,
                           nsteps=vi_steps, key=keys.fit(), dtype=dtype)
        sev, kh, gap = _fit_quality(logdensity_fn, vi.result, dim, keys, i,
                                    dtype)
        if best is None or sev < best[0]:
            best = (sev, kh, gap, name, vi.result)
        if sev <= 1.0:
            break
    if best[0] > 1.0 and len(ladder) > 1 and method != "smc":
        rescue = _smc_rescue(logdensity_fn, dim, keys, dtype, vi_optimizer,
                             whiten_batches, whiten_epochs)
        sev, kh, gap = _fit_quality(logdensity_fn, rescue, dim, keys, 9,
                                    dtype)
        if sev < best[0]:
            best = (sev, kh, gap, "smc+spline-whitening", rescue)
    diag = {"precondition_family": best[3],
            "precondition_khat": float(best[1]),
            "precondition_coverage_gap": float(best[2])}
    raw_sampling = False
    if best[3] == "smc+spline-whitening" and method in ("nuts", "hmc",
                                                        "chees"):
        # A continuous bijection bridges the modes through low-density
        # base-space regions that HMC-family chains do not cross, so the
        # final sampling runs tempered SMC on the raw target; the fitted
        # transport is still returned (enflows_tpu/infer.py:424-444).
        diag["method_escalated_to"] = "smc"
        method, raw_sampling = "smc", True
    return best[4], diag, method, raw_sampling


def _whitening_transport(data, dim, keys: _Keys, flow_template,
                         vi_optimizer, whiten_batches, whiten_epochs,
                         dtype) -> Bijector:
    """``data=``'s transport (``enflows_tpu/infer.py:322-335``): the template
    (drawn from ``keys.fit()``) inverted is an identity-initialized
    whitening flow; it is fitted to ``data`` by ``optimize_whitening`` and
    its inverse, sharing its parameters, is the transport."""
    white = _whitening_start((flow_template or default_flow_template)(
        dim, keys.fit(), dtype))
    x = torch.as_tensor(data).to(device=keys.device, dtype=dtype)
    fit = optimize_whitening(x, white, vi_optimizer, nbatches=whiten_batches,
                             nepochs=whiten_epochs)
    return invert(fit.result)


def _infer_smc(target, pre, flow, gen, dim, default_particles, dtype,
               sampler_kw, pre_diag) -> InferenceResult:
    """``infer``'s SMC route (``enflows_tpu/infer.py:454-485``): the
    particles of ``smc_sample`` on ``target``, pushed forward through the
    preconditioner ``pre`` if any, and their weighted moments, with the
    ladder's diagnostics ``pre_diag``."""
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
                   "weight_ess": float(1.0 / np.sum(w**2)), **pre_diag}
    return InferenceResult(draws=particles, diagnostics=diagnostics,
                           stats=infos, flow=flow)


def infer(logdensity_fn: Callable, *, dim: int, key=None,
          method: str = "nuts", num_chains: int = 16,
          num_warmup: int = 500, num_samples: int = 1000,
          precondition: Optional[str] = "auto",
          precondition_kind: str = "auto",
          flow: Optional[Bijector] = None, data=None,
          flow_template: Optional[Callable] = None,
          vi_steps: int = 500, vi_batch: int = 512, vi_optimizer=None,
          whiten_batches: int = 100, whiten_epochs: int = 10,
          refine_rounds: int = 0, mesh=None, dtype=torch.float32,
          device="cuda", **sampler_kw) -> InferenceResult:
    """Sample an unnormalized target density, end to end
    (``enflows_tpu/infer.py:214-517``, the same keywords and defaults).

    ``logdensity_fn``: a batched target, (n, dim) -> (n,)
    (``mcmc.per_sample`` adapts a per-sample one), or a
    ``mcmc.FlowPushforwardTarget``. ``key``: the ``torch.Generator`` of every
    draw; its device is where the fits and the chains run. Without one, a
    generator seeded 0 on ``device`` (the card unless the caller asks for
    the CPU). The sampler draws from ``key`` itself; the fits, probes and
    rescue from generators derived from its state (``_Keys``), which is
    read, not advanced. ``method``: 'nuts', 'hmc', 'chees' or 'smc'; the
    sampler's keywords (``max_depth=``, ``num_steps=``,
    ``mutation_steps=``, ...) pass through ``sampler_kw``. For 'smc',
    ``num_chains * num_samples`` is the particle count unless
    ``num_particles`` is passed; the draws are the (n, dim) particles,
    ``stats`` the list of ``smc.SMCInfo``, and the diagnostics the weighted
    ``mean`` and ``sd``, ``log_z`` and ``weight_ess``, on the host in
    float64.

    A target declared as ``FlowPushforwardTarget`` with a chain that B6
    takes runs ``method='hmc'`` through the fused leapfrog kernel, with no
    flow fit. Otherwise the transport (whitened -> data) is ``flow`` as
    given; else, with ``data=`` ((n, dim) draws from or near the target),
    the inverse of the template (``flow_template`` or
    ``default_flow_template``) inverted and whitened on the data by
    ``optimize_whitening`` (``whiten_batches`` batches, ``whiten_epochs``
    epochs, mode-covering); else, with ``precondition='auto'``, a
    transport fitted by ``optimize_elbo`` (``vi_steps`` steps of
    ``vi_batch`` antithetic pairs) along the family ladder:
    ``precondition_kind`` 'elementwise' (``default_flow_template``),
    'affine' or 'spline' (``coupling_flow_template``) pins one family,
    'auto' tries elementwise, then spline; a ``flow_template`` pins the
    ladder to itself, and dim < 2 to the elementwise family. Each fit is
    judged by PSIS k-hat (<= 0.7) and the coverage gap (<= 3.0 nats); if
    every rung of a longer ladder fails and the method is not SMC, a
    tempered-SMC rescue whitens a spline stack on 4096 resampled
    particles, and if it wins for an MCMC method the sampling escalates to
    SMC on the raw target (the transport still returned), with those of
    the sampler's keywords that ``smc_sample`` takes. The diagnostics
    then carry ``precondition_family``, ``precondition_khat``,
    ``precondition_coverage_gap`` and, on escalation,
    ``method_escalated_to``. ``vi_optimizer``: an optimizer factory for
    both trainers; None gives each its own default. ``data=`` is ignored
    under ``flow=`` or ``precondition=None``. ``precondition=None``
    samples the raw target. Draws are returned in data space.

    ``refine_rounds=N`` (MCMC methods): after sampling, call ``infer`` again
    with ``data=`` the round's draws, ``key`` the round's derived generator
    and the same keywords, N times; JAX's recursion drops
    ``vi_optimizer``, the port passes it on.
    """
    if method not in ("nuts", "hmc", "chees", "smc"):
        raise ValueError(f"method must be 'nuts', 'hmc', 'chees' or 'smc', "
                         f"got {method!r}")
    if mesh is not None:
        raise _unported("mesh=", "A.10")
    gen = key if key is not None else \
        torch.Generator(device=device).manual_seed(0)
    keys = _Keys(gen)

    # Declared-structure route: the declared chain is the exact transport,
    # and its trajectories run in kernel B6. The sampler draws q with density
    # N(whiten(q)) + ladj_whiten(q) == logdensity_fn(q): data space.
    if (method == "hmc" and isinstance(logdensity_fn, FlowPushforwardTarget)
            and flow is None and data is None
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

    used_flow, pre_diag, raw_sampling = flow, {}, False
    if used_flow is None and data is not None and precondition is not None:
        used_flow = _whitening_transport(data, dim, keys, flow_template,
                                         vi_optimizer, whiten_batches,
                                         whiten_epochs, dtype)
    if used_flow is None and precondition == "auto":
        used_flow, pre_diag, method, raw_sampling = _precondition_auto(
            logdensity_fn, dim, keys, method, precondition_kind,
            flow_template, vi_steps, vi_batch, vi_optimizer, whiten_batches,
            whiten_epochs, dtype)

    sampling_flow = None if raw_sampling else used_flow
    pre = None if sampling_flow is None else \
        flow_preconditioned(logdensity_fn, sampling_flow)
    target = logdensity_fn if pre is None else pre.logdensity_fn
    if raw_sampling:
        # The caller's keywords were for the MCMC method; SMC takes those
        # it knows (JAX passes all, a TypeError for NUTS's max_depth=).
        sampler_kw = {k: v for k, v in sampler_kw.items()
                      if k in _SMC_KEYWORDS}
    if method == "smc":
        return _infer_smc(target, pre, used_flow, gen, dim,
                          num_chains * num_samples, dtype, sampler_kw,
                          pre_diag)
    draws, _final, stats = sample(
        target, gen, dim=dim, num_chains=num_chains, num_warmup=num_warmup,
        num_samples=num_samples, algorithm=method, dtype=dtype,
        device=gen.device, **sampler_kw)
    if pre is not None:
        with torch.no_grad():
            draws = pre.push_forward(draws)

    if refine_rounds > 0:
        return infer(logdensity_fn, dim=dim, key=keys.refine(refine_rounds),
                     method=method, num_chains=num_chains,
                     num_warmup=num_warmup, num_samples=num_samples,
                     data=draws.reshape(-1, dim), flow_template=flow_template,
                     vi_optimizer=vi_optimizer,
                     whiten_batches=whiten_batches,
                     whiten_epochs=whiten_epochs,
                     refine_rounds=refine_rounds - 1, dtype=dtype,
                     **sampler_kw)

    diagnostics = summarize_draws(draws, stats)
    diagnostics.update(pre_diag)
    return InferenceResult(draws=draws, diagnostics=diagnostics,
                           stats=stats, flow=used_flow)
