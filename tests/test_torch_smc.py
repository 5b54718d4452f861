"""The port's tempered SMC (``enflows_tpu_torch/smc/``) against the JAX
package, on the CPU in float64.

The deterministic pieces are held to the JAX functions on the same numpy
inputs: ``log_ess`` and ``compute_next_beta`` to 1e-12, systematic
resampling to identical indices given JAX's uniform. One
``reweight_resample_mutate`` step, the transport fitter and whole short
ladders are held to JAX given JAX's own draws, rebuilt from its keys by its
own splits (``split(key, 3)`` a temperature, ``split(k_t)`` into the
resampling and mutation keys, ``fold_in(k_mut, t)`` split into one key a
particle, each split into the momentum's and the acceptance's) and handed
to the port through its draw hooks (``smc.smc._resample_uniform``,
``smc.smc._mutation_draws``): one step to 1e-10, the fitter to 1e-8, a
ladder's betas and log Z to 1e-8. Random streams cannot match between the
frameworks otherwise, so the sampler is also held to the statistical gates
of tests/test_smc.py and tests/test_infer.py with the port's own
generators.
"""
import importlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu import smc as JS
from enflows_tpu.distributions import std_normal_logpdf_sum as j_std

import enflows_tpu_torch as et
from enflows_tpu_torch import smc as TSM
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.smc import flow_transport as TF
from enflows_tpu_torch.smc import smc as TS
from enflows_tpu_torch.train import vi as VI

TI = importlib.import_module("enflows_tpu_torch.infer")

torch.set_num_threads(1)

DT = jnp.float64
T64 = torch.float64
t_std = et.std_normal_logpdf_sum


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


# Targets: one formula, written for each framework (JAX per sample, the
# port batched).
MU3 = np.array([1.0, -0.5, 2.0])
PREC3 = np.linalg.inv(np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3],
                                [0.0, 0.3, 0.5]]))


def _jgauss3(q):
    d = q - jnp.asarray(MU3)
    return -0.5 * d @ jnp.asarray(PREC3) @ d


def _tgauss3(q):
    d = q - _t(MU3)
    return -0.5 * ((d @ _t(PREC3)) * d).sum(-1)


def _jmix(q):
    a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.3)
    b = -0.5 * jnp.sum((q + 1.0) ** 2 / 0.5) + jnp.log(0.7)
    return jnp.logaddexp(a, b)


def _tmix(q):
    a = -0.5 * ((q - 1.5) ** 2).sum(-1) + math.log(0.3)
    b = -0.5 * ((q + 1.0) ** 2 / 0.5).sum(-1) + math.log(0.7)
    return torch.logaddexp(a, b)


MU2 = np.array([2.0, -1.0])


def _jgauss2(q):
    d = q - jnp.asarray(MU2)
    return -0.5 * jnp.sum(d * d) / 0.5


def _tgauss2(q):
    d = q - _t(MU2)
    return -0.5 * (d * d).sum(-1) / 0.5


def _jstate(x, lw, beta, log_z=0.0, step_size=0.3):
    return JS.SMCState(particles=jnp.asarray(x), log_weights=jnp.asarray(lw),
                       beta=jnp.asarray(beta, DT), log_z=jnp.asarray(
                           log_z, DT), step_size=jnp.asarray(step_size, DT))


def _tstate(x, lw, beta, log_z=0.0, step_size=0.3):
    return TS.SMCState(particles=_t(x), log_weights=_t(lw),
                       beta=torch.tensor(beta, dtype=T64),
                       log_z=torch.tensor(log_z, dtype=T64),
                       step_size=torch.tensor(step_size, dtype=T64))


# ------------------------------------------------------------------
# JAX's draws, rebuilt from its keys.

_DRAWS = {}


def _jax_step_draws(k_t, n, d, mutation_steps):
    """The draws of one JAX ``step(k_t, ...)``: the resampling uniform, then
    per mutation transition every particle's momentum normals (n, d) and
    acceptance uniform (n,)."""
    if (n, d, mutation_steps) not in _DRAWS:
        def draws(k_t):
            k_res, k_mut = jax.random.split(k_t)
            u0 = jax.random.uniform(k_res, (), DT)

            def one(key):
                key_mom, key_acc = jax.random.split(key)
                return (jax.random.normal(key_mom, (d,), DT),
                        jax.random.uniform(key_acc, (), DT))

            per = [jax.vmap(one)(jax.random.split(
                jax.random.fold_in(k_mut, t), n))
                for t in range(mutation_steps)]
            return u0, [p[0] for p in per], [p[1] for p in per]

        _DRAWS[n, d, mutation_steps] = jax.jit(draws)
    u0, noise, u = _DRAWS[n, d, mutation_steps](k_t)
    return float(u0), list(zip(map(_t, noise), map(_t, u)))


class _InjectedDraws:
    """The port's draw hooks fed with JAX's draws: ``step(k_t)`` queues one
    step's; ``ladder(key)`` makes each resampling call start the next
    temperature, ``key, k_t, k_f = split(key, 3)``, as JAX's host ladder
    does."""

    def __init__(self, monkeypatch, n, d, mutation_steps):
        self.shape = (n, d, mutation_steps)
        self.key = None
        self.queue = []
        self.u0 = None
        monkeypatch.setattr(TS, "_resample_uniform", self._uniform)
        monkeypatch.setattr(TS, "_mutation_draws", self._mutation)

    def step(self, k_t):
        self.u0, self.queue = _jax_step_draws(k_t, *self.shape)

    def ladder(self, key):
        self.key = key

    def _uniform(self, generator, dtype, device):
        if self.key is not None:
            self.key, k_t, _ = jax.random.split(self.key, 3)
            self.step(k_t)
        u0, self.u0 = self.u0, None
        assert u0 is not None, "one resampling uniform a step"
        return torch.tensor(u0, dtype=dtype, device=device)

    def _mutation(self, generator, q):
        noise, u = self.queue.pop(0)
        assert noise.shape == q.shape
        return noise, u


# ------------------------------------------------------------------
# The building blocks.

def test_exports_every_name_of_the_jax_package():
    assert set(TSM.__all__) == set(JS.__all__)
    for name in JS.__all__:
        assert hasattr(TSM, name), name


def test_log_ess_matches_jax():
    rng = np.random.default_rng(0)
    for lw in (rng.normal(size=300) * 3.0,
               np.concatenate([rng.normal(size=50), np.full(20, -np.inf)]),
               np.array([0.0] + [-np.inf] * 99),
               np.zeros(17)):
        _close(TS.log_ess(_t(lw)), JS.log_ess(jnp.asarray(lw)), 1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_matches_jax_given_its_uniform(seed,
                                                           monkeypatch):
    n = 4096
    rng = np.random.default_rng(seed)
    lw = rng.normal(size=n) * (1.0 + seed)
    lw[rng.integers(0, n, 40)] = -np.inf
    particles = np.arange(n, dtype=np.float64)[:, None]
    key = jax.random.PRNGKey(seed)
    got_j = JS.systematic_resample(key, jnp.asarray(lw),
                                   jnp.asarray(particles))
    u0 = float(jax.random.uniform(key, (), DT))
    monkeypatch.setattr(TS, "_resample_uniform",
                        lambda g, dtype, device: torch.tensor(u0, dtype=dtype))
    got_t = TS.systematic_resample(None, _t(lw), _t(particles))
    np.testing.assert_array_equal(_np(got_t), np.asarray(got_j))


BETA_CASES = {
    # target close to the base: the full step to beta = 1 meets the ESS
    "full_step": (lambda q: -0.5 * jnp.sum((q - 0.05) ** 2),
                  lambda q: -0.5 * ((q - 0.05) ** 2).sum(-1), 0.0, 0.0),
    "interior": (_jmix, _tmix, 0.3, 0.0),
    "weighted": (_jgauss3, _tgauss3, 0.55, 0.4),
}


@pytest.mark.parametrize("case", sorted(BETA_CASES))
def test_compute_next_beta_matches_jax(case):
    jt, tt, beta, spread = BETA_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 3)) * 1.3
    lw = rng.normal(size=512) * spread
    b_j = JS.make_compute_next_beta(j_std, jt)(_jstate(x, lw, beta))
    b_t = TS.make_compute_next_beta(t_std, tt)(_tstate(x, lw, beta))
    _close(b_t, b_j, 1e-12)
    assert (float(b_j) == 1.0) == (case == "full_step")
    assert beta < float(b_j) <= 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_next_beta_bisects_as_many_times_as_jax_may(dtype):
    """The masked loop's fixed count covers JAX's stopping rule: from any
    bracket [beta, 1] the float32 and float64 bisection stops within 21
    halvings, whichever way each halving goes."""
    rng = np.random.default_rng(0)
    ways = [lambda it: True, lambda it: False, lambda it: it % 2 == 1,
            *(lambda it, r=rng.random(60): r[it] < 0.5 for _ in range(20))]
    for beta in (0.0, 1e-7, 0.3, 0.5, 0.999, 1.0 - 3e-6):
        for ok in ways:
            lo, hi, it = dtype(beta), dtype(1.0), 0
            while it < 60 and hi - lo > dtype(1e-6):
                mid = dtype(0.5) * (lo + hi)
                lo, hi = (mid, hi) if ok(it) else (lo, mid)
                it += 1
            assert it <= 21 < TS._HALVINGS, (beta, it)


@pytest.mark.parametrize("holdout", [False, True])
@pytest.mark.parametrize("resample", [False, True])
def test_reweight_resample_mutate_matches_jax(holdout, resample,
                                              monkeypatch):
    n, d, msteps, lsteps = 64, 3, 3, 5
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, d)) * 1.5
    lw = rng.normal(size=n) * 0.3
    beta, beta_new = 0.35, 0.5
    lp1 = np.asarray(jax.vmap(_jgauss3)(jnp.asarray(x)))
    lp0 = np.asarray(jax.vmap(j_std)(jnp.asarray(x)))
    lw_inc = (beta_new - beta) * (lp1 - lp0) * (1.0 if resample else 0.05)
    kw = dict(mutation_steps=msteps, leapfrog_steps=lsteps,
              holdout_logz=holdout)
    k_t = jax.random.PRNGKey(11)
    new_j, info_j = JS.make_reweight_resample_mutate(j_std, _jgauss3, **kw)(
        k_t, _jstate(x, lw, beta, 0.2, 0.4), jnp.asarray(beta_new, DT),
        jnp.asarray(lw_inc))
    assert bool(info_j.resampled) == resample

    draws = _InjectedDraws(monkeypatch, n, d, msteps)
    draws.step(k_t)
    new_t, info_t = TS.make_reweight_resample_mutate(t_std, _tgauss3, **kw)(
        None, _tstate(x, lw, beta, 0.2, 0.4),
        torch.tensor(beta_new, dtype=T64), _t(lw_inc))
    assert not draws.queue
    for f in TS.SMCState._fields:
        _close(getattr(new_t, f), getattr(new_j, f), 1e-10, f)
    for f in TS.SMCInfo._fields:
        _close(getattr(info_t, f), getattr(info_j, f), 1e-10, f)


def test_transport_fitter_matches_jax():
    """The fitted ScaleShift and the loss of every Adam step against JAX's
    jitted fit (reached through the fitter's closure; the JAX fitter
    returns only the flow)."""
    n, d, nsteps = 256, 3, 40
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)) * 1.2 + 0.3
    lw = rng.normal(size=n)
    fit_j = inspect.getclosurevars(JS.make_transport_fitter(
        j_std, _jmix, nsteps=nsteps)).nonlocals["fit"]
    flow_j, loss_j = fit_j(jnp.asarray(x), jnp.asarray(lw),
                           jnp.asarray(0.6, DT),
                           JS.default_template(jnp.asarray(x)))
    flow_t, loss_t = TF._fit(t_std, _tmix, TF.default_optimizer, nsteps,
                             _t(x), _t(lw), torch.tensor(0.6, dtype=T64),
                             TF.default_template(_t(x)))
    _close(loss_t, loss_j, 1e-8, "loss history")
    ref = from_jax(flow_j, device="cpu")
    _close(flow_t.a, ref.a, 1e-8, "a")
    _close(flow_t.b, ref.b, 1e-8, "b")
    assert float(loss_j[-1]) < float(loss_j[0])
    # The public fitter returns the same flow from a fresh template.
    again = TSM.make_transport_fitter(t_std, _tmix, nsteps=nsteps)(
        None, _t(x), _t(lw), torch.tensor(0.1, dtype=T64),
        torch.tensor(0.6, dtype=T64))
    assert torch.equal(again.a, flow_t.a) and torch.equal(again.b, flow_t.b)


@pytest.mark.parametrize("transport", [False, True])
def test_ladder_matches_jax_host_loop(transport, monkeypatch):
    """A whole short ladder with every draw injected against JAX's
    host-loop ``smc_sample(in_graph=False)``: the same temperatures, betas
    and log Z to 1e-8."""
    n, d, msteps = 2048, 2, 5
    key = jax.random.PRNGKey(9)
    fit_j = JS.make_transport_fitter(j_std, _jgauss2, nsteps=40) \
        if transport else None
    parts_j, lw_j, lz_j, inf_j = JS.smc_sample(
        _jgauss2, key, dim=d, num_particles=n, fit_transport=fit_j,
        in_graph=False, dtype=DT)

    key_l, k0 = jax.random.split(key)
    x0 = _t(jax.random.normal(k0, (n, d), DT))
    draws = _InjectedDraws(monkeypatch, n, d, msteps)
    draws.ladder(key_l)
    fit_t = TSM.make_transport_fitter(t_std, _tgauss2, nsteps=40) \
        if transport else None
    parts_t, lw_t, lz_t, inf_t = TSM.smc_sample(
        _tgauss2, torch.Generator().manual_seed(0), dim=d, num_particles=n,
        log_base=t_std, base_sampler=lambda g, m: x0.clone(),
        fit_transport=fit_t, dtype=T64)
    assert len(inf_t) == len(inf_j) > 2
    _close([float(i.beta) for i in inf_t], [float(i.beta) for i in inf_j],
           1e-8, "betas")
    _close([float(i.log_z) for i in inf_t], [float(i.log_z) for i in inf_j],
           1e-8, "log Z")
    _close(lz_t, lz_j, 1e-8)
    _close(lw_t, lw_j, 1e-8)
    _close(parts_t, parts_j, 1e-8)


# ------------------------------------------------------------------
# The counterparts of tests/test_smc.py, with the port's own generators.

def _weighted(parts, lw):
    w = _np(torch.softmax(lw, 0))
    p = _np(parts)
    m = (w[:, None] * p).sum(0)
    return w, p, m, (w[:, None] * (p - m) ** 2).sum(0)


def test_systematic_resample_statistics():
    n = 10000
    particles = torch.arange(n, dtype=T64)[:, None]
    logw = torch.log(_t(np.concatenate([np.full(n // 2, 3.0),
                                        np.full(n // 2, 1.0)])))
    out = TSM.systematic_resample(torch.Generator().manual_seed(0), logw,
                                  particles)
    # 3:1 weights -> 75% of offspring from the first half.
    frac = float((out[:, 0] < n // 2).double().mean())
    assert abs(frac - 0.75) < 0.01
    # Systematic resampling: offspring counts within +-1 of expectation.
    _, counts = np.unique(_np(out[:, 0]), return_counts=True)
    assert counts.max() <= 3


def test_log_ess():
    np.testing.assert_allclose(float(torch.exp(TSM.log_ess(
        torch.zeros(100, dtype=T64)))), 100.0, rtol=1e-10)
    lw2 = torch.tensor([0.0] + [-math.inf] * 99, dtype=T64)
    np.testing.assert_allclose(float(torch.exp(TSM.log_ess(lw2))), 1.0,
                               rtol=1e-10)


MU = torch.tensor([3.0, -2.0], dtype=T64)


def _gauss_target(q):
    d = q - MU.to(q)
    return -0.5 * (d * d).sum(-1) / 0.25


def test_smc_gaussian_logz_and_moments():
    s = 0.5
    true_logz = 2 * 0.5 * np.log(2 * np.pi * s**2)
    parts, lw, logz, infos = TSM.smc_sample(
        _gauss_target, torch.Generator().manual_seed(0), dim=2,
        num_particles=4096, dtype=T64)
    assert float(infos[-1].beta) == 1.0
    assert len(infos) < 30
    _, _, m, var = _weighted(parts, lw)
    np.testing.assert_allclose(m, _np(MU), atol=0.08)
    np.testing.assert_allclose(var, s**2, rtol=0.2)
    assert abs(float(logz) - true_logz) < 0.15


def test_smc_multimodal_mass_balance():
    # Two well-separated modes with 70/30 mass: tempering + resampling must
    # preserve the balance (a plain MCMC chain cannot cross).
    def log_target(q):
        a = -0.5 * ((q - 4.0) ** 2).sum(-1) / 0.25 + math.log(0.7)
        b = -0.5 * ((q + 4.0) ** 2).sum(-1) / 0.25 + math.log(0.3)
        return torch.logaddexp(a, b)

    parts, lw, logz, infos = TSM.smc_sample(
        log_target, torch.Generator().manual_seed(1), dim=2,
        num_particles=8192, dtype=T64)
    w, p, _, _ = _weighted(parts, lw)
    frac = float((w * (p[:, 0] > 0)).sum())
    assert abs(frac - 0.7) < 0.06, frac
    assert abs(float(logz) - np.log(2 * np.pi * 0.25)) < 0.2


def test_learned_transport_reduces_temperatures():
    s = 0.5
    fit = TSM.make_transport_fitter(t_std, _gauss_target, nsteps=80)
    p1, lw1, lz1, inf1 = TSM.smc_sample(
        _gauss_target, torch.Generator().manual_seed(0), dim=2,
        num_particles=4096, dtype=T64)
    p2, lw2, lz2, inf2 = TSM.smc_sample(
        _gauss_target, torch.Generator().manual_seed(0), dim=2,
        num_particles=4096, fit_transport=fit, dtype=T64)
    assert len(inf2) < len(inf1)
    true_logz = np.log(2 * np.pi * s**2)
    # Transport-corrected logZ is the sharper estimate.
    assert abs(float(lz2) - true_logz) < 0.1
    _, _, m2, _ = _weighted(p2, lw2)
    np.testing.assert_allclose(m2, _np(MU), atol=0.05)


def test_smc_higher_dim_mixture():
    # Reduced-scale version of the BASELINE.json 100D multimodal config:
    # 16D, two modes.
    dim = 16

    def log_target(q):
        a = -0.5 * ((q - 2.0) ** 2).sum(-1) + math.log(0.5)
        b = -0.5 * ((q + 2.0) ** 2).sum(-1) + math.log(0.5)
        return torch.logaddexp(a, b)

    parts, lw, logz, infos = TSM.smc_sample(
        log_target, torch.Generator().manual_seed(2), dim=dim,
        num_particles=8192, mutation_steps=8, dtype=T64)
    w, p, _, _ = _weighted(parts, lw)
    frac = float((w * (p[:, 0] > 0)).sum())
    assert 0.25 < frac < 0.75, frac  # both modes retain mass
    true_logz = dim * 0.5 * np.log(2 * np.pi)
    assert abs(float(logz) - true_logz) < 0.8


def test_smc_anisotropic_mass_adaptation():
    # 400:1 scale ratios: ensemble mass matrix must keep mutations mixing
    # (marginal stds within a few % and acceptance near target).
    scales = torch.tensor([0.05, 0.1, 1.0, 5.0, 20.0], dtype=T64)

    def log_target(q):
        return -0.5 * ((q / scales) ** 2).sum(-1)

    parts, lw, logz, infos = TSM.smc_sample(
        log_target, torch.Generator().manual_seed(5), dim=5,
        num_particles=8192, mutation_steps=6, dtype=T64)
    _, _, _, v = _weighted(parts, lw)
    np.testing.assert_allclose(np.sqrt(v), _np(scales), rtol=0.1)
    true_logz = float(torch.log(scales).sum()) + 5 * 0.5 * np.log(2 * np.pi)
    assert abs(float(logz) - true_logz) < 0.2
    # Acceptance settled near the 0.65 target after the first few temps.
    accs = [float(i.accept_prob) for i in infos[3:]]
    assert all(0.5 < a < 0.85 for a in accs), accs


def test_build_smc_kernels_explicit_reuse():
    """Explicit kernel set: fresh-closure targets reuse one kernel set
    across smc_sample calls."""
    def fresh_target():           # new closure identity each call
        return lambda q: -0.5 * ((q - 1.0) ** 2).sum(-1)

    kern = TSM.build_smc_kernels(t_std, fresh_target())
    results = []
    for seed in range(2):
        parts, lw, logz, infos = TSM.smc_sample(
            fresh_target(), torch.Generator().manual_seed(seed), dim=2,
            num_particles=2048, kernels=kern, dtype=T64)
        results.append(float(logz))
    # Correct evidence: target is an unnormalized N(1, I) in 2D.
    true_logz = 2 * 0.5 * np.log(2 * np.pi)
    for lz in results:
        assert abs(lz - true_logz) < 0.1


def _same_runs(a, b):
    (p1, lw1, lz1, inf1), (p2, lw2, lz2, inf2) = a, b
    assert len(inf1) == len(inf2)
    for i1, i2 in zip(inf1, inf2):
        for v1, v2 in zip(i1, i2):
            assert torch.equal(v1, v2)
    for v1, v2 in ((p1, p2), (lw1, lw2), (lz1, lz2)):
        assert torch.equal(v1, v2)


def test_in_graph_ladder_matches_host_loop():
    """Both ``in_graph`` values run the same eager ladder: identical
    results, also through the ladder of ``build_smc_kernels``."""
    def log_target(q):
        d = q - torch.tensor([1.0, -2.0], dtype=T64)
        return -0.5 * (d * d).sum(-1) / 0.25

    kern = TSM.build_smc_kernels(t_std, log_target)
    runs = [TSM.smc_sample(log_target, torch.Generator().manual_seed(7),
                           dim=2, num_particles=2048, in_graph=mode,
                           dtype=T64, **kw)
            for mode in (True, False) for kw in ({}, {"kernels": kern})]
    for other in runs[1:]:
        _same_runs(runs[0], other)
    assert float(runs[0][3][-1].beta) == 1.0


def test_in_graph_ladder_with_transport_matches_host_loop():
    def log_target(q):
        d = q - torch.tensor([2.0, -1.0], dtype=T64)
        return -0.5 * (d * d).sum(-1) / 0.5

    fit = TSM.make_transport_fitter(t_std, log_target, nsteps=40)
    kern = TSM.build_smc_kernels(t_std, log_target, fit_transport=fit)
    assert kern.holdout_logz and kern.ladder.has_transport
    runs = [TSM.smc_sample(log_target, torch.Generator().manual_seed(9),
                           dim=2, num_particles=2048, fit_transport=fit,
                           in_graph=mode, dtype=T64, **kw)
            for mode, kw in ((True, {"kernels": kern}), (False, {}),
                             (True, {}))]
    for other in runs[1:]:
        _same_runs(runs[0], other)


# ------------------------------------------------------------------
# Checks, routes and devices.

def test_keyword_checks():
    kw = dict(dim=2, num_particles=64, dtype=T64)
    gen = lambda: torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="in_graph=True cannot stream"):
        TSM.smc_sample(_gauss_target, gen(), metrics=object(),
                       in_graph=True, **kw)
    with pytest.raises(NotImplementedError, match="A.11"):
        TSM.smc_sample(_gauss_target, gen(), metrics=object(), **kw)
    fit = TSM.make_transport_fitter(t_std, _gauss_target, nsteps=2)
    with pytest.raises(ValueError, match="even particle count"):
        TSM.smc_sample(_gauss_target, gen(), dim=2, num_particles=63,
                       fit_transport=fit, dtype=T64)
    with pytest.raises(ValueError, match="holdout_logz"):
        TSM.smc_sample(_gauss_target, gen(), fit_transport=fit,
                       kernels=TSM.build_smc_kernels(t_std, _gauss_target),
                       **kw)
    with pytest.raises(ValueError, match="base_sampler"):
        TSM.smc_sample(_gauss_target, gen(), log_base=t_std, **kw)


def test_fitter_and_transport_take_the_trainers_route(monkeypatch):
    """The fitter's steps and the transport's application to all particles
    take ``train.vi``'s route for the batch's device: on the card B1 (with
    B2 as its backward) for the default ScaleShift, here the plain path;
    each passes the rows of its batch: the fitter's half of the particles,
    the transport all of them."""
    assert VI._route(TF.default_template(torch.zeros(4, 100)), 100,
                     torch.float32, torch.device("cuda"), None, 4) \
        is TE.fused_forward_and_ladj
    calls = []

    def route(flow, dim, dtype, device, use_fused, rows):
        calls.append((type(flow).__name__, dim, dtype, device.type,
                      use_fused, rows))
        return VI._route(flow, dim, dtype, device, use_fused, rows)

    monkeypatch.setattr(TF, "_route", route)
    monkeypatch.setattr(TS, "_route", route)
    before = dict(TE.LAUNCHES)
    fit = TSM.make_transport_fitter(t_std, _gauss_target, nsteps=3)
    _, _, _, infos = TSM.smc_sample(
        _gauss_target, torch.Generator().manual_seed(0), dim=2,
        num_particles=256, fit_transport=fit, max_temps=2)
    assert sorted(calls, key=lambda c: c[-1]) == \
        [("ScaleShift", 2, torch.float32, "cpu", None, 128)] * len(infos) + \
        [("ScaleShift", 2, torch.float32, "cpu", None, 256)] * len(infos)
    assert TE.LAUNCHES == before


def test_smc_sample_runs_on_the_generators_device_by_default(monkeypatch):
    """A CPU generator runs SMC on the CPU in float32 by default; without a
    key the generator is made on the card (recorded here, the run going on
    with a CPU generator), seeded 0; the fitter's template lies on the
    particles' device."""
    parts, lw, logz, infos = TSM.smc_sample(
        _gauss_target, torch.Generator().manual_seed(3), dim=2,
        num_particles=512)
    assert parts.dtype == torch.float32 and parts.device.type == "cpu"
    assert lw.shape == (512,) and bool(torch.isfinite(parts).all())
    assert float(infos[-1].beta) == 1.0

    made = []
    real = torch.Generator

    def generator(device="cpu"):
        made.append(str(device))
        return real()

    monkeypatch.setattr(torch, "Generator", generator)
    no_key = TSM.smc_sample(_gauss_target, dim=2, num_particles=512)
    monkeypatch.undo()
    assert made == ["cuda"]
    seeded = TSM.smc_sample(_gauss_target, torch.Generator().manual_seed(0),
                            dim=2, num_particles=512)
    _same_runs(no_key, seeded)
    flow = TF.default_template(torch.zeros(8, 3, dtype=T64))
    assert all(p.device.type == "cpu" and p.dtype == T64
               for p in flow.parameters())


# ------------------------------------------------------------------
# infer(method="smc"): tests/test_infer.py's target.

MU_I = np.array([1.5, -0.5])
SD_I = np.array([1.0, 2.0])


def _jgauss_i(q):
    return -0.5 * jnp.sum(((q - jnp.asarray(MU_I)) / jnp.asarray(SD_I)) ** 2)


def _tgauss_i(q):
    return -0.5 * (((q - _t(MU_I)) / _t(SD_I)) ** 2).sum(-1)


TRUE_LOGZ_I = 0.5 * 2 * np.log(2 * np.pi) + float(np.log(SD_I).sum())


@pytest.mark.parametrize("through_flow", [False, True])
def test_infer_smc_logz(through_flow):
    """tests/test_infer.py::test_infer_smc_logz, raw and through the exact
    ``flow=`` (whitened -> data)."""
    kw = (dict(flow=et.ScaleShift(_t(SD_I), _t(MU_I))) if through_flow
          else dict(precondition=None))
    res = et.infer(_tgauss_i, dim=2, key=torch.Generator().manual_seed(4),
                   method="smc", num_particles=4096, dtype=T64, **kw)
    d = res.diagnostics
    np.testing.assert_allclose(d["mean"], MU_I, atol=0.15)
    np.testing.assert_allclose(d["log_z"], TRUE_LOGZ_I, atol=0.1)
    assert d["weight_ess"] > 1000
    assert res.draws.shape == (4096, 2)
    assert isinstance(res.stats[-1], TSM.SMCInfo)
    assert (res.flow is None) != through_flow
    if through_flow:
        np.testing.assert_allclose(d["sd"], SD_I, rtol=0.1)


@pytest.mark.parametrize("through_flow", [False, True])
def test_infer_smc_diagnostics_match_jax(through_flow, monkeypatch):
    """Given the same particles, weights and log Z from the sampler, the
    two packages' ``infer`` report the same draws, weighted mean and sd,
    log_z and weight ESS, to 1e-12; ``num_particles`` defaults to
    ``num_chains * num_samples``."""
    rng = np.random.default_rng(12)
    n = 6 * 50
    parts = rng.normal(size=(n, 2))
    lw = rng.normal(size=n) * 1.5
    seen = []

    def fake(shape_of):
        def smc_sample(target, key, *, dim, num_particles, dtype, **kw):
            seen.append((num_particles, kw))
            return (shape_of(parts), shape_of(lw), shape_of(np.array(0.7)),
                    [])
        return smc_sample

    monkeypatch.setattr(JS, "smc_sample", fake(jnp.asarray))
    monkeypatch.setattr(TI, "smc_sample", fake(_t))
    jflow = ef.ScaleShift(a=jnp.asarray(SD_I), b=jnp.asarray(MU_I))
    kw_j = dict(flow=jflow) if through_flow else dict(precondition=None)
    kw_t = (dict(flow=from_jax(jflow, device="cpu")) if through_flow
            else dict(precondition=None))
    res_j = ef.infer(_jgauss_i, dim=2, key=jax.random.PRNGKey(0),
                     method="smc", num_chains=6, num_samples=50,
                     mutation_steps=3, dtype=DT, **kw_j)
    res_t = et.infer(_tgauss_i, dim=2, key=torch.Generator(),
                     method="smc", num_chains=6, num_samples=50,
                     mutation_steps=3, dtype=T64, **kw_t)
    assert seen == [(n, {"mutation_steps": 3})] * 2
    _close(res_t.draws, res_j.draws, 1e-12, "draws")
    for k in ("mean", "sd", "log_z", "weight_ess"):
        _close(res_t.diagnostics[k], res_j.diagnostics[k], 1e-12, k)
    assert set(res_t.diagnostics) == set(res_j.diagnostics)
