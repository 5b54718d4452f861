"""The port's MCMC modules and ``infer`` against the JAX package, on the CPU.

Deterministic parts are held to JAX on the same numpy inputs in float64:
the diagnostics to 1e-12, the adaptation state step by step to 1e-12, the
log densities to 1e-12, and one HMC transition over all chains, given the
JAX kernel's own draws (momentum normals and acceptance uniforms from its
per-chain keys), to 1e-10. Random streams cannot match between the
frameworks, so the samplers are held to the statistical gates of
tests/test_mcmc.py and tests/test_infer.py.
"""
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu import mcmc as JM
from enflows_tpu.infer import summarize_draws as jax_summarize_draws

import enflows_tpu_torch as et
from enflows_tpu_torch import mcmc as TM
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.ops import leapfrog as TL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = jnp.float64
T64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


# ------------------------------------------------------------------
# Diagnostics: numpy in, numpy out, the same math.

def _draws(shape, seed, heavy=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_cauchy(shape) if heavy else rng.normal(size=shape)
    # AR(1) along the steps axis, so the autocorrelation sums are exercised.
    for t in range(1, shape[1]):
        x[:, t] += 0.6 * x[:, t - 1]
    return x


DIAG_CASES = [
    ("ess", (4, 500)), ("split_rhat", (4, 501)),
    ("rank_normalized_rhat", (4, 500)), ("bulk_ess", (3, 400)),
    ("tail_ess", (4, 300)), ("ess_per_dim", (4, 300, 3)),
    ("split_rhat_per_dim", (4, 300, 3)),
    ("rank_normalized_rhat_per_dim", (4, 200, 3)), ("bfmi", (8, 100)),
]


@pytest.mark.parametrize("name,shape", DIAG_CASES)
@pytest.mark.parametrize("heavy", [False, True])
def test_diagnostics_match_jax(name, shape, heavy):
    x = _draws(shape, len(name), heavy)
    got = getattr(TM, name)(x)
    np.testing.assert_allclose(got, getattr(JM, name)(x), rtol=1e-12,
                               atol=1e-12)


def test_diagnostics_take_tensors_and_ties():
    x = np.round(_draws((4, 300), 5), 1)         # many tied values
    assert TM.bulk_ess(_t(x)) == pytest.approx(JM.bulk_ess(x), rel=1e-12)
    assert TM.rank_normalized_rhat(_t(x)) == pytest.approx(
        JM.rank_normalized_rhat(x), rel=1e-12)
    assert TM.tail_ess(np.zeros((4, 100))) == 400.0


@pytest.mark.parametrize("n", [10, 60, 2000])
def test_pareto_khat_matches_jax(n):
    lw = np.random.default_rng(n).standard_t(3, size=n)
    lw[::97] = -np.inf
    np.testing.assert_allclose(TM.pareto_khat(lw), JM.pareto_khat(lw),
                               rtol=1e-12)


# ------------------------------------------------------------------
# Adaptation.

def test_dual_averaging_matches_jax_step_by_step():
    acc = np.random.default_rng(0).uniform(0.2, 1.0, size=60)
    dj = JM.da_init(0.3, DT)
    dt = TM.da_init(0.3, T64, device="cpu")
    for a in acc:
        dj = JM.da_update(dj, jnp.asarray(a, DT), target=0.75)
        dt = TM.da_update(dt, torch.tensor(a, dtype=T64), target=0.75)
        for fj, ft in zip(dj, dt):
            np.testing.assert_allclose(float(ft), float(fj), rtol=1e-12)


def test_welford_matches_jax():
    X = np.random.default_rng(1).normal(size=(64, 3)) * [1.0, 2.0, 0.5] + 1
    sj, st = JM.welford_init(3, DT), TM.welford_init(3, T64, device="cpu")
    for x in X[:10]:
        sj = JM.welford_update(sj, jnp.asarray(x))
        st = TM.welford_update(st, _t(x))
    for lo, hi in ((10, 30), (30, 64)):
        sj = JM.welford_update_batch(sj, jnp.asarray(X[lo:hi]))
        st = TM.welford_update_batch(st, _t(X[lo:hi]))
    for fj, ft in zip(sj, st):
        np.testing.assert_allclose(_np(ft), _np(fj), rtol=1e-12)
    for reg in (True, False):
        np.testing.assert_allclose(
            _np(TM.welford_variance(st, reg)),
            _np(JM.welford_variance(sj, reg)), rtol=1e-12)
    np.testing.assert_allclose(_np(TM.welford_variance(st, False)),
                               X.var(0, ddof=1), rtol=1e-10)


def test_adaptation_state_defaults_to_the_card():
    """Without a device, ``da_init`` of a float and ``welford_init`` build
    their state on the card (here, with no card, they fail asking for
    CUDA); ``da_init`` of a tensor keeps the tensor's device."""
    assert all(t.device.type == "cpu"
               for t in TM.da_init(torch.tensor(0.3, dtype=T64)))
    makers = (lambda: TM.da_init(0.3), lambda: TM.welford_init(3))
    if torch.cuda.is_available():
        for make in makers:
            assert all(t.device.type == "cuda" for t in make())
    else:
        for make in makers:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                make()


@pytest.mark.parametrize("num_warmup", [0, 19, 20, 100, 150, 200, 1000])
def test_build_schedule_matches_jax(num_warmup):
    for got, ref in zip(TM.build_schedule(num_warmup),
                        JM.build_schedule(num_warmup)):
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------
# Log densities.

def _jax_transport(d):
    v = lambda val: jnp.full((d,), val, DT)
    return ef.compose(
        ef.ScaleShift(a=jnp.linspace(0.5, 2.0, d, dtype=DT),
                      b=jnp.linspace(-1.0, 1.0, d, dtype=DT)),
        ef.invert(ef.Johnson(gamma=v(0.0), delta=v(4.0), xi=v(0.0),
                             lam=v(4.0))),
        ef.Householder(V=jnp.asarray(np.random.default_rng(d).normal(
            size=(3, d)), DT)).canonicalize())


@pytest.mark.parametrize("base", [False, True])
def test_pushforward_target_matches_jax(base):
    d = 4
    kw = dict(base_mean=jnp.full((d,), 0.3, DT),
              base_var=jnp.linspace(0.8, 1.4, d, dtype=DT)) if base else {}
    jt = JM.FlowPushforwardTarget(_jax_transport(d), **kw)
    tt = from_jax(jt, device="cpu")
    assert isinstance(tt, TM.FlowPushforwardTarget)
    assert tt.fused_kernel_available(d) and jt.fused_kernel_available(d)
    assert not tt.fused_kernel_available(d, torch.float64)
    x = 2.0 * np.random.default_rng(2).normal(size=(33, d))
    np.testing.assert_allclose(_np(tt(_t(x))),
                               np.asarray(jax.vmap(jt)(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_pushforward_target_takes_numbers_for_its_base():
    # Python numbers for the base's mean and variance: filled on the
    # density's device, the same density as JAX's.
    d = 4
    jt = JM.FlowPushforwardTarget(_jax_transport(d), base_mean=0.3,
                                  base_var=1.2)
    tt = TM.FlowPushforwardTarget(from_jax(_jax_transport(d), device="cpu"),
                                  0.3, 1.2)
    x = 2.0 * np.random.default_rng(3).normal(size=(9, d))
    np.testing.assert_allclose(_np(tt(_t(x))),
                               np.asarray(jax.vmap(jt)(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_graphed_value_and_grad_is_autograd_on_the_cpu():
    # The CUDA graph is for card tensors; on the CPU the samplers' leaves
    # run eager autograd, and nothing is captured.
    from enflows_tpu_torch.mcmc import hmc
    before = dict(hmc.GRAPHS)
    q = _t(np.random.default_rng(6).normal(size=(8, 3)))
    fn = hmc.graphed_value_and_grad(_tgauss)
    for got, want in zip(fn(q), hmc.value_and_grad(_tgauss, q)):
        assert torch.equal(got, want)
    assert hmc.GRAPHS == before


def test_flow_preconditioned_and_per_sample_match_jax():
    d = 3
    jflow = _jax_transport(d)
    tflow = from_jax(jflow, device="cpu")
    mu = np.array([1.0, -0.5, 0.2])

    def jlogp(z):
        return -0.5 * jnp.sum((z - mu) ** 2 * jnp.arange(1.0, 4.0))

    tlogp = TM.per_sample(
        lambda z: -0.5 * ((z - _t(mu)) ** 2 * torch.arange(1.0, 4.0,
                                                           dtype=T64)).sum())
    jpre = JM.flow_preconditioned(jlogp, jflow)
    tpre = TM.flow_preconditioned(tlogp, tflow)
    xi = np.random.default_rng(3).normal(size=(17, d))
    np.testing.assert_allclose(
        _np(tpre.logdensity_fn(_t(xi))),
        np.asarray(jax.vmap(jpre.logdensity_fn)(jnp.asarray(xi))),
        rtol=1e-12)
    np.testing.assert_allclose(_np(tpre.push_forward(_t(xi))),
                               np.asarray(jpre.push_forward(jnp.asarray(xi))),
                               rtol=1e-12, atol=1e-12)
    lp, g = TM.value_and_grad(tpre.logdensity_fn, _t(xi))
    lpj, gj = jax.vmap(jax.value_and_grad(jpre.logdensity_fn))(
        jnp.asarray(xi))
    np.testing.assert_allclose(_np(lp), np.asarray(lpj), rtol=1e-12)
    np.testing.assert_allclose(_np(g), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)


# ------------------------------------------------------------------
# One HMC transition with the JAX kernel's own draws.

COV = np.array([[2.0, 1.2, 0.0], [1.2, 1.0, 0.3], [0.0, 0.3, 0.5]])
PREC = np.linalg.inv(COV)


def _jgauss(q):
    return -0.5 * q @ jnp.asarray(PREC) @ q


def _tgauss(q):
    return -0.5 * ((q @ _t(PREC)) * q).sum(-1)


@pytest.mark.parametrize("step_size,num_steps", [(0.3, 5), (0.45, 3)])
def test_hmc_transition_matches_jax_vmap_kernel(step_size, num_steps):
    n, d = 64, 3
    q0 = np.random.default_rng(4).normal(size=(n, d))
    im = np.array([0.7, 1.0, 1.6])
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    kern = JM.hmc_kernel(_jgauss, num_steps=num_steps)
    states = jax.vmap(lambda q: JM.init_state(_jgauss, q))(jnp.asarray(q0))
    new_j, info_j = jax.jit(jax.vmap(kern, in_axes=(0, 0, None, None)))(
        keys, states, jnp.asarray(step_size, DT), jnp.asarray(im))

    # The kernel's draws (hmc.py:85-99), from the same per-chain keys.
    def draws(key):
        k_mom, k_acc = jax.random.split(key)
        return (jax.random.normal(k_mom, (d,), DT),
                jax.random.uniform(k_acc, (), DT))
    noise, u = jax.vmap(draws)(keys)
    p = _t(noise) * torch.rsqrt(_t(im))

    st = TM.init_state(_tgauss, _t(q0))
    np.testing.assert_allclose(_np(st.logp), np.asarray(states.logp),
                               rtol=1e-12)
    new_t, info_t = TM.hmc_transition(
        lambda q: TM.value_and_grad(_tgauss, q), st,
        torch.tensor(step_size, dtype=T64), _t(im), num_steps, p, _t(u))
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    for f in ("accept_prob", "energy"):
        np.testing.assert_allclose(_np(getattr(info_t, f)),
                                   np.asarray(getattr(info_j, f)),
                                   rtol=1e-10, atol=1e-12)
    for f in ("accepted", "divergent", "num_steps"):
        np.testing.assert_array_equal(_np(getattr(info_t, f)),
                                      np.asarray(getattr(info_j, f)))
    if step_size > 0.4:
        assert 0 < int(info_t.accepted.sum()) < n   # both branches taken


def test_hmc_kernel_draws_from_generator():
    kern = TM.hmc_kernel(_tgauss, num_steps=4)
    q0 = _t(np.random.default_rng(5).normal(size=(16, 3)))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        st, info = kern(gen, TM.init_state(_tgauss, q0),
                        torch.tensor(0.4, dtype=T64), torch.ones(3, dtype=T64))
        runs.append(st.q)
    assert torch.equal(runs[0], runs[1])
    assert info.accept_prob.shape == (16,) and bool(
        (info.energy >= -st.logp).all())


# ------------------------------------------------------------------
# Samplers: statistical gates.

def test_sample_hmc_gaussian_moments():
    """tests/test_mcmc.py::test_hmc_gaussian_moments on the port."""
    mu = np.array([0.5, 0.0, -0.5])
    var = np.array([0.5, 1.0, 2.0])
    logp = lambda q: -0.5 * (((q - _t(mu)) ** 2) / _t(var)).sum(-1)
    samples, final, stats = TM.sample(
        logp, torch.Generator().manual_seed(1), dim=3, num_chains=8,
        num_warmup=400, num_samples=800, algorithm="hmc", num_steps=16,
        dtype=T64, device="cpu")
    assert samples.shape == (8, 800, 3) and stats.energy.shape == (8, 800)
    assert stats.accept_prob.shape == (800, 8)
    s = _np(samples).reshape(-1, 3)
    np.testing.assert_allclose(s.mean(0), mu, atol=0.12)
    np.testing.assert_allclose(s.var(0), var, rtol=0.25)
    assert int(stats.divergent.sum()) == 0
    # The adapted mass matrix follows the target's variances.
    np.testing.assert_allclose(_np(stats.inv_mass_diag), var, rtol=0.5)


def test_sample_unported_options_raise():
    """``metrics=`` raised until ROADMAP A.11 was ported; it now streams a
    record a transition (tests/test_torch_utils.py holds the stream to
    JAX's). The name is the one the test had while it raised."""
    log = et.utils.MetricsLogger(None)
    TM.sample(_tgauss, torch.Generator(), dim=3, device="cpu",
              algorithm="hmc", num_chains=4, num_warmup=3, num_samples=2,
              dtype=torch.float64, metrics=log)
    assert [r["step"] for r in log.history] == [0, 1, 2, 0, 1]


@pytest.mark.parametrize("algorithm", ["nuts", "chees"])
def test_sample_tree_and_chees_algorithms_run(algorithm):
    """``sample(algorithm='nuts'/'chees')`` on the CPU when asked: draws
    of the requested shape, finite, and the sampler's own stats."""
    samples, final, stats = TM.sample(
        _tgauss, torch.Generator().manual_seed(7), dim=3, num_chains=16,
        num_warmup=40, num_samples=30, algorithm=algorithm, max_depth=4,
        dtype=T64, device="cpu")
    assert samples.shape == (16, 30, 3) and final.q.shape == (16, 3)
    assert bool(torch.isfinite(samples).all())
    assert stats.accept_prob.shape == (30, 16)
    assert stats.energy.shape == (16, 30)
    if algorithm == "nuts":
        assert isinstance(stats, TM.SampleStats)
        assert stats.num_steps.shape == (30, 16)
        assert 1 <= int(stats.num_steps.min()) and \
            int(stats.num_steps.max()) <= (1 << 4) - 1
    else:
        assert isinstance(stats, TM.ChEESSampleStats)
        assert stats.num_steps.shape == (30,)


# ------------------------------------------------------------------
# infer.

D2_MU = np.array([0.3, -0.2])
D2_VAR = np.array([1.2, 0.8])


def _d2_target():
    """The declared-pushforward target of tests/test_infer.py:233-243."""
    v = lambda val: jnp.full((2,), val, jnp.float32)
    transport = ef.compose(
        ef.ScaleShift(a=jnp.asarray([2.0, 0.5], jnp.float32),
                      b=jnp.asarray([1.0, -1.0], jnp.float32)),
        ef.invert(ef.Johnson(gamma=v(0.0), delta=v(5.0), xi=v(0.0),
                             lam=v(5.0))))
    return JM.FlowPushforwardTarget(
        transport, base_mean=jnp.asarray(D2_MU, jnp.float32),
        base_var=jnp.asarray(D2_VAR, jnp.float32))


def test_infer_pushforward_route_on_cpu():
    """The declared-pushforward route: fused_flow_hmc_sample over the
    target's whitening chain (its plain B6 on the CPU), with the moment gate
    of tests/test_infer.py:265-276 against Monte-Carlo truth."""
    target = from_jax(_d2_target(), device="cpu")
    before = dict(TL.LAUNCHES)
    res = et.infer(target, dim=2, key=torch.Generator().manual_seed(0),
                   method="hmc", num_chains=64, num_warmup=150,
                   num_samples=300)
    assert TL.LAUNCHES == before                 # CPU: the plain version
    assert isinstance(res.stats, TM.FusedHMCStats)
    assert res.flow is target.transport and res.draws.shape == (64, 300, 2)
    gen = torch.Generator().manual_seed(9)
    z = _t(D2_MU).float() + torch.sqrt(_t(D2_VAR).float()) * torch.randn(
        200_000, 2, generator=gen)
    with torch.no_grad():
        xs = target.transport(z).numpy()
    got = _np(res.draws).reshape(-1, 2)
    np.testing.assert_allclose(got.mean(0), xs.mean(0), atol=0.1)
    np.testing.assert_allclose(got.std(0), xs.std(0), rtol=0.1)
    assert 0.6 < res.diagnostics["accept_prob"] <= 1.0
    assert res.diagnostics["min_bulk_ess"] > 100


def test_infer_explicit_flow_route():
    """tests/test_infer.py::test_infer_explicit_flow on the port: the exact
    whitened -> data map, draws pushed back to data space."""
    mu, sd = np.array([1.5, -0.5]), np.array([1.0, 2.0])
    logp = lambda q: -0.5 * (((q - _t(mu)) / _t(sd)) ** 2).sum(-1)
    flow = et.ScaleShift(_t(sd), _t(mu))
    res = et.infer(logp, dim=2, key=torch.Generator().manual_seed(2),
                   method="hmc", flow=flow, num_chains=4, num_warmup=200,
                   num_samples=300, dtype=T64, num_steps=8)
    assert res.flow is flow and res.draws.shape == (4, 300, 2)
    d = res.diagnostics
    np.testing.assert_allclose(d["mean"], mu, atol=0.2)
    np.testing.assert_allclose(d["sd"], sd, rtol=0.15)
    assert d["divergences"] == 0 and 0.5 < d["accept_prob"] <= 1.0
    assert 0.5 < d["bfmi"] < 2.0


class _Stats(NamedTuple):
    accept_prob: np.ndarray
    divergent: np.ndarray
    energy: np.ndarray


def test_summarize_draws_matches_jax():
    rng = np.random.default_rng(6)
    draws = _draws((4, 250, 3), 7)
    stats = _Stats(rng.uniform(size=(250, 4)), rng.uniform(size=(250, 4)) >
                   0.99, rng.normal(size=(4, 250)))
    got = et.summarize_draws(_t(draws), _Stats(*map(_t, stats)))
    ref = jax_summarize_draws(draws, stats)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("kw,item", [
    (dict(method="smc"), "A.9"), (dict(), "A.9"),
    (dict(data=np.random.default_rng(8).normal(size=(8, 2))), "A.9"),
    (dict(mesh=None), "A.10"),
    (dict(precondition=None, refine_rounds=1), "A.9"),
])
def test_infer_unported_routes_raise(kw, item):
    """The routes that raised before ROADMAP A.9 and A.10 were ported run
    at a tiny size: the A.9 routes (the auto transport with and without
    SMC, ``data=``, ``refine_rounds``) and ``mesh=`` (A.10, a one-rank
    mesh). The name is the one the test had while all of them raised."""
    kw = {"method": "hmc", **kw}
    logp = lambda q: -0.5 * (q * q).sum(-1)
    if item == "A.10":
        # Runs since A.10 was ported; a one-rank mesh samples as without.
        kw["mesh"] = et.parallel.make_mesh(device="cpu")
        small = dict(precondition=None, num_chains=4, num_warmup=10,
                     num_samples=5)
        got, want = (et.infer(logp, dim=2, key=torch.Generator()
                              .manual_seed(2), **k, **small)
                     for k in (kw, {"method": "hmc"}))
        assert torch.equal(got.draws, want.draws)
        return
    tiny = dict(vi_steps=40, vi_batch=32, whiten_batches=2, whiten_epochs=1,
                num_chains=4, num_warmup=10, num_samples=5)
    if kw["method"] == "smc":
        tiny["num_particles"] = 256
    res = et.infer(logp, dim=2, key=torch.Generator(), **kw, **tiny)
    assert bool(torch.isfinite(res.draws).all())
    assert res.flow is not None


def test_infer_pushforward_with_unsupported_kwarg_takes_standard_path():
    """A kwarg the fused route does not take sends the call down the
    standard path (tests/test_infer.py:279), whose ``sample`` streams
    ``metrics=`` (it raised as unported until ROADMAP A.11), with no B6
    launch."""
    target = from_jax(_d2_target(), device="cpu")
    log = et.utils.MetricsLogger(None)
    before = dict(TL.LAUNCHES)
    res = et.infer(target, dim=2, key=torch.Generator(), method="hmc",
                   precondition=None, metrics=log, num_chains=4,
                   num_warmup=2, num_samples=2)
    assert TL.LAUNCHES == before
    assert res.draws.shape == (4, 2, 2)
    assert len(log.history) == 4


@pytest.mark.parametrize("method", ["nuts", "chees"])
@pytest.mark.parametrize("route", ["raw", "flow"])
def test_infer_tree_methods_run(method, route):
    """``infer(method='nuts'/'chees')`` on the raw target
    (``precondition=None``) and through an explicit ``flow=``: draws of the
    requested shape in data space, finite, with the diagnostics."""
    mu, sd = np.array([1.5, -0.5]), np.array([1.0, 2.0])
    logp = lambda q: -0.5 * (((q - _t(mu)) / _t(sd)) ** 2).sum(-1)
    kw = dict(precondition=None) if route == "raw" else \
        dict(flow=et.ScaleShift(_t(sd), _t(mu)))
    res = et.infer(logp, dim=2, key=torch.Generator().manual_seed(3),
                   method=method, num_chains=16, num_warmup=60,
                   num_samples=40, dtype=T64, max_depth=5, **kw)
    assert res.draws.shape == (16, 40, 2)
    assert bool(torch.isfinite(res.draws).all())
    assert res.flow is kw.get("flow")
    d = res.diagnostics
    assert np.all(np.isfinite(d["mean"])) and d["min_bulk_ess"] > 0
    assert 0.0 < d["accept_prob"] <= 1.0


def _gauss_mu_sd():
    mu, sd = np.array([1.5, -0.5]), np.array([1.0, 2.0])
    return mu, sd, lambda q: -0.5 * (((q - _t(mu)) / _t(sd)) ** 2).sum(-1)


def test_infer_raw_nuts_moments_and_diagnostics():
    """tests/test_infer.py:23 on the port: the default method (NUTS) on the
    raw target."""
    mu, sd, logp = _gauss_mu_sd()
    res = et.infer(logp, dim=2, key=torch.Generator().manual_seed(0),
                   precondition=None, num_chains=8, num_warmup=300,
                   num_samples=400, dtype=T64)
    assert res.flow is None and res.draws.shape == (8, 400, 2)
    d = res.diagnostics
    np.testing.assert_allclose(d["mean"], mu, atol=0.12)
    np.testing.assert_allclose(d["sd"], sd, rtol=0.12)
    assert np.all(d["rhat"] < 1.05)
    assert d["min_bulk_ess"] > 200
    assert np.all(d["tail_ess"] > 100)
    assert d["divergences"] == 0
    assert 0.5 < d["accept_prob"] <= 1.0
    assert 0.5 < d["bfmi"] < 2.0


def test_infer_chees():
    """tests/test_infer.py:176 on the port."""
    mu, _, logp = _gauss_mu_sd()
    res = et.infer(logp, dim=2, key=torch.Generator().manual_seed(3),
                   method="chees", precondition=None, num_chains=32,
                   num_warmup=300, num_samples=200, dtype=T64)
    d = res.diagnostics
    np.testing.assert_allclose(d["mean"], mu, atol=0.15)
    assert np.all(d["rhat"] < 1.1)


def test_infer_pushforward_tree_method_takes_sample(monkeypatch):
    """A declared FlowPushforwardTarget with a tree method runs
    ``mcmc.sample`` on the target, never the fused HMC route (B6)."""
    def refuse(*args, **kwargs):
        raise AssertionError("fused_flow_hmc_sample called")

    monkeypatch.setattr(sys.modules["enflows_tpu_torch.infer"],
                        "fused_flow_hmc_sample", refuse)
    target = from_jax(_d2_target(), device="cpu")
    before = dict(TL.LAUNCHES)
    res = et.infer(target, dim=2, key=torch.Generator().manual_seed(1),
                   method="nuts", precondition=None, num_chains=8,
                   num_warmup=30, num_samples=20, max_depth=4)
    assert TL.LAUNCHES == before
    assert isinstance(res.stats, TM.SampleStats) and res.flow is None
    assert res.draws.shape == (8, 20, 2)
    assert bool(torch.isfinite(res.draws).all())


def test_mcmc_and_infer_import_no_jax():
    code = ("import sys; import enflows_tpu_torch.mcmc, "
            "enflows_tpu_torch.infer, enflows_tpu_torch.ops.leapfrog; "
            "bad = [m for m in sys.modules if m in ('jax', 'triton', "
            "'enflows_tpu') or m.startswith(('jax.', 'enflows_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    for rel in ("mcmc/__init__.py", "mcmc/adaptation.py", "mcmc/chees.py",
                "mcmc/diagnostics.py", "mcmc/fused_hmc.py", "mcmc/hmc.py",
                "mcmc/logdensity.py", "mcmc/nuts.py", "mcmc/sample.py",
                "infer.py",
                "ops/leapfrog.py", "ops/csrc/leapfrog.cu"):
        src = open(os.path.join(ROOT, "enflows_tpu_torch", rel)).read()
        assert "import jax" not in src and "from jax" not in src, rel
        assert "enflows_tpu." not in src.replace("enflows_tpu_torch", ""), rel
