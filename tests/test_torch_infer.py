"""The port's ``infer`` (precondition='auto', data=, refine_rounds and
JAX's keywords) against the JAX package, on the CPU.

Parity, float64 on both sides, with the same draws handed to both packages:
the transport probes ``_transport_khat`` and ``_transport_coverage_gap`` at
1e-10 (the flows carried over by ``interop.from_jax``, the probe draws through
the port's hook ``infer._probe_draws``), one whole elementwise rung (its
template, VI and probe draws rebuilt from JAX's keys) at 1e-8, and the
``data=`` whitening fit at 1e-5 (C-1: optax puts Adagrad's eps inside the
square root, torch outside). The ladder's decisions are held table by table
with the fits' severities stubbed. The statistical counterparts of
tests/test_infer.py keep its targets, sizes and tolerances; each gate was
run on generator seeds 0-4 and kept only where all five passed
(CHANGES.md lists the values).
"""
import importlib
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enflows_tpu.infer import _transport_coverage_gap as jax_gap
from enflows_tpu.infer import _transport_khat as jax_khat
from enflows_tpu.infer import coupling_flow_template as jax_coupling_template
from enflows_tpu.infer import default_flow_template as jax_default_template
from enflows_tpu.infer import infer as jax_infer

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.train import VIResult
from enflows_tpu_torch.train import vi as VI

TI = importlib.import_module("enflows_tpu_torch.infer")
JI = importlib.import_module("enflows_tpu.infer")
JT = importlib.import_module("enflows_tpu.train")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = jnp.float64
T64 = torch.float64
_LOG_2PI = 1.8378770664093453


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        tree)


# ------------------------------------------------------------------
# Targets, one formula for each framework: JAX's per sample, the port's
# batched.

MU = np.array([1.5, -0.5])
SD = np.array([1.0, 2.0])


def _jgauss(q):
    return -0.5 * jnp.sum(((q - jnp.asarray(MU)) / jnp.asarray(SD)) ** 2)


def _gauss(q):
    return -0.5 * (((q - _t(MU)) / _t(SD)) ** 2).sum(-1)


def _jwarped(q):
    return -0.5 * jnp.sum(((q - 0.3) / 1.5) ** 2) - 0.01 * jnp.sum(q ** 4)


def _twarped(q):
    return -0.5 * (((q - 0.3) / 1.5) ** 2).sum(-1) - 0.01 * (q ** 4).sum(-1)


def _jbounded(q):
    """Support x_0 > 0 only: -inf elsewhere."""
    return jnp.where(q[0] > 0.0, _jgauss(q), -jnp.inf)


def _tbounded(q):
    return torch.where(q[:, 0] > 0.0, _gauss(q),
                       torch.full_like(q[:, 0], -math.inf))


# ------------------------------------------------------------------
# The probes, given the same draws.

def _jax_normals(key, n, dim):
    return _t(jax.random.normal(key, (n, dim), F64))


def _feed_probes(monkeypatch, draws):
    """The port's probes take ``draws`` in order, one tensor a call."""
    queue = list(draws)

    def probe(generator, n, dim, dtype):
        x = queue.pop(0)
        assert x.shape == (n, dim) and x.dtype == dtype
        return x

    monkeypatch.setattr(TI, "_probe_draws", probe)
    return queue


PROBE_CASES = {
    "default_template": (3, _jwarped, _twarped),
    "spline_template": (2, _jgauss, _gauss),
    "bounded_support": (2, _jbounded, _tbounded),
}


def _probe_flow(case, dim):
    key = jax.random.PRNGKey(31)
    if case == "spline_template":
        return _perturb(jax_coupling_template(2, (8, 8), kind="spline")(
            dim, key, F64), seed=32, scale=0.1)
    return _perturb(jax_default_template(dim, key, F64), seed=33)


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_transport_probes_match_jax(case, monkeypatch):
    """k-hat and the coverage gap of a perturbed transport, 1e-10, on JAX's
    probe draws; the bounded-support target is -inf on part of the probes
    and both stay finite (the gap's mask, enflows_tpu/infer.py:209)."""
    dim, jlogp, tlogp = PROBE_CASES[case]
    jflow = _probe_flow(case, dim)
    tflow = from_jax(jflow, device="cpu")
    k1, k2 = jax.random.PRNGKey(41), jax.random.PRNGKey(42)
    queue = _feed_probes(monkeypatch, [_jax_normals(k1, 2048, dim),
                                       _jax_normals(k2, 2048, dim)])
    kh_t = TI._transport_khat(tlogp, tflow, dim, torch.Generator(), T64)
    gap_t = TI._transport_coverage_gap(tlogp, tflow, dim, torch.Generator(),
                                       T64)
    assert not queue
    kh_j = jax_khat(jlogp, jflow, dim, k1, F64)
    gap_j = jax_gap(jlogp, jflow, dim, k2, F64)
    assert np.isfinite(kh_t) and np.isfinite(gap_t)
    _close(kh_t, kh_j, 1e-10, "khat")
    _close(gap_t, gap_j, 1e-10, "gap")
    if case == "bounded_support":
        with torch.no_grad():
            z = tflow(_jax_normals(k2, 2048, dim) * 4.0)
        assert 0 < int((z[:, 0] <= 0).sum()) < 2048


# ------------------------------------------------------------------
# One whole rung and the data= fit, given JAX's draws.

def _stub_samplers(monkeypatch, dim, chains=4, steps=6):
    """Both packages' MCMC samplers return the same fixed draws, so that
    the fits and their diagnostics are what is compared."""
    draws = np.random.default_rng(5).normal(size=(chains, steps, dim))
    monkeypatch.setattr(JI, "sample",
                        lambda *a, **k: (jnp.asarray(draws), None, None))
    monkeypatch.setattr(TI, "sample", lambda *a, **k: (_t(draws), None, None))


def _jax_keys(seed):
    _, k_fit, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    return k_fit


def _inject_template(monkeypatch, key):
    """The port's default template is JAX's, drawn from ``key``."""
    monkeypatch.setattr(TI, "default_flow_template",
                        lambda dim, gen, dtype: from_jax(
                            jax_default_template(dim, key, F64),
                            device="cpu"))


def _same_flow(jflow, tflow, x, tol):
    z_j, l_j = jflow.forward_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        z_t, l_t = tflow.forward_and_ladj(_t(x))
    _close(z_t, z_j, tol, "z")
    _close(l_t, l_j, tol, "ladj")


def test_elementwise_rung_matches_jax(monkeypatch):
    """precondition_kind='elementwise', vi_steps=20 on tests/test_infer.py's
    2-D Gaussian: the same template, VI and probe draws (rebuilt from JAX's
    k_fit) and Adagrad without eps in both, so the fitted flow's parameters,
    k-hat and the coverage gap agree to 1e-8."""
    k_fit = _jax_keys(3)
    _inject_template(monkeypatch, jax.random.fold_in(k_fit, 0))
    monkeypatch.setattr(
        VI, "_base_draws",
        lambda gen, step, n, dim, dtype, device: _jax_normals(
            jax.random.fold_in(k_fit, step), n, dim))
    queue = _feed_probes(monkeypatch, [
        _jax_normals(jax.random.fold_in(k_fit, 101), 2048, 2),
        _jax_normals(jax.random.fold_in(k_fit, 201), 2048, 2)])
    _stub_samplers(monkeypatch, 2)
    kw = dict(dim=2, precondition_kind="elementwise", vi_steps=20,
              vi_batch=64, num_chains=4, num_samples=6)
    res_j = jax_infer(_jgauss, key=jax.random.PRNGKey(3), dtype=F64,
                      vi_optimizer=optax.adagrad(0.1, eps=0.0), **kw)
    res_t = et.infer(_gauss, key=torch.Generator(), dtype=T64,
                     vi_optimizer=lambda p: torch.optim.Adagrad(
                         p, lr=0.1, initial_accumulator_value=0.1, eps=0.0),
                     **kw)
    assert not queue
    leaves = jax.tree.leaves(res_j.flow)
    params = [p for _, p in res_t.flow.named_parameters()]
    assert len(leaves) == len(params)
    for i, (p, leaf) in enumerate(zip(params, leaves)):
        _close(p, leaf, 1e-8, f"leaf {i}")
    dj, dt = res_j.diagnostics, res_t.diagnostics
    assert dt["precondition_family"] == dj["precondition_family"] \
        == "elementwise"
    for k in ("precondition_khat", "precondition_coverage_gap"):
        _close(dt[k], dj[k], 1e-8, k)
    assert set(dt) == set(dj)


def test_data_whitening_fit_matches_jax(monkeypatch):
    """data=: the same data and template draws; the whitening fit's history
    and the fitted flow's forward and ladj to 1e-5 (C-1's Adagrad eps), with
    the default optimizer on both sides."""
    k_fit = _jax_keys(4)
    _inject_template(monkeypatch, k_fit)
    _stub_samplers(monkeypatch, 2)
    fits = {}

    def recorder(fn, name):
        def wrapped(*a, **k):
            fits[name] = fn(*a, **k)
            return fits[name]
        return wrapped

    monkeypatch.setattr(JT, "optimize_whitening",
                        recorder(JT.optimize_whitening, "jax"))
    monkeypatch.setattr(TI, "optimize_whitening",
                        recorder(TI.optimize_whitening, "torch"))
    rng = np.random.default_rng(7)
    z = rng.normal(size=(2000, 2))
    X = np.stack([1.5 + 0.8 * np.sinh(z[:, 0]),
                  -1.0 + 0.5 * z[:, 0] + 0.7 * z[:, 1]], axis=1)
    kw = dict(dim=2, whiten_batches=10, whiten_epochs=3, num_chains=4,
              num_samples=6)
    res_j = jax_infer(_jgauss, key=jax.random.PRNGKey(4), data=X,
                      dtype=F64, **kw)
    res_t = et.infer(_gauss, key=torch.Generator(), data=X, dtype=T64, **kw)
    hist_t = fits["torch"].negll_history
    assert hist_t.shape == (30,)
    np.testing.assert_allclose(_np(hist_t),
                               np.asarray(fits["jax"].negll_history),
                               rtol=1e-5)
    _same_flow(fits["jax"].result, fits["torch"].result, X[:256], 1e-5)
    _same_flow(res_j.flow, res_t.flow, rng.normal(size=(256, 2)), 1e-5)
    assert "precondition_family" not in res_t.diagnostics


# ------------------------------------------------------------------
# The ladder's decisions, with the fits' severities stubbed.

class _Run(dict):
    pass


def _stub_ladder(monkeypatch, severities, rescue_severity, dim=2):
    """Rung i's fit has severity ``severities[i]`` (k-hat and gap at the
    same ratio to their thresholds), the rescue ``rescue_severity``; the
    samplers record what they were given."""
    run = _Run(fits=[], rescue=[], sample=[], smc=[])
    rescue_flow = et.ScaleShift(torch.ones(dim, dtype=T64),
                                torch.zeros(dim, dtype=T64))

    def optimize_elbo(logp, flow, opt, *, dim, batch_size, nsteps, key,
                      dtype):
        run["fits"].append((batch_size, nsteps))
        return VIResult(flow, None, None)

    def fit_quality(logp, flow, dim, keys, i, dtype):
        sev = rescue_severity if i == 9 else severities[i]
        return sev, 0.7 * sev, 3.0 * sev

    def smc_rescue(*a):
        run["rescue"].append(a)
        return rescue_flow

    def sample(target, gen, *, num_chains, num_samples, dim, **kw):
        run["sample"].append(target)
        return torch.randn(num_chains, num_samples, dim, generator=gen,
                           dtype=T64), None, None

    def smc_sample(target, gen, *, dim, num_particles, dtype, **kw):
        run["smc"].append(target)
        return (torch.randn(num_particles, dim, generator=gen, dtype=T64),
                torch.zeros(num_particles, dtype=T64),
                torch.zeros((), dtype=T64), [])

    for name, fn in (("optimize_elbo", optimize_elbo),
                     ("_fit_quality", fit_quality),
                     ("_smc_rescue", smc_rescue), ("sample", sample),
                     ("smc_sample", smc_sample)):
        monkeypatch.setattr(TI, name, fn)
    run["rescue_flow"] = rescue_flow
    return run


LADDER_TABLE = [
    # (kind, dim, method, rung severities, rescue severity,
    #  fits run, rescue run, family, escalated)
    ("auto", 2, "nuts", [0.5, 9.0], 0.1, 1, False, "elementwise", False),
    ("auto", 2, "nuts", [1.0, 0.2], 0.1, 1, False, "elementwise", False),
    ("auto", 2, "hmc", [1.5, 0.8], 0.1, 2, False, "spline", False),
    ("auto", 2, "nuts", [1.5, 1.2], 0.9, 2, True, "smc+spline-whitening",
     True),
    ("auto", 2, "chees", [1.5, 1.2], 0.9, 2, True, "smc+spline-whitening",
     True),
    ("auto", 2, "hmc", [1.5, 1.2], 0.9, 2, True, "smc+spline-whitening",
     True),
    ("auto", 2, "nuts", [1.5, 1.2], 1.2, 2, True, "spline", False),
    ("auto", 2, "nuts", [2.0, 3.0], 2.5, 2, True, "elementwise", False),
    ("auto", 2, "smc", [1.5, 1.2], 0.1, 2, False, "spline", False),
    ("elementwise", 2, "nuts", [1.5], 0.1, 1, False, "elementwise", False),
    ("affine", 2, "nuts", [1.5], 0.1, 1, False, "affine", False),
    ("spline", 2, "smc", [0.3], 0.1, 1, False, "spline", False),
    ("auto", 1, "nuts", [1.5], 0.1, 1, False, "elementwise", False),
    ("custom", 2, "nuts", [1.5], 0.1, 1, False, "custom", False),
]


@pytest.mark.parametrize("row", LADDER_TABLE,
                         ids=[f"{r[0]}-d{r[1]}-{r[2]}-{r[3]}-{r[4]}"
                              for r in LADDER_TABLE])
def test_ladder_decisions(row, monkeypatch):
    """Which family wins, the stop at severity <= 1.0, the rescue only when
    the best rung is > 1, the ladder has more than one rung and the method
    is not SMC, the escalation to SMC on the raw target only for MCMC
    methods when the rescue wins, and the diagnostics on every route."""
    kind, dim, method, sevs, rescue_sev, n_fits, rescued, family, \
        escalated = row
    run = _stub_ladder(monkeypatch, sevs, rescue_sev, dim)
    logp = lambda q: -0.5 * (q * q).sum(-1)
    kw = dict(precondition_kind=kind) if kind != "custom" else \
        dict(flow_template=et.coupling_flow_template(2, (4, 4)))
    res = et.infer(logp, dim=dim, key=torch.Generator().manual_seed(1),
                   method=method, num_chains=3, num_samples=5, vi_steps=7,
                   vi_batch=9, dtype=T64, **kw)
    d = res.diagnostics
    assert run["fits"] == [(9, 7)] * n_fits
    assert len(run["rescue"]) == int(rescued)
    assert d["precondition_family"] == family
    best = min(sevs[:n_fits] + ([rescue_sev] if rescued else []))
    _close(d["precondition_khat"], 0.7 * best, 1e-12)
    _close(d["precondition_coverage_gap"], 3.0 * best, 1e-12)
    assert ("method_escalated_to" in d) == escalated
    if escalated:
        assert d["method_escalated_to"] == "smc"
        assert run["smc"] == [logp] and not run["sample"]
        assert res.flow is run["rescue_flow"] and "log_z" in d
    elif method == "smc":
        assert len(run["smc"]) == 1 and run["smc"][0] is not logp
        assert "log_z" in d
    else:
        assert len(run["sample"]) == 1 and run["sample"][0] is not logp
        assert res.draws.shape == (3, 5, dim)


def test_escalation_passes_smc_only_its_keywords(monkeypatch):
    """A NUTS keyword given to infer does not reach smc_sample when the
    ladder escalates to SMC (JAX passes it on: a TypeError), while an SMC
    keyword does (ROADMAP C-4)."""
    run = _stub_ladder(monkeypatch, [1.5, 1.2], 0.9)
    seen = []
    monkeypatch.setattr(TI, "smc_sample", lambda target, gen, *, dim,
                        num_particles, dtype, **kw: (
                            seen.append(kw),
                            (torch.zeros(num_particles, dim, dtype=T64),
                             torch.zeros(num_particles, dtype=T64),
                             torch.zeros((), dtype=T64), []))[1])
    res = et.infer(lambda q: -0.5 * (q * q).sum(-1), dim=2,
                   key=torch.Generator(), max_depth=5, mutation_steps=3,
                   num_chains=2, num_samples=3, dtype=T64)
    assert res.diagnostics["method_escalated_to"] == "smc"
    assert seen == [{"mutation_steps": 3}] and not run["sample"]


def test_bad_precondition_kind_raises():
    with pytest.raises(ValueError, match="precondition_kind"):
        et.infer(_gauss, dim=2, key=torch.Generator(),
                 precondition_kind="coupling", dtype=T64)


def test_rescue_resamples_from_its_own_generator(monkeypatch):
    """The rescue's resample draws from the rescue's generator
    (keys.fit(7)), not from a fixed numpy seed as JAX does
    (enflows_tpu/infer.py:407, ROADMAP C-4): two callers' generators give
    two resamples, one generator twice the same."""
    seen = []
    real = TI._rescue_resample

    def resample(gen, w):
        idx = real(gen, w)
        seen.append(idx)
        return idx

    monkeypatch.setattr(TI, "_rescue_resample", resample)
    monkeypatch.setattr(TI, "smc_sample", lambda logp, gen, *, dim,
                        num_particles, dtype: (
                            torch.randn(num_particles, dim, dtype=dtype,
                                        generator=torch.Generator()
                                        .manual_seed(0)),
                            torch.linspace(-3, 0, num_particles,
                                           dtype=dtype), None, None))
    monkeypatch.setattr(TI, "optimize_whitening",
                        lambda x, flow, opt, **kw: VIResult(flow, None,
                                                            None))
    for seed in (1, 1, 2):
        keys = TI._Keys(torch.Generator().manual_seed(seed))
        TI._smc_rescue(_gauss, 2, keys, T64, None, 16, 8)
    assert seen[0].shape == (4096,)
    assert torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[2])


def test_role_generators_are_derived_without_advancing_the_callers():
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    keys = TI._Keys(gen)
    a, b = keys.fit(101).initial_seed(), keys.fit(201).initial_seed()
    assert torch.equal(gen.get_state(), state)
    assert a != b and a == TI._Keys(gen).fit(101).initial_seed()
    assert keys.fit().initial_seed() not in (a, b)
    assert keys.refine(1).initial_seed() != keys.refine(2).initial_seed()


# ------------------------------------------------------------------
# The keyword surface and the device.

def test_infer_takes_every_jax_keyword_but_mesh():
    """C-9: every keyword of JAX's infer, with JAX's defaults."""
    jsig = inspect.signature(jax_infer).parameters
    tsig = inspect.signature(et.infer).parameters
    for name, p in jsig.items():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            continue
        assert name in tsig, name
        if name in ("key", "dtype"):
            continue
        assert tsig[name].default == p.default, name
    assert str(tsig["dtype"].default) == "torch.float32"


@pytest.mark.parametrize("route", ["flow", "raw"])
def test_data_is_ignored_under_flow_and_raw(route, monkeypatch):
    """data= with flow= or precondition=None fits nothing, and the JAX
    keywords pass without reaching the sampler (C-9)."""
    def refuse(*a, **k):
        raise AssertionError("a transport was fitted")

    monkeypatch.setattr(TI, "optimize_whitening", refuse)
    monkeypatch.setattr(TI, "optimize_elbo", refuse)
    flow = et.ScaleShift(_t(SD), _t(MU))
    kw = dict(flow=flow) if route == "flow" else dict(precondition=None)
    res = et.infer(_gauss, dim=2, key=torch.Generator().manual_seed(2),
                   data=np.zeros((10, 2)), precondition_kind="affine",
                   flow_template=et.coupling_flow_template(),
                   vi_steps=3, vi_batch=4, vi_optimizer=refuse,
                   whiten_batches=2, whiten_epochs=1, num_chains=4,
                   num_warmup=20, num_samples=10, max_depth=4, dtype=T64,
                   **kw)
    assert res.flow is kw.get("flow")
    assert res.draws.shape == (4, 10, 2)
    assert "precondition_family" not in res.diagnostics


def test_infer_auto_runs_on_the_card_by_default(monkeypatch):
    """Without a key, infer(precondition='auto') makes its generator on the
    card ("cuda", seeded 0) and every role's generator on that generator's
    device; here a CPU generator stands in for the card's, and the run
    equals one given a CPU generator seeded 0."""
    made = []
    real = torch.Generator

    def generator(device="cpu"):
        made.append(str(device))
        return real()

    kw = dict(dim=2, precondition_kind="elementwise", vi_steps=5,
              vi_batch=16, num_chains=2, num_warmup=10, num_samples=5,
              max_depth=3, dtype=T64)
    monkeypatch.setattr(torch, "Generator", generator)
    no_key = et.infer(_gauss, **kw)
    monkeypatch.undo()
    assert made[0] == "cuda" and set(made[1:]) == {"cpu"}, made
    seeded = et.infer(_gauss, key=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(no_key.draws, seeded.draws)
    assert no_key.diagnostics["precondition_khat"] == \
        seeded.diagnostics["precondition_khat"]


@pytest.mark.parametrize("rows", [40, 1024, (1 << 17) - 1, 1 << 17,
                                  1 << 20])
def test_coupling_row_rule_boundary(rows):
    """ROADMAP C-3: on the card the trainers send a coupling stack, affine
    or spline, forward or inverted, to B4/B5 only at batches of at least
    COUPLING_MIN_ROWS rows of a stack at least COUPLING_MIN_DIM wide, where
    the kernels hold on trained stacks; the ladder's batches (40-1,024
    rows) and every d=2 batch take the plain path. Elementwise chains take
    B1/B2 and B3 at any size. The SMC fitter and transport pass their
    batch's rows to the same rule."""
    from enflows_tpu_torch.ops import coupling as TC
    from enflows_tpu_torch.ops import elementwise as TE
    from enflows_tpu_torch.smc import smc as TS
    from enflows_tpu_torch.train import whitening as TW
    assert (TC.COUPLING_MIN_ROWS, TC.COUPLING_MIN_DIM) == (1 << 17, 50)
    gen = torch.Generator()
    f32, cuda = torch.float32, torch.device("cuda")
    fused, plain = VI._fused_coupling_forward, VI._plain_forward
    for d in (2, 48, 50, 64):
        held = rows >= 1 << 17 and d >= 50
        assert TC.coupling_batch_held(rows, d) is held
        for kind in ("affine", "spline"):
            stack = et.coupling_flow_template(kind=kind)(d, gen)
            assert VI._route(stack, d, f32, cuda, None, rows) is \
                (fused if held else plain)
            assert TW._dispatch(TI._whitening_start(stack), d, f32, True,
                                rows) == ("coupling" if held else False)
            assert TW._dispatch(TI._whitening_start(stack), d, f32, False,
                                rows) is False
        chain = et.default_flow_template(d, gen)
        assert VI._route(chain, d, f32, cuda, None, rows) is \
            TE.fused_forward_and_ladj
        assert TW._dispatch(TI._whitening_start(chain), d, f32, True,
                            rows) is True
    # The SMC transport's route on a CPU batch: the plain path, the rows
    # passed on.
    x = torch.zeros(min(rows, 64), 2)
    z, _ = TS._transport_forward(
        et.coupling_flow_template(kind="spline")(2, gen), x)
    assert z.shape == x.shape


def test_no_route_names_a9_any_longer():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT,
                                                     "enflows_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build outputs
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert '"A.9"' not in src and "A.9)" not in src, f


# ------------------------------------------------------------------
# Statistical counterparts of tests/test_infer.py: its targets, sizes and
# tolerances, on the port's own draws. Each gate was run on generator seeds
# 0-4 (``seed``) and kept only where all five passed; the tests run the
# first of them, STAT_SEED.

STAT_SEED = 0


def _vec(*a):
    return _t(np.array(a, np.float64))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def auto_preconditioned(seed):
    """test_infer.py:40."""
    res = et.infer(_gauss, dim=2, key=_gen(seed), precondition="auto",
                   vi_steps=300, vi_batch=256, num_chains=8,
                   num_warmup=200, num_samples=400, dtype=T64)
    assert res.flow is not None
    d = res.diagnostics
    np.testing.assert_allclose(d["mean"], MU, atol=0.15)
    np.testing.assert_allclose(d["sd"], SD, rtol=0.15)
    assert np.all(d["rhat"] < 1.05)
    assert d["min_bulk_ess"] > 0.5 * 8 * 400
    return {"mean": d["mean"], "sd": d["sd"], "max_rhat": d["rhat"].max(),
            "min_bulk_ess": d["min_bulk_ess"],
            "family": d["precondition_family"]}


def data_whitening_preconditioner_multimodal(seed):
    """test_infer.py:69: the data= path on a bimodal pushforward."""
    f_true = et.compose(
        et.ScaleShift(_vec(1.3, 0.4), _vec(2.5, -1.2)),
        et.Householder(_vec(1.0, 0.3)[None]),
        et.CenterStretch(_vec(3.0, 3.1), _vec(2.0, 2.1), _vec(0.0, 0.0)))
    target = et.FlowDistribution(f_true)
    with torch.no_grad():
        X = target.sample(_gen(1000 + seed), (40_000,), dim=2, dtype=T64)
    res = et.infer(target.logpdf, dim=2, key=_gen(seed), data=X,
                   whiten_batches=100, whiten_epochs=6, num_chains=8,
                   num_warmup=300, num_samples=400, dtype=T64)
    assert res.flow is not None
    d = res.diagnostics
    true_mean, true_sd = X.numpy().mean(0), X.numpy().std(0)
    assert np.all(d["rhat"] < 1.05), d["rhat"]
    np.testing.assert_allclose(d["mean"], true_mean,
                               atol=5 * true_sd.max()
                               / np.sqrt(d["min_bulk_ess"]) + 0.05)
    np.testing.assert_allclose(d["sd"], true_sd, rtol=0.15)
    return {"mean_err": np.abs(d["mean"] - true_mean).max(),
            "sd_rel_err": np.abs(d["sd"] / true_sd - 1).max(),
            "max_rhat": d["rhat"].max()}


def refine_rounds(seed):
    """test_infer.py:101: a raw first pass, then one refinement."""
    f_true = et.compose(
        et.ScaleShift(_vec(1.3, 0.4), _vec(2.5, -1.2)),
        et.JohnsonInv(_vec(0.5, -0.3), _vec(2.0, 2.5), _vec(0.0, 0.0),
                      _vec(1.0, 1.5)))
    target = et.FlowDistribution(f_true)
    kw = dict(dim=2, precondition=None, num_chains=8, num_warmup=300,
              num_samples=400, dtype=T64)
    raw = et.infer(target.logpdf, key=_gen(seed), **kw)
    ref = et.infer(target.logpdf, key=_gen(seed), refine_rounds=1, **kw)
    with torch.no_grad():
        X = target.sample(_gen(2000 + seed), (200_000,), dim=2,
                          dtype=T64).numpy()
    d = ref.diagnostics
    assert ref.flow is not None
    assert np.all(d["rhat"] < 1.05)
    np.testing.assert_allclose(d["mean"], X.mean(0),
                               atol=5 * X.std(0).max()
                               / np.sqrt(d["min_bulk_ess"]) + 0.05)
    np.testing.assert_allclose(d["sd"], X.std(0), rtol=0.15)
    assert d["min_bulk_ess"] > 0.55 * 8 * 400
    assert d["min_bulk_ess"] > 0.8 * raw.diagnostics["min_bulk_ess"]
    return {"min_bulk_ess": d["min_bulk_ess"],
            "raw_min_bulk_ess": raw.diagnostics["min_bulk_ess"],
            "max_rhat": d["rhat"].max()}


def coupling_template(seed):
    """test_infer.py:135: a banana through the affine coupling template."""
    def logp(q):
        return -0.5 * q[:, 0] ** 2 \
            - 0.5 * ((q[:, 1] - 0.5 * q[:, 0] ** 2) / 0.5) ** 2

    res = et.infer(logp, dim=2, key=_gen(seed), precondition="auto",
                   flow_template=et.coupling_flow_template(3, (24, 24)),
                   vi_steps=500, vi_batch=512, num_chains=8,
                   num_warmup=300, num_samples=400, dtype=T64)
    assert res.flow is not None
    d = res.diagnostics
    assert d["precondition_family"] == "custom"
    assert np.all(d["rhat"] < 1.05)
    np.testing.assert_allclose(d["mean"], [0.0, 0.5], atol=0.15)
    np.testing.assert_allclose(d["sd"][0], 1.0, rtol=0.15)
    return {"mean": d["mean"], "sd0": d["sd"][0],
            "max_rhat": d["rhat"].max()}


def precondition_kind_forced(seed):
    """test_infer.py:326."""
    res = et.infer(_gauss, dim=2, key=_gen(seed),
                   precondition_kind="affine", vi_steps=200, vi_batch=256,
                   num_chains=8, num_warmup=150, num_samples=300, dtype=T64)
    d = res.diagnostics
    assert d["precondition_family"] == "affine"
    np.testing.assert_allclose(d["mean"], MU, atol=0.2)
    np.testing.assert_allclose(d["sd"], SD, rtol=0.2)
    return {"mean": d["mean"], "sd": d["sd"]}


def test_infer_auto_preconditioned():
    auto_preconditioned(STAT_SEED)


def test_infer_data_whitening_preconditioner_multimodal():
    data_whitening_preconditioner_multimodal(STAT_SEED)


def test_infer_refine_rounds():
    refine_rounds(STAT_SEED)


def test_infer_coupling_template():
    coupling_template(STAT_SEED)


def test_infer_precondition_kind_forced():
    precondition_kind_forced(STAT_SEED)


# ------------------------------------------------------------------
# Not a test: the BASELINE.json configs[3] call in both packages on the CPU
# (ROADMAP C-12), and the statistical gates above over seeds 0-4.

def equicorr_50d_comparison(seed, chains=8, warmup=300, samples=500):
    """``infer(logp, dim=50)`` on bench_mcmc.py:174-181's equicorrelated
    Gaussian (rho 0.9) in float32 with the default ladder (vi_steps=500,
    vi_batch=512) and NUTS at ``chains`` x ``warmup`` + ``samples``, in JAX
    (``PRNGKey(seed)``) and in the port (a CPU generator seeded ``seed``):
    each package's family, k-hat, gap, max rhat, divergences, step size,
    leaves a transition and the draws' largest mean and sd errors."""
    d, rho = 50, 0.9
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    prec = np.linalg.inv(cov).astype(np.float32)
    kw = dict(dim=d, num_chains=chains, num_warmup=warmup,
              num_samples=samples)
    pj = jnp.asarray(prec)
    pt = torch.from_numpy(prec)
    rj = jax_infer(lambda q: -0.5 * q @ pj @ q, key=jax.random.PRNGKey(seed),
                   **kw)
    rt = et.infer(lambda q: -0.5 * ((q @ pt) * q).sum(-1),
                  key=torch.Generator().manual_seed(seed), **kw)
    out = {}
    for name, r in (("jax", rj), ("port", rt)):
        g = r.diagnostics
        x = _np(r.draws).reshape(-1, d).astype(np.float64)
        out[name] = {
            "family": g["precondition_family"],
            "khat": float(g["precondition_khat"]),
            "gap": float(g["precondition_coverage_gap"]),
            "rhat": float(np.max(g["rhat"])),
            "divergences": int(g["divergences"]),
            "step_size": float(_np(r.stats.step_size)),
            "leaves": float(np.mean(_np(r.stats.num_steps))),
            "mean_err": float(np.abs(x.mean(0)).max()),
            "sd_err": float(np.abs(x.std(0) - 1).max())}
    return out


if __name__ == "__main__":
    import sys
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["50d"]:
        # python -m tests.test_torch_infer 50d   (~7 min on 4 cores)
        for seed in (0, 1):
            print(seed, equicorr_50d_comparison(seed), flush=True)
    else:
        # python -m tests.test_torch_infer   (the gates over seeds 0-4)
        for gate in (auto_preconditioned,
                     data_whitening_preconditioner_multimodal,
                     refine_rounds, coupling_template,
                     precondition_kind_forced):
            for seed in range(5):
                print(gate.__name__, seed, gate(seed), flush=True)
