"""The port's flow-VI (train/vi.py) and infer's transport templates against
the JAX package, on the CPU.

The same numpy-made flows and base draws go through both packages. Losses
and every parameter gradient are held in float64 to 1e-10 (the JAX side
runs in f64, tests/conftest.py:22), on elementwise chains, the default
template's structure, affine and spline coupling stacks (plain, and through
the fused wrappers' plain versions), inverted stacks and the coupling
template; and in float32 against JAX's Pallas coupling kernel in interpret
mode, at tests/test_torch_coupling_ops.py's tolerances. The trainers are
held with JAX's own base draws handed to the port through its draw hook
(``train.vi._base_draws``): Adagrad histories to 1e-5 relative (optax puts
its eps inside the square root, torch outside, test_torch_whitening.py),
Adam histories on coupling stacks to 2e-4.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.infer import coupling_flow_template as jax_coupling_template
from enflows_tpu.infer import default_flow_template as jax_default_template
from enflows_tpu.train import neg_elbo as jax_neg_elbo
from enflows_tpu.train import neg_elbo_stl as jax_neg_elbo_stl
from enflows_tpu.train import optimize_elbo as jax_optimize_elbo

import enflows_tpu_torch as et
from enflows_tpu_torch.examples import nf_variational_1d as example
from enflows_tpu_torch.interop import from_jax, to_numpy
from enflows_tpu_torch.ops import coupling as TC
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.train import neg_elbo, neg_elbo_stl, optimize_elbo
from enflows_tpu_torch.train import vi as VI

torch.set_num_threads(1)

F64, F32 = jnp.float64, jnp.float32
TOL64 = 1e-10
_LOG_2PI = 1.8378770664093453


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


# ------------------------------------------------------------------
# Targets: one formula, written for each framework.

def _jlogp(z):
    return -0.5 * jnp.sum(((z - 0.3) / 1.5) ** 2, axis=-1) \
        - 0.01 * jnp.sum(z ** 4, axis=-1)


def _tlogp(z):
    return -0.5 * (((z - 0.3) / 1.5) ** 2).sum(-1) - 0.01 * (z ** 4).sum(-1)


def _jstd(z):
    return -0.5 * jnp.sum(z * z, axis=-1) - 0.5 * z.shape[-1] * _LOG_2PI


def _tstd(z):
    return -0.5 * (z * z).sum(-1) - 0.5 * z.shape[-1] * _LOG_2PI


# ------------------------------------------------------------------
# Flows, made with numpy draws and perturbed off their initialization.

def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        tree)


def _jax_chain(d, seed=0, dtype=F64):
    """An elementwise chain with a two-reflection Householder stage (d > 1),
    an inverted CenterStretch and both Johnson directions."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, d), dtype)
    n = lambda s: jnp.asarray(s * rng.normal(size=d), dtype)
    stages = [ef.ScaleShift(a=u(0.7, 1.4), b=n(0.2)),
              ef.CenterStretch(a=u(0.0, 0.3), b=u(0.8, 1.2), c=n(0.1)),
              ef.JohnsonInv(gamma=n(0.2), delta=u(2.0, 4.0), xi=n(0.1),
                            lam=u(1.0, 2.0))]
    if d > 1:
        stages.append(ef.Householder(
            V=jnp.asarray(rng.normal(size=(2, d)), dtype)).canonicalize())
    stages += [ef.Johnson(gamma=n(0.2), delta=u(2.0, 4.0), xi=n(0.1),
                          lam=u(1.0, 2.0)),
               ef.invert(ef.CenterStretch(a=u(0.0, 0.3), b=u(0.8, 1.2),
                                          c=n(0.1)))]
    return ef.Chain.of(*stages)


def _jax_flow(kind, dtype=F64):
    key = jax.random.PRNGKey(11)
    if kind == "chain":
        return _jax_chain(3, dtype=dtype)
    if kind == "chain_d1":
        return _jax_chain(1, seed=1, dtype=dtype)
    if kind == "default_template":
        return _perturb(jax_default_template(3, key, dtype), seed=2)
    if kind == "affine":
        return _perturb(ef.coupling_stack(key, 4, 2, (8, 8), dtype=dtype), 3)
    if kind == "spline":
        return _perturb(ef.spline_coupling_stack(
            key, 6, 2, (8, 8), n_bins=4, bound=3.0, dtype=dtype), 4)
    if kind == "affine_inverted":
        return _jax_flow("affine", dtype).inverse()
    if kind == "spline_inverted":
        return _jax_flow("spline", dtype).inverse()
    if kind == "coupling_template":
        return _perturb(jax_coupling_template(2, (8, 8))(4, key, dtype), 5)
    raise ValueError(kind)


DIMS = {"chain": 3, "chain_d1": 1, "default_template": 3, "affine": 4,
        "spline": 6, "affine_inverted": 4, "spline_inverted": 6,
        "coupling_template": 4}
CHAINS = ["chain", "chain_d1", "default_template"]
STACKS = ["affine", "spline", "affine_inverted", "spline_inverted",
          "coupling_template"]


def _xi(n, d, seed, dtype=np.float64):
    return np.random.default_rng(100 + seed).normal(size=(n, d)).astype(dtype)


def _named_leaves(jtree, tmodule):
    leaves = jax.tree.leaves(jtree)
    names = [k for k, _ in tmodule.named_parameters()]
    assert len(leaves) == len(names)
    return dict(zip(names, leaves))


def _torch_value_and_grads(loss, flow, xi, route, logp=_tlogp):
    value = loss(flow, logp, torch.from_numpy(xi), route)
    params = dict(flow.named_parameters())
    gs = torch.autograd.grad(value, list(params.values()), allow_unused=True)
    return value, {k: torch.zeros_like(params[k]) if g is None else g
                   for k, g in zip(params, gs)}


@pytest.mark.parametrize("stl", [False, True])
@pytest.mark.parametrize("kind", CHAINS + STACKS)
def test_losses_and_gradients_match_jax(kind, stl):
    """neg_elbo / neg_elbo_stl and every parameter gradient, float64, 1e-10:
    the plain route, and the fused wrapper the flow's kind takes on the card
    (its plain version here) against JAX's route of the same name (for a
    stack, use_fused_coupling=True, which in f64 is JAX's jnp path)."""
    jflow = _jax_flow(kind)
    d = DIMS[kind]
    xi = _xi(48, d, seed=len(kind))
    jloss = jax_neg_elbo_stl if stl else jax_neg_elbo
    loss = neg_elbo_stl if stl else neg_elbo
    fused = kind in STACKS
    jv, jg = jax.jit(jax.value_and_grad(
        lambda f, x: jloss(f, _jlogp, x, fused)))(jflow, jnp.asarray(xi))
    tflow = from_jax(jflow, device="cpu")
    if fused:
        routes = [(loss, False), (loss, True)]
    else:
        # The elementwise route the trainer dispatches a CUDA chain to.
        private = VI._neg_elbo_stl if stl else VI._neg_elbo
        routes = [(loss, False),
                  (lambda f, lp, x, _: private(TE.fused_forward_and_ladj, f,
                                               lp, x), "B1/B2 wrapper")]
    before = (dict(TE.LAUNCHES), dict(TC.LAUNCHES))
    for fn, route in routes:
        v, g = _torch_value_and_grads(fn, tflow, xi, route)
        _close(v, jv, TOL64, f"{kind} route {route} value")
        for name, gj in _named_leaves(jg, tflow).items():
            _close(g[name], gj, TOL64, f"{kind} route {route} grad {name}")
    assert (dict(TE.LAUNCHES), dict(TC.LAUNCHES)) == before


@pytest.mark.parametrize("kind", ["affine", "spline_inverted"])
def test_fused_coupling_losses_match_pallas_interpret(kind):
    """float32: JAX's use_fused_coupling=True reaches its Pallas coupling
    kernel in interpret mode (forward and backward); the port's fused
    wrapper runs its plain version. Values 3e-5 relative, each gradient
    leaf within 2e-4 * (1 + max|g_jax|) (test_torch_coupling_ops.py)."""
    jflow = _jax_flow(kind, F32)
    d = DIMS[kind]
    xi = _xi(32, d, seed=7, dtype=np.float32)
    stl = kind.endswith("inverted")
    jloss = jax_neg_elbo_stl if stl else jax_neg_elbo
    loss = neg_elbo_stl if stl else neg_elbo
    jv, jg = jax.value_and_grad(
        lambda f, x: jloss(f, _jlogp, x, True))(jflow, jnp.asarray(xi))
    tflow = from_jax(jflow, device="cpu")
    v, g = _torch_value_and_grads(loss, tflow, xi, True)
    _close(v, jv, 3e-5, "value")
    for name, gj in _named_leaves(jg, tflow).items():
        err = float(np.abs(_np(g[name]) - np.asarray(gj)).max())
        assert err <= 2e-4 * (1.0 + float(np.abs(gj).max())), (name, err)


# ------------------------------------------------------------------
# The STL estimator's properties (tests/test_stl.py:39-62).

def _identity_spline(route_dtype=torch.float64):
    return et.spline_coupling_stack(torch.Generator().manual_seed(0), 2, 2,
                                    (16,), n_bins=6, dtype=route_dtype,
                                    device="cpu")


@pytest.mark.parametrize("route", [False, True])
def test_stl_gradient_is_pointwise_zero_at_optimum(route):
    """Target N(0, I), flow the exact identity, so q = p: the STL gradient
    vanishes for every single sample; the standard estimator's does not.
    The inverse pass sees its parameters stopped, so none of its
    gradient reaches them."""
    flow = _identity_spline()
    xi = _xi(64, 2, seed=1)
    for rows in (slice(0, 64), slice(0, 1), slice(5, 6), slice(17, 18)):
        _, g = _torch_value_and_grads(neg_elbo_stl, flow, xi[rows], route,
                                      _tstd)
        norm = math.sqrt(sum(float((t * t).sum()) for t in g.values()))
        assert norm < 1e-10, (rows, norm)
    _, g = _torch_value_and_grads(neg_elbo, flow, xi, route, _tstd)
    assert math.sqrt(sum(float((t * t).sum()) for t in g.values())) > 1e-3


def test_stl_value_matches_standard_nelbo():
    """Per batch the STL value is the standard one shifted by the
    empirical-vs-analytic base entropy; the round trip adds only f64
    rounding."""
    tflow = from_jax(_jax_flow("spline"), device="cpu")
    xi = _xi(128, 6, seed=2)
    with torch.no_grad():
        a = float(neg_elbo(tflow, _tlogp, torch.from_numpy(xi)))
        b = float(neg_elbo_stl(tflow, _tlogp, torch.from_numpy(xi)))
    gap = float(_tstd(torch.from_numpy(xi)).mean()) \
        + 0.5 * (_LOG_2PI + 1.0) * 6
    assert abs((b - a) - gap) < 1e-9, (b - a, gap)


def test_stopped_parameters_leave_the_modules_as_they_were():
    """The STL inverse pass runs on detached parameters without copying the
    modules: the flow's Parameters are the same objects afterwards, still
    require gradients, and a second call gives the same value."""
    tflow = from_jax(_jax_flow("default_template"), device="cpu")
    params = {k: p for k, p in tflow.named_parameters()}
    xi = torch.from_numpy(_xi(16, 3, seed=3))
    v1 = neg_elbo_stl(tflow, _tlogp, xi).detach()
    assert {k: p for k, p in tflow.named_parameters()} == params
    assert all(p.requires_grad for p in params.values())
    assert torch.equal(neg_elbo_stl(tflow, _tlogp, xi).detach(), v1)


# ------------------------------------------------------------------
# The trainer, given JAX's base draws.

def _inject_jax_draws(monkeypatch, state):
    """The port's trainer draws what JAX's does at each step:
    normal(fold_in(state['key'], step))."""
    def draws(generator, step, batch_size, dim, dtype, device):
        jdt = F64 if dtype == torch.float64 else F32
        x = jax.random.normal(jax.random.fold_in(state["key"], step),
                              (batch_size, dim), dtype=jdt)
        return torch.from_numpy(np.array(x)).to(device)
    monkeypatch.setattr(VI, "_base_draws", draws)


def _check_params(jflow, tflow, rtol):
    for name, leaf in _named_leaves(jflow, tflow).items():
        _close(dict(tflow.named_parameters())[name], leaf, rtol, name)


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("stl", [False, True])
def test_adagrad_trainer_matches_jax(monkeypatch, antithetic, stl):
    """The default optimizer on an elementwise chain: histories (on the
    standard nELBO scale under STL) to 1e-5, parameters to 1e-5."""
    key = jax.random.PRNGKey(21)
    _inject_jax_draws(monkeypatch, {"key": key})
    jflow = _jax_flow("chain")
    rj = jax_optimize_elbo(_jlogp, jflow, optax.adagrad(0.1), dim=3,
                           batch_size=32, nsteps=6, antithetic=antithetic,
                           key=key, dtype=F64, stl=stl)
    tflow = from_jax(jflow, device="cpu")
    before = {k: p.detach().clone() for k, p in tflow.named_parameters()}
    rt = optimize_elbo(_tlogp, tflow, dim=3, batch_size=32, nsteps=6,
                       antithetic=antithetic, key=torch.Generator(),
                       dtype=torch.float64, stl=stl)
    assert rt.result is not tflow and rt.nelbo_history.shape == (6,)
    for k, p in tflow.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
    np.testing.assert_allclose(rt.nelbo_history.numpy(),
                               np.asarray(rj.nelbo_history), rtol=1e-5)
    _check_params(rj.result, rt.result, 1e-5)


@pytest.mark.parametrize("kind,stl,route", [
    ("affine", False, None), ("spline", False, True),
    ("coupling_template", True, True), ("spline_inverted", False, False)])
def test_adam_trainer_on_coupling_stacks_matches_jax(monkeypatch, kind, stl,
                                                     route):
    """Adam on coupling stacks, histories and parameters to 2e-4: the plain
    route in float64, and the forced fused route (the wrapper's plain
    version; B4/B5 take float32 only) in float32 against JAX's jnp path
    in float32."""
    key = jax.random.PRNGKey(22)
    _inject_jax_draws(monkeypatch, {"key": key})
    jdt, tdt = (F32, torch.float32) if route else (F64, torch.float64)
    jflow = _jax_flow(kind, jdt)
    d = DIMS[kind]
    rj = jax_optimize_elbo(_jlogp, jflow, optax.adam(3e-3), dim=d,
                           batch_size=16, nsteps=5, key=key, dtype=jdt,
                           stl=stl, use_fused_coupling=False)
    before = (dict(TE.LAUNCHES), dict(TC.LAUNCHES))
    rt = optimize_elbo(_tlogp, from_jax(jflow, device="cpu"),
                       lambda p: torch.optim.Adam(p, lr=3e-3), dim=d,
                       batch_size=16, nsteps=5, key=torch.Generator(),
                       dtype=tdt, stl=stl, use_fused_coupling=route)
    assert (dict(TE.LAUNCHES), dict(TC.LAUNCHES)) == before
    np.testing.assert_allclose(rt.nelbo_history.numpy(),
                               np.asarray(rj.nelbo_history), rtol=2e-4,
                               atol=2e-4)
    _check_params(rj.result, rt.result, 2e-4)


def test_resume_matches_jax(monkeypatch):
    """Two runs, the second given the first's result, optimizer state and
    history, against JAX's two runs on the same draws."""
    state = {"key": jax.random.PRNGKey(23)}
    _inject_jax_draws(monkeypatch, state)
    jflow = _jax_flow("chain")
    kw = dict(dim=3, batch_size=16, dtype=F64)
    j1 = jax_optimize_elbo(_jlogp, jflow, optax.adagrad(0.1), nsteps=4,
                           key=state["key"], **kw)
    t1 = optimize_elbo(_tlogp, from_jax(jflow, device="cpu"), dim=3,
                       batch_size=16, nsteps=4, key=torch.Generator(),
                       dtype=torch.float64)
    state["key"] = jax.random.PRNGKey(24)
    j2 = jax_optimize_elbo(_jlogp, j1.result, optax.adagrad(0.1), nsteps=3,
                           key=state["key"], opt_state=j1.optimizer_state,
                           nelbo_history=j1.nelbo_history, **kw)
    t2 = optimize_elbo(_tlogp, t1.result, dim=3, batch_size=16, nsteps=3,
                       key=torch.Generator(), dtype=torch.float64,
                       opt_state=t1.optimizer_state,
                       nelbo_history=t1.nelbo_history)
    assert t2.nelbo_history.shape == (7,)
    np.testing.assert_allclose(t2.nelbo_history.numpy(),
                               np.asarray(j2.nelbo_history), rtol=1e-5)
    _check_params(j2.result, t2.result, 1e-5)


def test_resume_equals_one_run():
    """With the port's own draws: a run of 5 steps equals a run of 3 then,
    on the same generator, a resumed run of 2."""
    jflow = _jax_flow("affine")
    adam = lambda p: torch.optim.Adam(p, lr=3e-3)
    kw = dict(dim=4, batch_size=16, dtype=torch.float64)
    full = optimize_elbo(_tlogp, from_jax(jflow, device="cpu"), adam,
                         nsteps=5, key=torch.Generator().manual_seed(3), **kw)
    gen = torch.Generator().manual_seed(3)
    part = optimize_elbo(_tlogp, from_jax(jflow, device="cpu"), adam,
                         nsteps=3, key=gen, **kw)
    rest = optimize_elbo(_tlogp, part.result, adam, nsteps=2, key=gen,
                         opt_state=part.optimizer_state,
                         nelbo_history=part.nelbo_history, **kw)
    np.testing.assert_allclose(rest.nelbo_history.numpy(),
                               full.nelbo_history.numpy(), rtol=1e-12)
    for a, b in zip(rest.result.parameters(), full.result.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-12)


# ------------------------------------------------------------------
# Dispatch.

def test_cpu_batch_launches_nothing():
    """The default dispatch of a CPU batch is the plain path, for a
    coupling stack and an elementwise chain alike; forcing the fused
    coupling route, or taking the route a CUDA batch of the chain takes,
    runs the wrapper's plain version, with the same result."""
    before = (dict(TE.LAUNCHES), dict(TC.LAUNCHES))
    jflow = _jax_flow("affine", F32)
    runs = [optimize_elbo(_tlogp, from_jax(jflow, device="cpu"), dim=4,
                          batch_size=16, nsteps=3,
                          key=torch.Generator().manual_seed(1),
                          use_fused_coupling=r)
            for r in (None, True)]
    np.testing.assert_allclose(runs[1].nelbo_history.numpy(),
                               runs[0].nelbo_history.numpy(), rtol=1e-5)
    chain = from_jax(_jax_flow("chain", F32), device="cpu")
    xi = torch.from_numpy(_xi(16, 3, seed=8, dtype=np.float32))
    on_card = VI._route(chain, 3, torch.float32, torch.device("cuda"), None,
                        16)
    assert on_card is TE.fused_forward_and_ladj
    for private in (VI._neg_elbo, VI._neg_elbo_stl):
        vals = [private(fwd, chain, _tlogp, xi)
                for fwd in (VI._route(chain, 3, torch.float32,
                                      torch.device("cpu"), None, 16),
                            on_card)]
        _close(vals[1], vals[0], 1e-5, private.__name__)
    assert (dict(TE.LAUNCHES), dict(TC.LAUNCHES)) == before


def test_dispatch_rule():
    """On a CUDA device a fusible coupling stack takes B4/B5 at the batches
    ``ops.coupling.coupling_batch_held`` admits (at least 2^17 rows, at
    least 50 wide: ROADMAP C-3) and the plain path at the others; a fusible
    elementwise chain takes B1/B2 at any size; other flows, other dtypes
    and CPU batches the plain path; True forces B4/B5."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    stack = from_jax(_jax_flow("affine", F32), device="cpu")
    wide = et.coupling_stack(torch.Generator(), 50, 2, (8,), device="cpu")
    chain = from_jax(_jax_flow("chain", F32), device="cpu")
    odd = et.coupling_stack(torch.Generator(), 5, 2, (8,), device="cpu")
    f32 = torch.float32
    plain = VI._plain_forward
    assert VI._route(wide, 50, f32, cuda, None, 1 << 17) is \
        VI._fused_coupling_forward
    for rows in (16, (1 << 17) - 1):
        assert VI._route(wide, 50, f32, cuda, None, rows) is plain
    for rows in (16, 1 << 20):
        assert VI._route(stack, 4, f32, cuda, None, rows) is plain
        assert VI._route(chain, 3, f32, cuda, None, rows) is \
            TE.fused_forward_and_ladj
        assert VI._route(odd, 5, f32, cuda, None, rows) is plain
        assert VI._route(wide, 50, torch.float64, cuda, None, rows) is plain
        for flow, d in ((stack, 4), (wide, 50), (chain, 3)):
            assert VI._route(flow, d, f32, cpu, None, rows) is plain
            assert VI._route(flow, d, f32, cuda, False, rows) is plain
        assert VI._route(stack, 4, f32, cpu, True, rows) is \
            VI._fused_coupling_forward


def test_forced_fused_route_on_a_flow_it_cannot_take_raises():
    """use_fused_coupling=True on a flow B4 does not take raises
    ValueError, as optimize_whitening(use_fused=...) does. This diverges
    from JAX, whose True falls back to the jnp path silently
    (vi.py:181-182)."""
    jflow = _jax_flow("chain")
    rj = jax_optimize_elbo(_jlogp, jflow, optax.adagrad(0.1), dim=3,
                           batch_size=8, nsteps=1, dtype=F64,
                           use_fused_coupling=True)
    assert np.isfinite(np.asarray(rj.nelbo_history)).all()
    with pytest.raises(ValueError, match="coupling stack"):
        optimize_elbo(_tlogp, from_jax(jflow, device="cpu"), dim=3,
                      batch_size=8, nsteps=1, key=torch.Generator(),
                      dtype=torch.float64, use_fused_coupling=True)


@pytest.mark.parametrize("option,item", [
    ("mesh", "A.10"), ("metrics", "A.11"), ("checkpoint_every", "A.11"),
    ("ckpt_dir", "A.11")])
def test_unported_options_raise(option, item, tmp_path):
    """``mesh=``, which raised until ROADMAP A.10 was ported, now runs: on
    a one-rank mesh it gives the unsharded run bit for bit
    (tests/test_torch_parallel_train.py holds 2 and 4 ranks to JAX); the
    A.11 keywords, which raised until A.11 was ported, also run
    (tests/test_torch_utils.py holds them to JAX). The name is the one the
    test had while all raised."""
    flow = et.ScaleShift(torch.ones(2), torch.zeros(2))
    if item == "A.10":
        mesh = et.parallel.make_mesh({"batch": 1}, device="cpu")
        got, want = (optimize_elbo(_tlogp, flow, dim=2, nsteps=3,
                                   batch_size=8, key=torch.Generator()
                                   .manual_seed(5), **kw)
                     for kw in ({option: mesh}, {}))
        assert torch.equal(got.nelbo_history, want.nelbo_history)
        return
    value = {"metrics": et.utils.MetricsLogger(None),
             "checkpoint_every": 1, "ckpt_dir": str(tmp_path)}[option]
    res = optimize_elbo(_tlogp, flow, dim=2, nsteps=2, batch_size=8,
                        key=torch.Generator(), **{option: value})
    assert res.nelbo_history.shape == (2,)
    if option == "metrics":
        assert [r["step"] for r in value.history] == [0, 1]
    if option == "ckpt_dir":
        assert et.utils.latest_step(str(tmp_path)) == 2


# ------------------------------------------------------------------
# Templates.

def _same_elementwise(tstage, jstage):
    for name, val in to_numpy(tstage).items():
        _close(val, getattr(jstage, name), 1e-15, type(tstage).__name__)


def test_default_template_matches_jax():
    """Stage by stage: the same kinds in the same order with the same
    parameters; the reflections are drawn from the generator and
    canonicalized (unit rows). With JAX's reflections carried over the
    two transports agree to 1e-12."""
    jt = jax_default_template(5, jax.random.PRNGKey(3), F64)
    tt = et.default_flow_template(5, torch.Generator().manual_seed(3),
                                  torch.float64)
    assert [type(s).__name__ for s in tt.stages] == \
        [type(s).__name__ for s in jt.stages]
    for ts, js in zip(tt.stages, jt.stages):
        if isinstance(ts, et.Householder):
            assert ts.V.shape == (4, 5)
            _close((ts.V * ts.V).sum(-1), np.ones(4), 1e-12)
            with torch.no_grad():
                ts.V.copy_(torch.from_numpy(np.array(js.V)))
        else:
            _same_elementwise(ts, js)
    x = _xi(64, 5, seed=9)
    yj, lj = jt.forward_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        y, ladj = tt.forward_and_ladj(torch.from_numpy(x))
    _close(y, yj, 1e-12)
    _close(ladj, lj, 1e-12)


@pytest.mark.parametrize("kind", ["affine", "spline"])
def test_coupling_template_matches_jax(kind):
    """The coupling template's stages against JAX's: ScaleShift, JohnsonInv,
    the couplings with their reversal Permutes, ScaleShift; the same
    conditioner shapes, zeroed last layers and biases, so the identity
    initialization; with JAX's weights carried over, the same map."""
    factory = dict(n_layers=3, hidden=(8, 8), kind=kind, n_bins=5,
                   bound=4.0)
    jt = jax_coupling_template(**factory)(6, jax.random.PRNGKey(4), F64)
    tt = et.coupling_flow_template(**factory)(
        6, torch.Generator().manual_seed(4), torch.float64)
    assert [type(s).__name__ for s in tt.stages] == \
        [type(s).__name__ for s in jt.stages]
    for ts, js in zip(tt.stages, jt.stages):
        if isinstance(ts, et.Permute):
            assert ts.perm == tuple(js.perm)
        elif isinstance(ts, (et.AffineCoupling, et.RQSplineCoupling)):
            assert ts.split == js.split and ts.inverted == js.inverted
            if kind == "spline":
                assert (ts.n_bins, ts.bound) == (js.n_bins, js.bound)
            layers = ts.conditioner.layers
            for dense, (W, b) in zip(layers, js.conditioner.layers):
                assert tuple(dense.W.shape) == W.shape
                _close(dense.b, b, 0.0)
                with torch.no_grad():
                    dense.W.copy_(torch.from_numpy(np.array(W)))
            _close(layers[-1].W, np.zeros(layers[-1].W.shape), 0.0)
        else:
            _same_elementwise(ts, js)
    x = _xi(64, 6, seed=10)
    yj, lj = jt.forward_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        y, ladj = tt.forward_and_ladj(torch.from_numpy(x))
    _close(y, yj, 1e-12)
    _close(ladj, lj, 1e-12)


def test_template_edges():
    """dim 1 falls back to the default template (no Householder); a bad
    kind raises ValueError; every module lies on the generator's device;
    the BASELINE-width template is a fusible coupling stack."""
    gen = torch.Generator().manual_seed(0)
    jt = jax_coupling_template()(1, jax.random.PRNGKey(0), F64)
    tt = et.coupling_flow_template()(1, gen, torch.float64)
    assert [type(s).__name__ for s in tt.stages] == \
        [type(s).__name__ for s in jt.stages]
    assert not any(isinstance(s, et.Householder) for s in tt.stages)
    with pytest.raises(ValueError):
        jax_coupling_template(kind="maf")
    with pytest.raises(ValueError, match="affine"):
        et.coupling_flow_template(kind="maf")
    for flow in (et.default_flow_template(4, gen),
                 et.coupling_flow_template(2, (8,), kind="spline")(4, gen)):
        assert {p.device for p in flow.parameters()} == {gen.device}
        assert {p.dtype for p in flow.parameters()} == {torch.float32}
    assert TE.is_fusible_chain(et.default_flow_template(50, gen), 50)
    wide = et.coupling_flow_template(4, (512, 512))(64, gen)
    assert TC.is_fusible_coupling_stack(wide, 64)


# ------------------------------------------------------------------
# The fused coupling backward without weight gradients.

def test_stopped_weights_give_the_same_input_gradient():
    """Through the fused coupling wrapper's plain version, the input
    gradient of an inverted stack with its parameters stopped (STL's
    inverse pass) equals the one with live parameters, and no parameter
    receives a gradient."""
    tflow = from_jax(_jax_flow("spline"), device="cpu").inverse()
    x = torch.from_numpy(_xi(40, 6, seed=11)).requires_grad_(True)
    gy = torch.from_numpy(_xi(40, 6, seed=12))
    fwd = lambda f, u: TC.fused_coupling_forward_and_ladj(f, u)
    y, ladj = fwd(tflow, x)
    gx_live, = torch.autograd.grad((y * gy).sum() + ladj.sum(), x)
    y, ladj = VI._with_stopped_parameters(fwd, tflow, x)
    gx_stopped, = torch.autograd.grad((y * gy).sum() + ladj.sum(), x)
    assert torch.equal(gx_stopped, gx_live)
    assert all(p.grad is None for p in tflow.parameters())


def test_b5_skips_its_weight_gradients_when_no_parameter_wants_one():
    """The wrapper's structure (the kernels do not run here): B4 writes
    B5's rows whenever any input wants a gradient, x's alone included;
    B5's backward runs its sweep (which writes gx) unconditionally, skips
    the weight-gradient reduction when neither plan buffer wants a
    gradient, and counts one launch either way."""
    fwd = inspect.getsource(TC._FusedCoupling.forward)
    assert "any(ctx.needs_input_grad[:3])" in fwd
    bwd = inspect.getsource(TC._FusedCoupling.backward)
    assert "weights=any(ctx.needs_input_grad[1:3])" in bwd
    src = inspect.getsource(TC._launch_bwd)
    sweep = src.index("lib.enf_coupling_bwd(")
    skip = src.index("if not weights:\n                continue")
    dw = src.index("lib.enf_coupling_dw(")
    count = src.index('LAUNCHES["coupling_bwd"] += 1')
    assert sweep < skip < dw < count
    assert src.count("LAUNCHES[") == 1
    assert "if not weights:\n        return gx, None, None" in src[count:]


def test_b5_is_asked_for_weight_gradients_only_when_a_parameter_wants_one(
        monkeypatch):
    """The fused coupling Function with its two launches replaced by
    recorders (the kernels do not run here): B4 is asked to write B5's
    rows when x alone wants a gradient as when the parameters do, and B5
    is asked for weight gradients exactly when a plan buffer wants one."""
    calls = []

    def fwd(st, x, wbuf, pbuf, save=False):
        calls.append(("B4", save))
        y, ladj = TC.coupling_forward_plain(st, wbuf, pbuf, x)
        return y, ladj, "rows" if save else None

    def bwd(st, x, wbuf, pbuf, gy, gl, saved=None, weights=True):
        calls.append(("B5", saved, weights))
        zero = lambda t: torch.zeros_like(t) if weights else None
        return torch.zeros_like(x), zero(wbuf), zero(pbuf)
    monkeypatch.setattr(TC, "_launch_fwd", fwd)
    monkeypatch.setattr(TC, "_launch_bwd", bwd)
    flow = from_jax(_jax_flow("coupling_template", F32), device="cpu")
    st = TC._stack_structure(flow, 4)
    wbuf, pbuf = TC._stack_plan(flow, st, torch.float32, torch.device("cpu"))
    assert wbuf.numel() and pbuf.numel()
    x = torch.from_numpy(_xi(8, 4, seed=13, dtype=np.float32))
    for live in (True, False):
        xr = x.clone().requires_grad_(True)
        bufs = [b.detach().requires_grad_(live) for b in (wbuf, pbuf)]
        calls.clear()
        y, ladj = TC._FusedCoupling.apply(xr, *bufs, st, False, True)
        gs = torch.autograd.grad(y.sum() + ladj.sum(),
                                 [xr] + (bufs if live else []))
        assert calls == [("B4", True), ("B5", "rows", live)]
        assert len(gs) == (3 if live else 1)


# ------------------------------------------------------------------
# The port-side example (examples/nf_variational_1d.py).

def test_variational_1d_example():
    """The JAX test's fit (tests/test_training.py:110-147: Adagrad(0.2), 800
    steps of 100 antithetic pairs) with the port's own generator, under
    its statistical gates."""
    before = dict(TE.LAUNCHES)
    res = example.fit(torch.Generator().manual_seed(4), nsteps=800, lr=0.2)
    assert TE.LAUNCHES == before
    mean, var = example.pushforward_moments(
        res.result, torch.Generator().manual_seed(5), n=50000)
    assert abs(mean - example.MEAN_TRUE) < 0.3, mean
    assert abs(var - example.VAR_TRUE) < 1.2, (var, example.VAR_TRUE)
    hist = res.nelbo_history.numpy()
    assert hist[-1] < hist[0] - 1.0
    assert hist[-50:].mean() < 0.5
    assert abs(example.MEAN_TRUE - 2.9) < 1e-12
