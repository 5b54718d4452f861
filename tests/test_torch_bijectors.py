"""The PyTorch port's bijectors against the JAX package, in float64.

The same numpy inputs, made from a seed, go through both packages; weights
cross with ``enflows_tpu_torch.interop.from_jax``. Values, ladjs and inverse
round trips agree to 1e-12; gradients to 1e-10 (the two frameworks sum in
different orders, nothing more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.train import mvnormal_negll as jax_negll
import enflows_tpu_torch as et
from enflows_tpu_torch.bijectors.householder import (
    householder_chain, householder_chain_dense)
from enflows_tpu_torch.interop import from_jax, to_numpy
from enflows_tpu_torch.train import mvnormal_negll

torch.set_num_threads(1)

F64 = jnp.float64
TOL = 1e-12
GRAD_TOL = 1e-10


def _vec(rng, d, lo, hi):
    return jnp.asarray(rng.uniform(lo, hi, size=d), F64)


def _jax_stage(kind, d, rng):
    if kind == "scale_shift":
        return ef.ScaleShift(a=_vec(rng, d, 0.5, 2.0),
                             b=_vec(rng, d, -1.0, 1.0))
    if kind == "scale_shift_scalar":
        return ef.ScaleShift(a=jnp.asarray(1.7, F64), b=jnp.asarray(-0.3, F64))
    if kind == "scale_shift_inverse":
        return ef.invert(ef.ScaleShift(a=_vec(rng, d, 0.5, 2.0),
                                       b=_vec(rng, d, -1.0, 1.0)))
    if kind == "center_stretch":
        return ef.CenterStretch(a=_vec(rng, d, 0.1, 1.0),
                                b=_vec(rng, d, 0.5, 2.5),
                                c=_vec(rng, d, -0.5, 0.5))
    if kind == "center_contract":
        return ef.CenterContract(a=_vec(rng, d, 0.1, 1.0),
                                 b=_vec(rng, d, 0.5, 2.5),
                                 c=_vec(rng, d, -0.5, 0.5))
    if kind == "johnson":
        return ef.Johnson(gamma=_vec(rng, d, -0.5, 0.5),
                          delta=_vec(rng, d, 2.0, 6.0),
                          xi=_vec(rng, d, -0.5, 0.5),
                          lam=_vec(rng, d, 2.0, 6.0))
    if kind == "johnson_inv":
        return ef.JohnsonInv(gamma=_vec(rng, d, -0.5, 0.5),
                             delta=_vec(rng, d, 2.0, 6.0),
                             xi=_vec(rng, d, -0.5, 0.5),
                             lam=_vec(rng, d, 2.0, 6.0))
    if kind == "householder_single":
        return ef.Householder(V=jnp.asarray(rng.normal(size=d), F64))
    mode = kind.split("_")[1]
    return ef.Householder(V=jnp.asarray(rng.normal(size=(3, d)), F64),
                          mode=mode)


KINDS = ["scale_shift", "scale_shift_scalar", "scale_shift_inverse",
         "center_stretch", "center_contract", "johnson", "johnson_inv",
         "householder_single", "householder_scan", "householder_dense",
         "householder_auto"]


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_bijector_matches_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    d = 3
    jb = _jax_stage(kind, d, rng)
    tb = from_jax(jb, device="cpu")
    x = rng.normal(size=(257, d)) * 2.0
    yj, lj = jb.forward_and_ladj(jnp.asarray(x))
    yt, lt = tb.forward_and_ladj(torch.from_numpy(x))
    assert yt.dtype == torch.float64 and lt.shape == (257,)
    _close(yt, yj)
    _close(lt, lj)
    # Inverse: the same values as the JAX inverse, and a round trip.
    xj, ilj = jb.inverse().forward_and_ladj(yj)
    xt, ilt = tb.inverse().forward_and_ladj(yt)
    _close(xt, xj)
    _close(ilt, ilj)
    np.testing.assert_allclose(xt.detach().numpy(), x, rtol=1e-10,
                               atol=1e-10)


def test_chain_protocol():
    rng = np.random.default_rng(0)
    d = 2
    stages = [from_jax(_jax_stage(k, d, rng), device="cpu")
              for k in ("johnson", "center_stretch", "householder_scan")]
    c = et.compose(*stages)
    # compose applies its last argument first; Chain.of flattens and drops
    # Identity.
    assert list(c.stages) == stages[::-1]
    nested = et.Chain.of(et.Chain.of(stages[0], et.Identity()),
                         et.Chain.of(stages[1]), stages[2])
    assert list(nested.stages) == stages
    assert list((stages[0] >> stages[1]).stages) == stages[:2]
    # inverse reverses the stage order, each stage inverted.
    inv = c.inverse()
    assert [type(s) for s in inv.stages] == [
        et.JohnsonInv, et.CenterContract, et.Householder]
    x = torch.from_numpy(rng.normal(size=(64, d)))
    y, ladj = c.forward_and_ladj(x)
    xr, iladj = inv.forward_and_ladj(y)
    np.testing.assert_allclose(xr.detach().numpy(), x.numpy(), atol=1e-10)
    np.testing.assert_allclose((ladj + iladj).detach().numpy(), 0.0,
                               atol=1e-10)
    # An empty chain is the identity with zero ladj.
    y0, l0 = et.Chain.of(et.Identity()).forward_and_ladj(x)
    assert torch.equal(y0, x) and torch.equal(l0, torch.zeros(64,
                                                               dtype=x.dtype))


def test_parameter_sharing():
    rng = np.random.default_rng(1)
    cs = from_jax(_jax_stage("center_stretch", 2, rng), device="cpu")
    cc = et.invert(cs)
    assert cc.a is cs.a and cc.b is cs.b and cc.c is cs.c
    j = from_jax(_jax_stage("johnson", 2, rng), device="cpu")
    assert all(getattr(j.inverse(), f) is getattr(j, f)
               for f in ("gamma", "delta", "xi", "lam"))
    h = from_jax(_jax_stage("householder_scan", 2, rng), device="cpu")
    hi = h.inverse()
    assert hi.V is h.V and hi.inverse().V is h.V
    h1 = from_jax(_jax_stage("householder_single", 2, rng), device="cpu")
    assert h1.inverse() is h1
    # ScaleShift's inverse computes 1/a from the shared Parameter at call
    # time, so a gradient through the inverse lands on the forward's a.
    ss = et.ScaleShift(torch.tensor([2.0, 4.0], dtype=torch.float64),
                       torch.tensor([1.0, -1.0], dtype=torch.float64))
    si = ss.inverse()
    assert si.a is ss.a and si.b is ss.b
    assert set(map(id, et.compose(ss, si).parameters())) == {id(ss.a),
                                                            id(ss.b)}
    si(torch.ones(1, 2, dtype=torch.float64)).sum().backward()
    # d/da of (1 - b)/a is -(1 - b)/a^2.
    np.testing.assert_allclose(ss.a.grad.numpy(), [0.0, -0.125])
    with torch.no_grad():
        ss.a.mul_(2.0)
    np.testing.assert_allclose(si.fields()["a"].detach().numpy(),
                               [0.25, 0.125])


def test_householder_scan_function_matches_dense():
    rng = np.random.default_rng(2)
    V = torch.from_numpy(rng.normal(size=(4, 5))).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(33, 5))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(33, 5)))
    ys = householder_chain(V, x)
    # Only V and the output are kept for the backward.
    assert len(ys.grad_fn.saved_tensors) == 2
    gVs, gxs = torch.autograd.grad((ys * g).sum(), (V, x))
    yd = householder_chain_dense(V, x)
    gVd, gxd = torch.autograd.grad((yd * g).sum(), (V, x))
    _close(ys.detach(), yd.detach())
    _close(gVs, gVd, GRAD_TOL)
    _close(gxs, gxd, GRAD_TOL)


def test_householder_canonicalize_in_place():
    rng = np.random.default_rng(3)
    Vj = jnp.asarray(rng.normal(size=(3, 4)), F64)
    h = from_jax(ef.Householder(V=Vj), device="cpu")
    V_param = h.V
    assert h.canonicalize() is h and h.V is V_param
    _close(h.V.detach(), ef.Householder(V=Vj).canonicalize().V)
    h1 = from_jax(ef.Householder(V=Vj[0]), device="cpu")
    h1.canonicalize()
    _close(h1.V.detach(), ef.Householder(V=Vj[0]).canonicalize().V)


def _flagship(dim):
    from __graft_entry__ import _flagship_flow
    return _flagship_flow(dim, F64)


def _example_2d_model():
    vec = lambda *a: jnp.asarray(a, F64)
    return ef.compose(
        ef.invert(ef.CenterStretch(a=vec(0.3, -0.2), b=vec(1.0, 1.4),
                                   c=vec(0.1, 0.0))),
        ef.invert(ef.Householder(V=vec(0.6, -1.1))),
        ef.ScaleShift(a=vec(1.2, 0.8), b=vec(0.1, -0.3)),
    )


@pytest.mark.parametrize("model", ["flagship", "example_2d"])
def test_gradients_match_jax(model):
    jflow = _flagship(2) if model == "flagship" else _example_2d_model()
    tflow = from_jax(jflow, device="cpu")
    rng = np.random.default_rng(4)
    # Away from exact zeros, where AD of sign(u)*log(|u|+s) and of the 1e-6
    # clamp differs from the analytic derivative.
    x = rng.normal(size=(300, 2)) * 1.5

    def loss_j(f, xx):
        y, ladj = f.forward_and_ladj(xx)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ladj ** 2)

    gfj, gxj = jax.grad(loss_j, argnums=(0, 1))(jflow, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, ladj = tflow.forward_and_ladj(xt)
    loss = torch.sin(y).sum() + (ladj ** 2).sum()
    _close(loss.detach(), loss_j(jflow, jnp.asarray(x)))
    loss.backward()
    _close(xt.grad, gxj, GRAD_TOL)
    for sj, st in zip(gfj.stages, tflow.stages):
        for name, p in st.named_parameters():
            _close(p.grad, getattr(sj, name), GRAD_TOL)
    # The negll gradient too, through the trainer's loss.
    gj = jax.grad(lambda f: jax_negll(f, jnp.asarray(x)))(jflow)
    for p in tflow.parameters():
        p.grad = None
    mvnormal_negll(tflow, torch.from_numpy(x)).backward()
    for sj, st in zip(gj.stages, tflow.stages):
        for name, p in st.named_parameters():
            _close(p.grad, getattr(sj, name), GRAD_TOL)


def test_interop_round_trip():
    jflow = _flagship(3)
    tflow = from_jax(jflow, dtype=torch.float32, device="cpu")
    assert all(p.dtype == torch.float32 for p in tflow.parameters())
    back = to_numpy(tflow.inverse())
    for sj, st in zip(jflow.inverse().stages, back):
        for name, val in st.items():
            np.testing.assert_allclose(val, np.asarray(getattr(sj, name)),
                                       rtol=1e-6)


def test_flow_distribution_logpdf_and_sampling():
    jflow = _example_2d_model()
    tflow = from_jax(jflow, device="cpu")
    dist = et.FlowDistribution(tflow)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 2))
    _close(dist.logpdf(torch.from_numpy(x)).detach(),
           ef.FlowDistribution(jflow).logpdf(jnp.asarray(x)))
    gen = torch.Generator().manual_seed(0)
    xs, lp = dist.sample_and_logpdf(gen, (40,), 2, dtype=torch.float64)
    assert xs.shape == (40, 2)
    _close(lp.detach(), dist.logpdf(xs).detach(), 1e-9)
    a = dist.sample(torch.Generator().manual_seed(7), (5,), 2)
    b = dist.sample(torch.Generator().manual_seed(7), (5,), 2)
    assert a.shape == (5, 2) and torch.equal(a, b)


@pytest.mark.parametrize("k,d,batch,dense", [
    (1, 2, 4096, False), (1, 31, 4096, False), (1, 32, 4, True),
    (2, 2, 4, True), (2, 128, 1 << 20, True), (1, 128, 1, True),
    (2, 129, 4096, False), (64, 129, 4096, False)])
def test_householder_auto_rule_boundary(k, d, batch, dense):
    """mode="auto" takes the dense product for k >= 2, or d >= 32 for one
    reflection, up to d = 128 (the rule set from the card's timings), and
    both routes give the same result there."""
    rng = np.random.default_rng(k + d)
    V = torch.from_numpy(rng.normal(size=(k, d)))
    h = et.Householder(V)
    x = torch.from_numpy(rng.normal(size=(min(batch, 64), d)))
    big = x[:1].expand(batch, d)
    assert h._use_dense(big) is dense
    assert h._use_dense(x[0]) is False           # one sample: the scan
    np.testing.assert_allclose(
        householder_chain(V, x).numpy(),
        householder_chain_dense(V, x).numpy(), rtol=1e-12, atol=1e-12)
