"""The port's coupling bijectors against the JAX package, in float64.

AffineCoupling, Permute, ``rq_spline``, ElementwiseRQSpline,
RQSplineCoupling and the two stack constructors: the same numpy inputs and
weights (carried over with ``from_jax(..., device="cpu")``) go through the
JAX package's jnp path and the port. Values, per-sample ladjs and inverse
round trips agree to 1e-12, gradients to 1e-10: the two frameworks sum in
different orders, nothing more. The identity-initialized stacks are
perturbed first, since a zero last layer makes every forward the identity
and hides faults; the spline stacks only mildly, since a bin squeezed to
its minimum width turns the knots' last-bit differences between the two
frameworks into ~1e-11 differences of the inverse. Spline inputs include
elements outside the bound and points within 1e-9 of a knot.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.bijectors import (
    coupling_stack as jax_coupling_stack, init_affine_coupling as jax_affine,
    init_elementwise_rq_spline as jax_elem_spline,
    init_rq_spline_coupling as jax_spline_coupling,
    spline_coupling_stack as jax_spline_stack)
from enflows_tpu.bijectors.spline import rq_spline as jax_rq_spline

import enflows_tpu_torch as et
from enflows_tpu_torch.bijectors.coupling import ACTIVATIONS
from enflows_tpu_torch.bijectors.spline import rq_spline
from enflows_tpu_torch.interop import from_jax, to_numpy

torch.set_num_threads(1)

F64 = jnp.float64
TOL = 1e-12
GRAD_TOL = 1e-10
ACTS = ("tanh", "gelu", "relu", "silu")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _perturb(tree, seed, scale=0.3):
    """Every leaf plus scale * N(0, 1) noise from a numpy generator."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        tree)


def _key(i):
    return jax.random.PRNGKey(i)


def _spline_inputs(rng, n, d, knots=None, bound=3.0):
    """(n, d) inputs spread over [-1.6 bound, 1.6 bound], some exactly at
    +-bound, and, given knots (d, K+1), a few rows within 1e-9 of them."""
    x = rng.uniform(-1.6 * bound, 1.6 * bound, size=(n, d))
    x[0] = bound
    x[1] = -bound
    if knots is not None:
        K1 = knots.shape[-1]
        for r in range(2, min(n, 2 + 2 * K1)):
            k = (r - 2) // 2
            x[r] = knots[:, k] + (1e-9 if r % 2 else -1e-9)
    return x


_jfwd = jax.jit(lambda b, x: b.forward_and_ladj(x))


def _check_bijector(jb, tb, x, tol=TOL):
    yj, lj = _jfwd(jb, jnp.asarray(x))
    yt, lt = tb.forward_and_ladj(torch.from_numpy(x))
    _close(yt, yj, tol)
    _close(lt, lj, tol)
    assert lt.shape == (x.shape[0],)
    xb, lb = tb.inverse().forward_and_ladj(yt)
    _close(xb, x, 1e-10)
    _close(lb, -lt, 1e-10)
    xbj, _ = _jfwd(jb.inverse(), yj)
    _close(tb.inverse().forward(torch.tensor(np.asarray(yj))), xbj, tol)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("inverted", [False, True])
def test_affine_coupling_matches_jax(act, inverted):
    jc = _perturb(jax_affine(_key(0), 5, hidden=(16, 16), activation=act,
                             dtype=F64), seed=1)
    if inverted:
        jc = jc.inverse()
    tc = from_jax(jc, device="cpu")
    assert isinstance(tc, et.AffineCoupling) and tc.inverted == inverted
    x = np.random.default_rng(2).normal(size=(129, 5)) * 1.5
    _check_bijector(jc, tc, x)


def test_permute_matches_jax():
    jp = ef.Permute(perm=(2, 0, 3, 1, 5, 4))
    tp = from_jax(jp, device="cpu")
    x = np.random.default_rng(3).normal(size=(10, 6))
    _check_bijector(jp, tp, x)
    assert tp.inverse().perm == tuple(jp.inverse().perm)
    assert to_numpy(tp) == {"perm": (2, 0, 3, 1, 5, 4)}


@pytest.mark.parametrize("inverse", [False, True])
def test_rq_spline_function_matches_jax(inverse):
    rng = np.random.default_rng(4)
    d, K, bound = 3, 6, 3.0
    # Raw parameters of moderate spread: a bin at its minimum width
    # amplifies the knots' last-bit differences between the frameworks
    # (each computes its own cumsum) by ~1e4 in the inverse's ladj.
    w, h = rng.normal(size=(2, d, K)) * 0.8
    dr = rng.normal(size=(d, K - 1)) * 0.8
    raw = w if not inverse else h
    probs = np.exp(raw) / np.exp(raw).sum(-1, keepdims=True)
    sizes = 2 * bound * (1e-3 + (1 - 1e-3 * K) * probs)
    knots = np.concatenate([np.full((d, 1), -bound),
                            -bound + np.cumsum(sizes, -1)], -1)
    x = _spline_inputs(rng, 300, d, knots, bound)
    yj, lj = jax.jit(lambda *a: jax_rq_spline(*a, bound=bound,
                                              inverse=inverse))(
        *map(jnp.asarray, (x, w, h, dr)))
    yt, lt = rq_spline(*map(torch.from_numpy, (x, w, h, dr)), bound=bound,
                       inverse=inverse)
    _close(yt, yj)
    _close(lt, lj)
    out = np.abs(x) >= bound
    assert out.any() and (_np(yt)[out] == x[out]).all()
    assert (_np(lt)[out] == 0.0).all()


def test_elementwise_rq_spline_matches_jax():
    je = _perturb(jax_elem_spline(4, 7, bound=2.5, dtype=F64), seed=5,
                  scale=1.0)
    te = from_jax(je, device="cpu")
    assert isinstance(te, et.ElementwiseRQSpline)
    x = _spline_inputs(np.random.default_rng(6), 200, 4, bound=2.5)
    _check_bijector(je, te, x)
    _check_bijector(je.inverse(), from_jax(je.inverse(), device="cpu"), x)


@pytest.mark.parametrize("inverted", [False, True])
def test_rq_spline_coupling_matches_jax(inverted):
    jc = _perturb(jax_spline_coupling(_key(7), 6, hidden=(16,), n_bins=5,
                                      bound=3.0, activation="silu",
                                      dtype=F64), seed=8, scale=0.05)
    if inverted:
        jc = jc.inverse()
    tc = from_jax(jc, device="cpu")
    assert (tc.n_bins, tc.bound, tc.inverted) == (5, 3.0, inverted)
    x = _spline_inputs(np.random.default_rng(9), 257, 6, bound=3.0)
    _check_bijector(jc, tc, x)


def _mixed_chain(dim):
    """ScaleShift -> JohnsonInv -> affine stack -> Permute -> spline stack,
    as coupling_flow_template builds it, perturbed."""
    v = lambda val: jnp.full((dim,), val, F64)
    a = jax_coupling_stack(_key(10), dim, 2, (16, 16), dtype=F64)
    s = jax_spline_stack(_key(11), dim, 2, (12,), n_bins=4, bound=4.0,
                         activation="tanh", dtype=F64)
    chain = ef.Chain.of(ef.ScaleShift(a=v(1.2), b=v(0.1)),
                        ef.JohnsonInv(gamma=v(0.0), delta=v(5.0), xi=v(0.0),
                                      lam=v(5.0)),
                        *a.stages, ef.Permute(perm=(1, 2, 0, 4, 5, 3)),
                        *s.stages)
    return _perturb(chain, seed=12, scale=0.1)


@pytest.mark.parametrize("kind", ["affine", "spline", "mixed"])
def test_stacks_match_jax(kind):
    dim = 6
    if kind == "affine":
        jc = _perturb(jax_coupling_stack(_key(13), dim, 3, (16, 16),
                                         dtype=F64), seed=14, scale=0.1)
    elif kind == "spline":
        jc = _perturb(jax_spline_stack(_key(15), dim, 3, (16,), n_bins=6,
                                       bound=3.0, dtype=F64), seed=16,
                      scale=0.05)
    else:
        jc = _mixed_chain(dim)
    tc = from_jax(jc, device="cpu")
    assert len(tc.stages) == len(jc.stages)
    x = _spline_inputs(np.random.default_rng(17), 300, dim, bound=3.0)
    _check_bijector(jc, tc, x)


def _leaves_by_name(jgrad, tmodule):
    """JAX gradient leaves in the order of the port's named_parameters()."""
    leaves = jax.tree.leaves(jgrad)
    names = [k for k, _ in tmodule.named_parameters()]
    assert len(leaves) == len(names)
    return dict(zip(names, leaves))


@pytest.mark.parametrize("kind", ["affine", "spline", "mixed"])
def test_gradients_match_jax(kind):
    dim = 6
    if kind == "affine":
        jc = _perturb(jax_coupling_stack(_key(18), dim, 2, (16, 16),
                                         activation="gelu", dtype=F64),
                      seed=19, scale=0.1)
    elif kind == "spline":
        jc = _perturb(jax_spline_stack(_key(20), dim, 2, (16,), n_bins=5,
                                       bound=3.0, dtype=F64), seed=21,
                      scale=0.1)
    else:
        jc = _mixed_chain(dim)
    tc = from_jax(jc, device="cpu")
    x = _spline_inputs(np.random.default_rng(22), 200, dim, bound=3.0)

    def jloss(c, xx):
        y, l = c.forward_and_ladj(xx)
        return jnp.sum(jnp.sin(y)) + jnp.sum(l * l)

    gc, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jc, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, l = tc.forward_and_ladj(xt)
    params = dict(tc.named_parameters())
    gs = torch.autograd.grad(torch.sin(y).sum() + (l * l).sum(),
                             [xt, *params.values()])
    _close(gs[0], gxj, GRAD_TOL)
    for (name, g), gj in zip(zip(params, gs[1:]),
                             _leaves_by_name(gc, tc).values()):
        np.testing.assert_allclose(_np(g), _np(gj), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("padded", [False, True])
def test_fused_plan_matches_jax_where_slabs_split(padded):
    """The fused coupling plan at d=40 with K=8 bins, where the last layer
    is lane-grouped into slabs of 8, 8 and 4 half-lanes: the plain version
    through the plan (``padded``: through the kernels' padded plan) against
    JAX's jnp forward and gradients, float64."""
    from enflows_tpu_torch.ops import coupling as TC

    dim = 40
    jc = _perturb(jax_spline_stack(_key(30), dim, 2, (24,), n_bins=8,
                                   bound=3.0, dtype=F64), seed=31, scale=0.05)
    tc = from_jax(jc, device="cpu")
    st = TC._stack_structure(tc, dim)
    assert TC._padded(st).slabs[0] == (8, 184, 3)
    x = _spline_inputs(np.random.default_rng(32), 100, dim, bound=3.0)

    def jloss(c, xx):
        y, l = c.forward_and_ladj(xx)
        return jnp.sum(jnp.sin(y)) + jnp.sum(l * l)

    yj, lj = _jfwd(jc, jnp.asarray(x))
    gc, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jc, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wbuf, pbuf = TC._stack_plan(tc, st, torch.float64, "cpu")
    y, l = TC.coupling_forward_plain(st, wbuf, pbuf, xt, padded=padded)
    y = y[:, list(st.out_map)]
    _close(y, yj)
    _close(l, lj)
    params = dict(tc.named_parameters())
    gs = torch.autograd.grad(torch.sin(y).sum() + (l * l).sum(),
                             [xt, *params.values()])
    _close(gs[0], gxj, GRAD_TOL)
    for (name, g), gj in zip(zip(params, gs[1:]),
                             _leaves_by_name(gc, tc).values()):
        np.testing.assert_allclose(_np(g), _np(gj), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_inverses_share_parameters():
    tc = from_jax(_mixed_chain(6), device="cpu")
    inv = tc.inverse()
    fwd_ids = {id(p) for p in tc.parameters()}
    assert {id(p) for p in inv.parameters()} == fwd_ids
    for s in tc.stages:
        if isinstance(s, (et.AffineCoupling, et.RQSplineCoupling)):
            si = s.inverse()
            assert si.conditioner is s.conditioner
            assert si.inverse().conditioner is s.conditioner
            assert si.inverted != s.inverted
    e = from_jax(_perturb(jax_elem_spline(3, 4, dtype=F64), seed=23),
                 device="cpu")
    assert all(getattr(e.inverse(), f) is getattr(e, f)
               for f in ("w_raw", "h_raw", "d_raw"))
    # A gradient through the inverse lands on the forward's Parameters.
    x = torch.randn(8, 6, dtype=torch.float64)
    inv.forward_and_ladj(x)[1].sum().backward()
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in tc.parameters())


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's gelu to the
    exact erf form. The port asks for the tanh form."""
    u = np.linspace(-4, 4, 101)
    _close(ACTIVATIONS["gelu"](torch.from_numpy(u)), jax.nn.gelu(u))
    exact = torch.nn.functional.gelu(torch.from_numpy(u))
    assert float((ACTIVATIONS["gelu"](torch.from_numpy(u)) - exact)
                 .abs().max()) > 1e-5
    for name in ACTS:
        _close(ACTIVATIONS[name](torch.from_numpy(u)),
               getattr(jax.nn, name)(u))


def test_constructors_default_to_the_card_and_take_a_generator():
    for fn in (et.init_affine_coupling, et.coupling_stack,
               et.init_rq_spline_coupling, et.spline_coupling_stack,
               et.init_elementwise_rq_spline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(from_jax).parameters["device"].default == "cuda"
    a = et.coupling_stack(torch.Generator().manual_seed(0), 6, 3, (8,),
                          device="cpu", dtype=torch.float64)
    b = et.coupling_stack(torch.Generator().manual_seed(0), 6, 3, (8,),
                          device="cpu", dtype=torch.float64)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert pa.device.type == "cpu" and torch.equal(pa, pb)
    # Identity at initialization: the last layer is zero.
    x = torch.randn(5, 6, dtype=torch.float64)
    y, l = a.forward_and_ladj(x)
    assert torch.equal(y, x) and torch.equal(l, torch.zeros(5,
                                                            dtype=l.dtype))
    s = et.spline_coupling_stack(torch.Generator().manual_seed(1), 6, 3,
                                 (8,), n_bins=4, device="cpu",
                                 dtype=torch.float64)
    y, l = s.forward_and_ladj(x)
    _close(y, x)
    _close(l, np.zeros(5))


def test_interop_round_trip_and_bf16_conditioner():
    jc = _mixed_chain(6)
    tc = from_jax(jc, dtype=torch.float32, device="cpu")
    assert all(p.dtype == torch.float32 for p in tc.parameters())
    for sj, st in zip(jc.stages, to_numpy(tc)):
        if isinstance(sj, (ef.AffineCoupling, ef.RQSplineCoupling)):
            for (Wj, bj), (W, b) in zip(sj.conditioner.layers, st["layers"]):
                np.testing.assert_allclose(W, np.asarray(Wj), rtol=1e-6)
                np.testing.assert_allclose(b, np.asarray(bj), rtol=1e-6,
                                           atol=1e-7)
    cond = et.MLPConditioner([(torch.zeros(2, 2), torch.ones(2))],
                             compute_dtype="bfloat16")      # constructs
    out = cond(torch.zeros(3, 2))
    assert out.dtype == torch.float32 and torch.equal(out, torch.ones(3, 2))
    with pytest.raises(ValueError):
        et.MLPConditioner([(torch.zeros(2, 2), torch.zeros(2))],
                          activation="elu")
