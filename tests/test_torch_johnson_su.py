"""The port's JohnsonSU, Johnson derivative helpers and ``param_dtype``
against the JAX package in float64, and against the reference's golden
constants (tests/test_reference_golden.py, test_bijector_elementwise.py).

The same numpy inputs, made from a seed, go through both packages. Values
agree to 1e-12 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.bijectors import johnson as JJ
import enflows_tpu_torch as et
from enflows_tpu_torch.bijectors import johnson as TJ
from enflows_tpu_torch.bijectors.center_stretch import (
    center_contract, center_contract_ladj, center_stretch)

torch.set_num_threads(1)

F64 = jnp.float64
TOL = 1e-12
PARAMS = [(10.0, 3.5, 10.0, 1.0), (-15.0, 6.5, 0.0, 2.5),
          (0.3, 2.5, -0.4, 1.7)]
METHODS = ["logpdf", "pdf", "cdf", "logcdf", "ccdf", "logccdf", "quantile"]


def _t(v):
    return torch.as_tensor(np.array(v, np.float64))


def _pair(params):
    jd = ef.JohnsonSU.init(*params, dtype=F64)
    td = et.JohnsonSU.init(*params, dtype=torch.float64, device="cpu")
    return jd, td


def _inputs(method, jd, seed):
    rng = np.random.default_rng(seed)
    if method == "quantile":
        return rng.uniform(0.001, 0.999, size=257)
    # Draws from the distribution itself, through its quantile: x where the
    # density and both tails are far from underflow.
    return np.asarray(jd.quantile(jnp.asarray(
        rng.uniform(1e-4, 1 - 1e-4, size=257), F64)))


@pytest.mark.parametrize("params", PARAMS, ids=lambda p: f"g{p[0]}")
@pytest.mark.parametrize("method", METHODS)
def test_johnson_su_method_matches_jax(method, params):
    jd, td = _pair(params)
    x = _inputs(method, jd, METHODS.index(method))
    want = np.asarray(getattr(jd, method)(jnp.asarray(x, F64)))
    got = getattr(td, method)(_t(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)


@pytest.mark.parametrize("params", PARAMS, ids=lambda p: f"g{p[0]}")
def test_johnson_su_moments_match_jax(params):
    jd, td = _pair(params)
    for name in ("mean", "median", "var", "location", "scale"):
        np.testing.assert_allclose(float(getattr(td, name)()),
                                   float(getattr(jd, name)()), rtol=TOL,
                                   err_msg=name)
    assert [float(v) for v in td.params()] == [float(v)
                                              for v in jd.params()]
    assert td.minimum() == jd.minimum() == -np.inf
    assert td.maximum() == jd.maximum() == np.inf


def test_johnson_su_sample_matches_jax_given_draws():
    """``sample`` is the inverse transform of the generator's normals:
    JAX's sample given the same normals, bit for bit in f64."""
    jd, td = _pair(PARAMS[1])
    gen = torch.Generator().manual_seed(3)
    got = td.sample(gen, (4, 5))
    z = torch.randn(4, 5, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    want = np.asarray(JJ.johnson_inverse(jnp.asarray(z.numpy()), *(
        jnp.asarray(p, F64) for p in PARAMS[1])))
    assert got.shape == (4, 5) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)


def test_johnson_su_init_defaults_and_device():
    td = et.JohnsonSU.init(device="cpu")
    assert [float(v) for v in td.params()] == [10.0, 3.5, 10.0, 1.0]
    assert td.gamma.dtype == torch.float32 and td.gamma.device.type == "cpu"
    assert et.param_dtype(td) == torch.float32
    assert et.JohnsonSU is et.distributions.JohnsonSU


def test_johnson_su_sampler_vs_transform_reference_params():
    """The reference's JohnsonSU(-15, 6.5, 0, 2.5) statistical check
    (tests/test_reference_golden.py:125-136)."""
    n = 10**6
    td = et.JohnsonSU.init(-15.0, 6.5, 0.0, 2.5, dtype=torch.float64,
                           device="cpu")
    K = torch.randn(n, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    K_joh = TJ.johnson_inverse(K, *(_t(p) for p in (-15.0, 6.5, 0.0, 2.5)))
    X = td.sample(torch.Generator().manual_seed(1), (n,))
    m1 = float(torch.sort(K_joh.abs()).values.mean())
    m2 = float(torch.sort(X.abs()).values.mean())
    np.testing.assert_allclose(m1, m2, rtol=0.01)


# ---------------------------------------------------------------------------
# The reference's golden constants (tests/test_reference_golden.py:24-125).

def test_center_stretch_golden_values():
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    y = center_stretch(f32(1.0), f32(7.0), f32(2.0), f32(4.0))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(float(y), 11.927293, rtol=1e-5)
    x = center_contract(f32(12.0), f32(7.0), f32(2.0), f32(4.0))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(float(x), 1.063464, rtol=1e-5)


def test_center_stretch_scalar_round_trip_bulk():
    X = np.random.default_rng(0).normal(size=1000)
    a, b, c = _t(7.0), _t(2.0), _t(4.0)
    X2 = center_contract(center_stretch(_t(X), a, b, c), a, b, c)
    np.testing.assert_allclose(X2.numpy(), X, rtol=1e-6, atol=1e-6)


def test_center_contract_ladj_derivative_identity():
    a, b, c = _t(4.0), _t(2.0), _t(3.0)
    x = _t(4.2).requires_grad_()
    l = center_contract_ladj(x.detach(), a, b, c)
    (d,) = torch.autograd.grad(center_contract(x, a, b, c), x)
    np.testing.assert_allclose(float(l), float(torch.log(d.abs())),
                               rtol=0.01)
    y = center_contract(x.detach(), a, b, c).requires_grad_()
    (ds,) = torch.autograd.grad(center_stretch(y, a, b, c), y)
    np.testing.assert_allclose(float(-l), float(torch.log(ds.abs())),
                               rtol=0.01)


def test_johnson_golden_values():
    args = [_t(v) for v in (1.0, 3.0, -4.0, 0.5)]
    np.testing.assert_allclose(float(TJ.johnson_forward(_t(0.3), *args)),
                               9.544817734776984, rtol=1e-12)
    np.testing.assert_allclose(float(TJ.johnson_inverse(_t(0.3), *args)),
                               -4.1177281942392545, rtol=1e-12)


def test_johnson_ladj_derivative_identity():
    args = [_t(v) for v in (4.2, 4.0, 2.0, 3.0)]
    for value, primal in ((TJ.johnson_ladj, TJ.johnson_forward),
                          (TJ.johnson_inv_ladj, TJ.johnson_inverse)):
        x = _t(0.5).requires_grad_()
        (d,) = torch.autograd.grad(primal(x, *args), x)
        np.testing.assert_allclose(float(value(x.detach(), *args)),
                                   float(torch.log(d.abs())), rtol=0.01)


def test_johnson_round_trip_bulk():
    K = np.random.default_rng(1).normal(size=10000)
    args = [_t(v) for v in (-2.0, 1.0, 0.0, 2.5)]
    K2 = TJ.johnson_forward(TJ.johnson_inverse(_t(K), *args), *args)
    np.testing.assert_allclose(K2.numpy(), K, rtol=1e-9, atol=1e-9)


@torch.no_grad()
def test_struct_ladj_exact_argument_identities():
    a, b, c = _t([4.0, 4.1]), _t([2.0, 2.1]), _t([3.0, 3.1])
    x = _t([4.2, 4.3])
    y, ladj = et.CenterStretch(a, b, c).forward_and_ladj(x)
    np.testing.assert_array_equal(y.numpy(),
                                  center_stretch(x, a, b, c).numpy())
    np.testing.assert_allclose(
        float(ladj), float(-center_contract_ladj(y, a, b, c).sum()),
        rtol=1e-12)
    x2 = _t([11.0, 11.5])
    _, ladj2 = et.CenterContract(a, b, c).forward_and_ladj(x2)
    np.testing.assert_allclose(
        float(ladj2), float(center_contract_ladj(x2, a, b, c).sum()),
        rtol=1e-12)
    p = [_t([4.0, 4.1]), _t([3.0, 3.1]), _t([2.0, 2.1]), _t([1.0, 1.1])]
    x3 = _t([0.5, 0.6])
    y3, l3 = et.Johnson(*p).forward_and_ladj(x3)
    np.testing.assert_array_equal(y3.numpy(),
                                  TJ.johnson_forward(x3, *p).numpy())
    np.testing.assert_allclose(float(l3),
                               float(TJ.johnson_ladj(x3, *p).sum()),
                               rtol=1e-12)
    _, l4 = et.JohnsonInv(*p).forward_and_ladj(x3)
    np.testing.assert_allclose(float(l4),
                               float(TJ.johnson_inv_ladj(x3, *p).sum()),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# The derivative helpers and param_dtype
# (tests/test_bijector_elementwise.py:153-210).

@pytest.mark.parametrize("helper,primal,ladj", [
    ("johnson_deriv", "johnson_forward", "johnson_ladj"),
    ("johnson_inv_deriv", "johnson_inverse", "johnson_inv_ladj")])
def test_johnson_deriv_helpers(helper, primal, ladj):
    """Each helper against autograd of the primal map, exp(ladj), and the
    JAX helper, on the same f64 inputs."""
    p = (0.3, 2.5, -0.4, 1.7)
    x = np.linspace(-4.0, 4.0, 23)
    args = [_t(v) for v in p]
    got = getattr(et.bijectors, helper)(_t(x), *args)
    xt = _t(x).requires_grad_()
    (ad,) = torch.autograd.grad(getattr(TJ, primal)(xt, *args).sum(), xt)
    np.testing.assert_allclose(got.numpy(), ad.numpy(), rtol=TOL)
    np.testing.assert_allclose(
        got.numpy(), np.exp(getattr(et.bijectors, ladj)(_t(x), *args)
                            .numpy()), rtol=TOL)
    want = getattr(JJ, helper)(jnp.asarray(x, F64), *p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


def test_param_dtype_matches_jax():
    from enflows_tpu import param_dtype as jax_param_dtype

    def both(jtree, ttree):
        return str(jax_param_dtype(jtree)), str(et.param_dtype(ttree))

    j32 = ef.Johnson.init(dtype=jnp.float32)
    t32 = et.Johnson(*(torch.tensor(v, dtype=torch.float32)
                       for v in (10.0, 3.5, 10.0, 1.0)))
    assert both(j32, t32) == ("float32", "torch.float32")
    j64 = ef.Johnson.init(dtype=F64)
    t64 = et.Johnson(*(torch.tensor(v, dtype=torch.float64)
                       for v in (10.0, 3.5, 10.0, 1.0)))
    assert both(j64, t64) == ("float64", "torch.float64")
    mixed_j = ef.CenterStretch(a=jnp.float32(1.0), b=jnp.float64(2.0),
                               c=jnp.float32(0.0))
    mixed_t = et.CenterStretch(torch.tensor(1.0),
                               torch.tensor(2.0, dtype=torch.float64),
                               torch.tensor(0.0))
    assert both(mixed_j, mixed_t) == ("float64", "torch.float64")
    # Containers, buffers, non-floating leaves and the empty default.
    assert et.param_dtype({"a": [t32, torch.arange(3)],
                           "b": (torch.zeros(2, dtype=torch.float16),)}) \
        == torch.float32
    assert et.param_dtype(torch.zeros(2, dtype=torch.bfloat16)) \
        == torch.bfloat16
    assert both((), []) == ("float32", "torch.float32")
    assert et.param_dtype(et.JohnsonSU.init(dtype=torch.float64,
                                            device="cpu")) == torch.float64


def test_exports_match_jax():
    import enflows_tpu.bijectors as jb
    import enflows_tpu.distributions as jdist

    for name in ("johnson_ladj", "johnson_inv_ladj", "johnson_deriv",
                 "johnson_inv_deriv"):
        assert name in jb.__all__ and name in et.bijectors.__all__, name
        assert callable(getattr(et.bijectors, name))
    assert "JohnsonSU" in jdist.__all__ and \
        "JohnsonSU" in et.distributions.__all__
    assert et.JohnsonSU is et.distributions.JohnsonSU
    assert et.param_dtype is et.utils.param_dtype
