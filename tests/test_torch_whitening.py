"""The port's whitening trainer against the JAX package's, in float64.

Both trainers fit the flagship flow on the same numpy data. The port's
default optimizer is torch's Adagrad with optax.adagrad(0.1)'s learning rate
and initial accumulator; torch adds its eps outside the square root
(g / (sqrt(acc) + 1e-10)) where optax adds it inside (g * rsqrt(acc + 1e-7)),
which moves each update by at most 5e-7 relative. That, not the arithmetic,
sets the tolerance: histories agree to 1e-5 relative, trained parameters to
1e-5.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.train import optimize_whitening as jax_optimize_whitening

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax, to_numpy
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.train import (
    mvnormal_negll, mvnormal_negll_fused, optimize_whitening)

torch.set_num_threads(1)

F64 = jnp.float64


def _flagship():
    from __graft_entry__ import _flagship_flow
    return _flagship_flow(2, F64)


def _data(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    return np.sinh(0.8 * z) * np.array([1.5, 0.7]) + np.array([0.3, -0.2])


def _check_params(jflow, tflow, rtol):
    for sj, st in zip(jflow.stages, to_numpy(tflow)):
        for name, val in st.items():
            np.testing.assert_allclose(val, np.asarray(getattr(sj, name)),
                                       rtol=rtol, atol=rtol, err_msg=name)


def test_trainer_matches_jax():
    X = _data()
    jflow = _flagship()
    rj = jax_optimize_whitening(jnp.asarray(X), jflow, optax.adagrad(0.1),
                                nbatches=4, nepochs=3, use_fused=False)
    tflow = from_jax(jflow, device="cpu")
    before = dict(TE.LAUNCHES)
    rt = optimize_whitening(torch.from_numpy(X), tflow, nbatches=4,
                            nepochs=3)
    assert TE.LAUNCHES == before        # the CPU dispatch runs the plain path
    assert rt.result is not tflow and rt.negll_history.shape == (12,)
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=1e-5)
    _check_params(rj.result, rt.result, 1e-5)


def test_cpu_dispatch_takes_the_plain_path(monkeypatch):
    """On a CPU batch the trainer's default dispatch is the plain autograd
    path, and use_fused=True runs the fused wrapper's plain version, which
    gives the same history."""
    calls = []
    real = TE.fused_negll_value_and_grad
    monkeypatch.setattr(
        "enflows_tpu_torch.train.whitening.fused_negll_value_and_grad",
        lambda *a: calls.append(1) or real(*a))
    X = torch.from_numpy(_data(n=800, seed=1)).float()
    jflow = _flagship()
    r_plain = optimize_whitening(
        X, from_jax(jflow, dtype=torch.float32, device="cpu"), nbatches=2,
        nepochs=2)
    assert calls == []
    r_fused = optimize_whitening(
        X, from_jax(jflow, dtype=torch.float32, device="cpu"), nbatches=2,
        nepochs=2, use_fused=True)
    assert len(calls) == 4 and TE.LAUNCHES == {"fwd": 0, "bwd": 0,
                                               "negll": 0}
    np.testing.assert_allclose(r_fused.negll_history.numpy(),
                               r_plain.negll_history.numpy(), rtol=1e-5)
    # The fused forward's negll is the plain one.
    xb = X[:100]
    with torch.no_grad():
        np.testing.assert_allclose(
            float(mvnormal_negll_fused(r_plain.result, xb)),
            float(mvnormal_negll(r_plain.result, xb)), rtol=1e-5)


def test_trainer_resumes():
    X = torch.from_numpy(_data(n=1200, seed=2))
    jflow = _flagship()
    full = optimize_whitening(X, from_jax(jflow, device="cpu"), nbatches=3,
                              nepochs=3)
    part = optimize_whitening(X, from_jax(jflow, device="cpu"), nbatches=3,
                              nepochs=2)
    rest = optimize_whitening(X, part.result, nbatches=3, nepochs=1,
                              opt_state=part.optimizer_state,
                              negll_history=part.negll_history)
    np.testing.assert_allclose(rest.negll_history.numpy(),
                               full.negll_history.numpy(), rtol=1e-12)
    for a, b in zip(rest.result.parameters(), full.result.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-12)


def test_trainer_example_2d_model_matches_jax():
    """The 2D example's model: an inverted single-reflection Householder and
    an inverted CenterStretch, whose inverses share the trained
    Parameters."""
    vec = lambda *a: jnp.asarray(a, F64)
    jmodel = ef.compose(
        ef.invert(ef.CenterStretch(a=vec(0.0, 0.0), b=vec(1.0, 1.0),
                                   c=vec(0.0, 0.0))),
        ef.invert(ef.Householder(V=vec(0.6, -1.1))),
        ef.ScaleShift(a=vec(1.0, 1.0), b=vec(0.0, 0.0)),
    )
    X = _data(n=2000, seed=3)
    rj = jax_optimize_whitening(jnp.asarray(X), jmodel, optax.adagrad(0.1),
                                nbatches=4, nepochs=2, use_fused=False)
    rt = optimize_whitening(torch.from_numpy(X),
                            from_jax(jmodel, device="cpu"), nbatches=4,
                            nepochs=2)
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=1e-5)
    _check_params(rj.result, rt.result, 1e-5)


def test_trainer_leaves_the_initial_flow_as_given():
    """The trainer fits a copy: the initial flow's parameters are
    bit-unchanged after a fit (as the JAX trainer returns a new flow), and
    the fit still matches JAX; a second fit from the same initial flow
    repeats the first."""
    X = _data(n=1200, seed=4)
    jflow = _flagship()
    tflow = from_jax(jflow, device="cpu")
    before = {k: p.detach().clone() for k, p in tflow.named_parameters()}
    rt = optimize_whitening(torch.from_numpy(X), tflow, nbatches=3,
                            nepochs=2)
    for k, p in tflow.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
    rj = jax_optimize_whitening(jnp.asarray(X), jflow, optax.adagrad(0.1),
                                nbatches=3, nepochs=2, use_fused=False)
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=1e-5)
    _check_params(rj.result, rt.result, 1e-5)
    again = optimize_whitening(torch.from_numpy(X), tflow, nbatches=3,
                               nepochs=2)
    np.testing.assert_array_equal(again.negll_history.numpy(),
                                  rt.negll_history.numpy())


@pytest.mark.parametrize("option", ["mesh", "metrics", "checkpoint_every",
                                    "ckpt_dir"])
def test_unported_options_raise(option):
    X = torch.zeros(8, 2)
    with pytest.raises(NotImplementedError):
        optimize_whitening(X, et.ScaleShift(torch.ones(2), torch.zeros(2)),
                           nbatches=1, nepochs=1, **{option: 1})
