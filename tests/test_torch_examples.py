"""The port's example scripts (enflows_tpu_torch/examples/) against the JAX
package's (examples/), on the CPU.

The constructors (targets, ground-truth flows, models) are held to the JAX
scripts' objects in float64 on numpy inputs made from a seed: log
densities, forwards and ladjs to 1e-10. The trainers the examples call are
held to JAX's on the same data and initial parameters: Adagrad whitening
histories for a few hundred steps to 1e-5 relative (optax puts its eps
inside the square root, torch outside, test_torch_whitening.py), Adam
coupling and spline histories to 2e-4, and one sticking-the-landing ELBO
step given JAX's own base draws (``train.vi._base_draws``). The 1-D and
2-D whitening examples pass tests/test_training.py's statistical gates on
the port's constructors and generators; every example's ``main`` runs to its
end on the CPU at small depths and prints finite numbers. On the card the
kernels these examples launch are held by ``chip_smoke.py``.
"""
import ast
import importlib
import importlib.util
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.mcmc import FlowPushforwardTarget as JaxPushforward
from enflows_tpu.train import mvnormal_negll as jax_negll
from enflows_tpu.train import optimize_elbo as jax_optimize_elbo
from enflows_tpu.train import optimize_whitening as jax_optimize_whitening

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax, to_numpy
from enflows_tpu_torch.ops import coupling as TC
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.ops import leapfrog as TL
from enflows_tpu_torch.train import mvnormal_negll
from enflows_tpu_torch.train import vi as VI

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = jnp.float64
T64 = torch.float64
NAMES = ("one_call_infer", "coupling_conditional_2d", "nf_example_1d",
         "nf_example_2d", "fused_pushforward_hmc", "full_pipeline",
         "spline_multimodal_2d")


def port(name):
    return importlib.import_module(f"enflows_tpu_torch.examples.{name}")


def jax_script(name):
    """The JAX script ``examples/{name}.py`` as a module (its ``main`` runs
    only under ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jvec(*a):
    return jnp.asarray(a, F64)


def points(n, d, seed, scale=2.0):
    return scale * np.random.default_rng(seed).normal(size=(n, d))


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got, dtype=np.float64),
        np.asarray(want, dtype=np.float64), rtol=tol, atol=tol, err_msg=what)


def hold_chain(tflow, jflow, x, tol=1e-10):
    """Forward and ladj of a port chain against a JAX one at x."""
    y, ladj = tflow.forward_and_ladj(t(x))
    jy, jl = jflow.forward_and_ladj(jnp.asarray(x))
    close(y, jy, tol, "forward")
    close(ladj, jl, tol, "ladj")


# ------------------------------------------------------------------
# Targets and ground-truth flows, float64, 1e-10.

def test_one_call_infer_targets_match_jax():
    """t1 and t2 (one_call_infer.py:29-48): log densities, and their flows'
    forwards and ladjs."""
    ex = port("one_call_infer")
    j1 = ef.compose(ef.ScaleShift(a=jvec(1.3, 0.4), b=jvec(2.5, -1.2)),
                    ef.Householder(V=jvec(1.0, 0.3)),
                    ef.JohnsonInv(gamma=jvec(0.5, -0.3),
                                  delta=jvec(2.0, 2.5), xi=jvec(0.0, 0.0),
                                  lam=jvec(1.0, 1.5)))
    j2 = ef.compose(ef.ScaleShift(a=jvec(1.3, 0.4), b=jvec(2.5, -1.2)),
                    ef.Householder(V=jvec(1.0, 0.3)),
                    ef.CenterStretch(a=jvec(4.0, 4.1), b=jvec(2.0, 2.1),
                                     c=jvec(3.0, 3.1)))
    x = points(257, 2, 0)
    for tdist, jflow in ((ex.heavy_tailed("cpu", T64), j1),
                         (ex.bimodal("cpu", T64), j2)):
        jd = ef.FlowDistribution(bijector=jflow)
        close(tdist.logpdf(t(x)), jd.logpdf(jnp.asarray(x)), 1e-10)
        hold_chain(tdist.bijector, jflow, x)
        assert not any(p.requires_grad for p in tdist.parameters())


def test_banana_matches_jax():
    """banana_logp (coupling_conditional_2d.py:44-48) and the draws'
    construction (:51-56) on the same normals."""
    ex, js = port("coupling_conditional_2d"), jax_script(
        "coupling_conditional_2d")
    x = points(301, 2, 1)
    close(ex.banana_logp(t(x)), js.banana_logp(jnp.asarray(x)), 1e-10)
    X = ex.banana_draws(torch.Generator().manual_seed(0), 50_000, T64)
    assert X.shape == (50_000, 2) and X.dtype == T64
    resid = (X[:, 1] - 0.5 * X[:, 0] ** 2 + 1.0) / 0.3
    assert abs(float(X[:, 0].mean())) < 0.02
    assert abs(float(X[:, 0].std()) - 1.0) < 0.02
    assert abs(float(resid.std()) - 1.0) < 0.02


def test_spline_example_target_matches_jax():
    """make_data is the JAX script's, value for value, and log_density
    (spline_multimodal_2d.py:54-69) agrees to 1e-10; the Gaussian bound is
    the script's."""
    ex, js = port("spline_multimodal_2d"), jax_script("spline_multimodal_2d")
    np.testing.assert_array_equal(ex.make_data(4096, seed=3),
                                  np.asarray(js.make_data(4096, seed=3)))
    x = points(400, 2, 2, scale=3.0)
    close(ex.log_density(t(x)), js.log_density(jnp.asarray(x)), 1e-10)
    X = ex.make_data(65536).astype(np.float64)
    cov = np.cov(X.T)
    want = 0.5 * 2 * (1 + np.log(2 * np.pi)) \
        + 0.5 * np.linalg.slogdet(cov)[1]
    assert abs(ex.gaussian_bound(X) - want) < 1e-12


def _jax_d8_transport(V):
    dim = 8
    v = lambda val: jnp.full((dim,), val, F64)
    return ef.compose(
        ef.ScaleShift(a=jnp.linspace(0.5, 2.0, dim, dtype=F64),
                      b=jnp.linspace(-1.0, 1.0, dim, dtype=F64)),
        ef.invert(ef.Johnson(gamma=v(0.0), delta=v(4.0), xi=v(0.0),
                             lam=v(4.0))),
        ef.Householder(V=V).canonicalize())


def test_pushforward_target_matches_jax():
    """The d=8 declared target (fused_pushforward_hmc.py:34-46) on JAX's own
    reflections: its log density, the transport's forward and ladj, the
    whitening chain's, and the base."""
    ex = port("fused_pushforward_hmc")
    V = jax.random.normal(jax.random.PRNGKey(0), (4, 8), F64)
    jtransport = _jax_d8_transport(V)
    jtarget = JaxPushforward(jtransport,
                             base_mean=0.3 * jnp.ones((8,), F64),
                             base_var=jnp.linspace(0.8, 1.4, 8, dtype=F64))
    tgt = ex.target(t(V))
    x = points(129, 8, 3, scale=1.5)
    close(tgt(t(x)), jax.vmap(jtarget)(jnp.asarray(x)), 1e-10, "logp")
    hold_chain(tgt.transport, jtransport, x)
    hold_chain(tgt.whiten, jtarget.whiten, x)
    close(tgt.base_mean, jtarget.base_mean, 0)
    close(tgt.base_var, jtarget.base_var, 1e-15)
    assert tgt.fused_kernel_available(8)


@pytest.mark.parametrize("name", ["nf_example_1d", "nf_example_2d",
                                  "full_pipeline"])
def test_ground_truths_match_jax(name):
    """The generative flows of the whitening examples
    (nf_example_1d.py:33-37, nf_example_2d.py:29-34,
    full_pipeline.py:38-42): forward and ladj at 1e-10, and the negll of
    the true inverse on data."""
    ex = port(name)
    d = 1 if name == "nf_example_1d" else 2
    if d == 1:
        jflow = ef.compose(
            ef.CenterStretch(a=jvec(4.0), b=jvec(1.0), c=jvec(0.0)),
            ef.Johnson(gamma=jvec(10.0), delta=jvec(3.5), xi=jvec(10.0),
                       lam=jvec(1.0)))
    else:
        jflow = ef.compose(
            ef.ScaleShift(a=jvec(1.3, 0.4), b=jvec(2.5, -1.2)),
            ef.Householder(V=jvec(1.0, 0.3)),
            ef.CenterStretch(a=jvec(4.0, 4.1), b=jvec(2.0, 2.1),
                             c=jvec(3.0, 3.1)))
    tflow = ex.ground_truth("cpu", T64)
    z = points(500, d, 4, scale=1.0)
    hold_chain(tflow, jflow, z)
    X = np.asarray(jflow.forward(jnp.asarray(z)))
    close(mvnormal_negll(et.invert(tflow), t(X)),
          jax_negll(ef.invert(jflow), jnp.asarray(X)), 1e-10, "negll")


# ------------------------------------------------------------------
# The trainers on the examples' models, against JAX's.

def _jax_model(name, V=None):
    if name == "nf_example_1d":
        j = lambda: ef.Johnson(gamma=jvec(0.0), delta=jvec(5.0),
                               xi=jvec(0.0), lam=jvec(5.0))
        s = lambda: ef.invert(ef.CenterStretch(a=jvec(0.0), b=jvec(1.0),
                                               c=jvec(0.0)))
        return ef.compose(j(), s(), j(), s())
    stages = [ef.invert(ef.CenterStretch(a=jvec(0.0, 0.0),
                                         b=jvec(1.0, 1.0),
                                         c=jvec(0.0, 0.0))),
              ef.invert(ef.Householder(V=V)),
              ef.ScaleShift(a=jvec(1.0, 1.0), b=jvec(0.0, 0.0))]
    if name == "full_pipeline":
        stages.insert(0, ef.Johnson(gamma=jvec(0.0, 0.0),
                                    delta=jvec(5.0, 5.0),
                                    xi=jvec(0.0, 0.0), lam=jvec(5.0, 5.0)))
    return ef.compose(*stages)


def _check_params(jflow, tflow, tol):
    for sj, st in zip(jflow.stages, to_numpy(tflow)):
        for field, val in st.items():
            close(val, getattr(sj, field), tol, field)


@pytest.mark.parametrize("name,n,nbatches,nepochs", [
    ("nf_example_1d", 4000, 20, 10), ("nf_example_2d", 3000, 60, 5),
    ("full_pipeline", 5000, 20, 10)])
def test_whitening_history_matches_jax(name, n, nbatches, nepochs):
    """The example's fit (``optimize_whitening`` with the default
    optimizer, optax.adagrad(0.1)'s counterpart) against JAX's on the same
    data and initial parameters, a few hundred steps: the history and the
    trained parameters to 1e-5 relative. The model is the example's
    constructor, given JAX's reflection."""
    ex = port(name)
    d = 1 if name == "nf_example_1d" else 2
    V = jax.random.normal(jax.random.PRNGKey(1), (2,), F64) if d == 2 \
        else None
    X = np.asarray(ex.ground_truth("cpu", T64)(t(points(n, d, 5, 1.0)))
                   .detach())
    jmodel = _jax_model(name, V)
    rj = jax_optimize_whitening(jnp.asarray(X), jmodel, optax.adagrad(0.1),
                                nbatches=nbatches, nepochs=nepochs,
                                use_fused=False)
    tmodel = ex.model("cpu", T64) if d == 1 else ex.model(t(V))
    before = dict(TE.LAUNCHES)
    rt = ex.fit(t(X), tmodel, nbatches, nepochs)
    assert TE.LAUNCHES == before
    assert rt.negll_history.shape == (nbatches * nepochs,)
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=1e-5)
    _check_params(rj.result, rt.result, 1e-5)


def test_coupling_whitening_history_matches_jax():
    """coupling_conditional_2d's fit (Adam(2e-3), :65-68) on JAX's own
    six-layer (48, 48) stack, 40 steps: history and parameters to 2e-4."""
    ex = port("coupling_conditional_2d")
    jstack = ef.coupling_stack(jax.random.PRNGKey(7), 2, n_layers=6,
                               hidden=(48, 48), dtype=F64)
    X = np.asarray(ex.banana_draws(torch.Generator().manual_seed(2), 4000,
                                   T64))
    rj = jax_optimize_whitening(jnp.asarray(X), jstack, optax.adam(2e-3),
                                nbatches=8, nepochs=5, use_fused=False)
    before = dict(TC.LAUNCHES)
    rt = ex.whiten(t(X), from_jax(jstack, device="cpu"), 8, 5)
    assert TC.LAUNCHES == before
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=2e-4,
                               atol=2e-4)
    jnl = jax_negll(rj.result, jnp.asarray(X))
    close(mvnormal_negll(rt.result, t(X)), jnl, 2e-4, "final negll")


@pytest.mark.parametrize("kind", ["spline", "affine"])
def test_spline_example_whitening_history_matches_jax(kind):
    """spline_multimodal_2d's fits (Adam(5e-3), :79-85) on JAX's own stacks
    of the example's size, 40 steps: history and final negll to 2e-4."""
    ex, js = port("spline_multimodal_2d"), jax_script("spline_multimodal_2d")
    key = jax.random.PRNGKey(0)
    jstack = ef.spline_coupling_stack(key, 2, n_layers=3, hidden=(32,),
                                      n_bins=8, bound=6.0, dtype=F64) \
        if kind == "spline" else \
        ef.coupling_stack(key, 2, n_layers=3, hidden=(32,), dtype=F64)
    X = np.asarray(js.make_data(4096), dtype=np.float64)
    rj = jax_optimize_whitening(jnp.asarray(X), jstack, optax.adam(5e-3),
                                nbatches=8, nepochs=5, use_fused=False)
    rt = ex.whiten(t(X), from_jax(jstack, device="cpu"), 8, 5)
    np.testing.assert_allclose(rt.negll_history.numpy(),
                               np.asarray(rj.negll_history), rtol=2e-4,
                               atol=2e-4)
    close(mvnormal_negll(rt.result, t(X)),
          jax_negll(rj.result, jnp.asarray(X)), 2e-4, "final negll")


def test_spline_example_stl_step_matches_jax(monkeypatch):
    """The refinement (spline_multimodal_2d.py:106-112): two
    ``optimize_elbo(stl=True)`` steps of the inverted spline stack with
    Adam(3e-4) and 512 antithetic pairs, given JAX's own base draws: the
    history and the parameters to 2e-4."""
    ex, js = port("spline_multimodal_2d"), jax_script("spline_multimodal_2d")
    key = jax.random.PRNGKey(3)

    def draws(generator, step, batch_size, dim, dtype, device):
        x = jax.random.normal(jax.random.fold_in(key, step),
                              (batch_size, dim), dtype=F64)
        return torch.from_numpy(np.array(x)).to(device)

    monkeypatch.setattr(VI, "_base_draws", draws)
    jstack = ef.spline_coupling_stack(jax.random.PRNGKey(0), 2, n_layers=3,
                                      hidden=(32,), n_bins=8, bound=6.0,
                                      dtype=F64)
    # Move off the identity so that every parameter's gradient is live.
    X = np.asarray(js.make_data(4096), dtype=np.float64)
    jstack = jax_optimize_whitening(jnp.asarray(X), jstack, optax.adam(5e-3),
                                    nbatches=8, nepochs=1,
                                    use_fused=False).result
    jflow = ef.invert(jstack)
    rj = jax_optimize_elbo(js.log_density, jflow, optax.adam(3e-4), dim=2,
                           batch_size=512, nsteps=2, stl=True, key=key,
                           dtype=F64)
    rt = ex.refine(et.invert(from_jax(jstack, device="cpu")),
                   torch.Generator(), nsteps=2)
    assert rt.nelbo_history.dtype == T64
    np.testing.assert_allclose(rt.nelbo_history.numpy(),
                               np.asarray(rj.nelbo_history), rtol=2e-4,
                               atol=2e-4)
    got = {k: v.detach().numpy() for k, v in rt.result.named_parameters()}
    want = jax.tree_util.tree_leaves(rj.result)
    assert len(got) == len(want)
    flat = np.concatenate([np.ravel(v) for v in got.values()])
    jflat = np.concatenate([np.ravel(np.asarray(v)) for v in want])
    assert np.sort(flat).shape == np.sort(jflat).shape
    np.testing.assert_allclose(np.sort(flat), np.sort(jflat), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------------------
# tests/test_training.py's statistical gates on the port's constructors.

def test_whitening_1d_example_gates():
    """tests/test_training.py:31-66 on nf_example_1d's constructors: 20,000
    samples in float64, 50 batches x 20 epochs, the port's generator."""
    ex = port("nf_example_1d")
    gen = torch.Generator().manual_seed(0)
    f_true = ex.ground_truth("cpu", T64)
    with torch.no_grad():
        X = f_true(torch.randn(20000, 1, generator=gen, dtype=T64))
    model = ex.model("cpu", T64)
    res = ex.fit(X, model, 50, 20)
    with torch.no_grad():
        target = float(mvnormal_negll(et.invert(f_true), X))
        initial = float(mvnormal_negll(model, X))
        Y = res.result(X)
    final = float(res.negll_history[-50:].mean())
    assert final < initial - 0.5 * (initial - target), (initial, final)
    assert final < target + 0.15, (final, target)
    assert abs(float(Y.mean())) < 0.1
    assert abs(float(Y.std(unbiased=False)) - 1.0) < 0.1


def test_whitening_2d_example_gates():
    """tests/test_training.py:69-91 on nf_example_2d's constructors: 20,000
    samples in float64, 100 batches x 30 epochs, the port's generators."""
    ex = port("nf_example_2d")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        X = ex.ground_truth("cpu", T64)(
            torch.randn(20000, 2, generator=gen, dtype=T64))
    V = torch.randn(2, generator=torch.Generator().manual_seed(2),
                    dtype=T64)
    res = ex.fit(X, ex.model(V), 100, 30)
    with torch.no_grad():
        Y = res.result(X).numpy()
    np.testing.assert_allclose(np.cov(Y.T), np.eye(2), atol=0.15)
    assert np.all(np.abs(Y.mean(axis=0)) < 0.15)


# ------------------------------------------------------------------
# Each example's main on the CPU, at small depths.

SMALL = {
    "one_call_infer": ["--vi-steps", "100", "--warmup", "20", "--samples",
                       "20", "--data", "2000", "--whiten-batches", "4",
                       "--whiten-epochs", "1", "--particles", "128",
                       "--mutation-steps", "1"],
    "coupling_conditional_2d": ["--data", "1200", "--batches", "2",
                                "--epochs", "2", "--chains", "4",
                                "--warmup", "15", "--samples", "15"],
    "nf_example_1d": ["--data", "4000", "--batches", "10", "--epochs", "3"],
    "nf_example_2d": ["--data", "4000", "--batches", "10", "--epochs", "3"],
    "fused_pushforward_hmc": ["--chains", "16", "--warmup", "30",
                              "--samples", "30"],
    "full_pipeline": ["--data", "2000", "--batches", "10", "--epochs", "2",
                      "--chains", "4", "--warmup", "15", "--samples", "15",
                      "--particles", "128", "--mutation-steps", "1"],
    "spline_multimodal_2d": ["--data", "2048", "--batches", "4",
                             "--epochs", "2", "--vi-steps", "3"],
}
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf",
                    re.IGNORECASE)


@pytest.mark.parametrize("name", NAMES)
def test_main_runs_on_the_cpu(name, capsys):
    """``main(["--cpu", ...])`` runs to its end and prints finite numbers;
    on the CPU no kernel is launched. The return code is the example's
    gate, which such small depths need not pass."""
    before = (dict(TE.LAUNCHES), dict(TC.LAUNCHES), dict(TL.LAUNCHES))
    report = {}
    rc = port(name).main(["--cpu", *SMALL[name]], report=report)
    out = capsys.readouterr().out
    assert rc in (0, 1), rc
    assert (dict(TE.LAUNCHES), dict(TC.LAUNCHES), dict(TL.LAUNCHES)) \
        == before
    assert out.strip() and report
    assert out.splitlines()[-1].startswith(("PASS", "OK", "FAIL")) \
        or name == "one_call_infer", out
    numbers = NUMBER.findall(out)
    assert numbers and all(math.isfinite(float(v)) for v in numbers), out


@pytest.mark.parametrize("name", NAMES)
def test_main_without_a_card_raises(name, monkeypatch):
    """No card and no ``--cpu``: the example raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port(name).main([])


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_jax_nor_the_jax_package(name):
    """The port's example imports torch and nothing of JAX or enflows_tpu,
    and keeps the JAX script's depths as its defaults."""
    src = (ROOT / "enflows_tpu_torch" / "examples" / f"{name}.py").read_text()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "enflows_tpu"}, roots


def test_examples_load_no_jax_module():
    """Importing every example module, in a fresh interpreter, loads no
    module of JAX or of the JAX package."""
    import subprocess
    import sys
    code = ("import sys; "
            + "; ".join(f"import enflows_tpu_torch.examples.{n}"
                        for n in NAMES)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'enflows_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


DEFAULTS = {
    "one_call_infer": dict(vi_steps=500, warmup=400, samples=500,
                           data=100_000, whiten_batches=200,
                           whiten_epochs=8, particles=16384,
                           mutation_steps=5),
    "coupling_conditional_2d": dict(data=60_000, batches=30, epochs=60,
                                    chains=32, warmup=400, samples=600),
    "nf_example_1d": dict(data=10 ** 5, batches=100, epochs=10),
    "nf_example_2d": dict(data=10 ** 5, batches=1000, epochs=10),
    "fused_pushforward_hmc": dict(chains=256, warmup=200, samples=500),
    "full_pipeline": dict(data=50_000, batches=200, epochs=10, chains=64,
                          warmup=400, samples=500, particles=32768,
                          mutation_steps=10),
    "spline_multimodal_2d": dict(data=65536, batches=64, epochs=30,
                                 vi_steps=300),
}


@pytest.mark.parametrize("name", NAMES)
def test_defaults_are_the_jax_scripts(name, monkeypatch):
    """Every depth flag defaults to the JAX script's value (the scripts'
    literals, DEFAULTS)."""
    import argparse
    seen = {}

    def parse(self, argv=None, namespace=None):
        ns = real(self, argv, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(SystemExit):
        port(name).main(["--cpu"])
    assert seen.pop("cpu") is True
    assert seen == DEFAULTS[name]
