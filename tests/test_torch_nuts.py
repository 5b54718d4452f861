"""The port's NUTS (``enflows_tpu_torch/mcmc/nuts.py``) against the JAX
package, on the CPU in float64.

One transition of all chains is held to the ``vmap``-ed JAX
``nuts_kernel`` given the JAX kernel's own per-chain draws, rebuilt from
the same keys by the kernel's own splits (momentum normals ``nuts.py:
224-225``, direction bits and merge uniforms ``:249-251``/``:271``, leaf
selection uniforms ``:132-133``): positions, log densities and gradients
to 1e-10, the acceptance statistic and energy too, divergence, depth and
leaf counts exactly, with chains stopping at different depths and some
diverging. Random streams cannot match between the frameworks, so the
samplers are held to the statistical gates of tests/test_mcmc.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflows_tpu import mcmc as JM

import enflows_tpu_torch as et
from enflows_tpu_torch import mcmc as TM

torch.set_num_threads(1)

DT = jnp.float64
T64 = torch.float64

COV = np.array([[2.0, 1.2, 0.0], [1.2, 1.0, 0.3], [0.0, 0.3, 0.5]])
PREC = np.linalg.inv(COV)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _jgauss(q):
    return -0.5 * q @ jnp.asarray(PREC) @ q


def _tgauss(q):
    return -0.5 * ((q @ _t(PREC)) * q).sum(-1)


# ------------------------------------------------------------------
# One transition with the JAX kernel's own draws.

N, D, MAX_DEPTH = 64, 3, 6
IM = np.array([0.7, 1.0, 1.6])
NAN_EDGE = 2.0
_JAX_KERNELS = {}


def _jgauss_nan(q):
    """The Gaussian with a NaN density past q[0] = NAN_EDGE."""
    return jnp.where(q[0] > NAN_EDGE, jnp.nan, _jgauss(q))


def _tgauss_nan(q):
    return torch.where(q[:, 0] > NAN_EDGE, torch.nan, _tgauss(q))


def _jax_kernel(extra, logp=_jgauss, max_depth=MAX_DEPTH):
    """The vmap-ed JAX kernel, compiled once per flag, target and depth
    with the step size traced."""
    if (extra, logp, max_depth) not in _JAX_KERNELS:
        kern = JM.nuts_kernel(logp, max_depth=max_depth,
                              extra_uturn_checks=extra)
        _JAX_KERNELS[extra, logp, max_depth] = jax.jit(
            jax.vmap(kern, in_axes=(0, 0, None, None)))
    return _JAX_KERNELS[extra, logp, max_depth]


@functools.partial(jax.jit, static_argnums=1)
def _jax_draws(keys, max_depth=MAX_DEPTH):
    """Every draw the JAX kernel can make, per chain, from its key: the
    momentum normals, then per doubling the direction bit, the merge uniform
    and the leaf-selection uniforms (padded to the deepest doubling)."""

    def one(key):
        key_mom, key = jax.random.split(key)
        noise = jax.random.normal(key_mom, (D,), DT)
        dirs, merges, leaves = [], [], []
        for depth in range(max_depth):
            key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(k_dir))
            merges.append(jax.random.uniform(k_merge, (), DT))

            def leaf(k, _):
                k, k_sel = jax.random.split(k)
                return k, jax.random.uniform(k_sel, (), DT)

            _, u = jax.lax.scan(leaf, k_sub, None, length=1 << depth)
            pad = jnp.ones(((1 << (max_depth - 1)) - (1 << depth),), DT)
            leaves.append(jnp.concatenate([u, pad]))
        return noise, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)

    return jax.vmap(one)(keys)


def _doubling_draws(dirs, merges, leaves):
    """The port's ``doubling_draws`` over per-chain tables: dirs and merges
    (n, max_depth), leaves (n, max_depth, 2^(max_depth-1))."""
    dirs, merges, leaves = _t(dirs), _t(merges), _t(leaves)

    def draws(depth):
        return (dirs[:, depth], merges[:, depth],
                leaves[:, depth, :1 << depth].T.contiguous())

    return draws


@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("step_size", [0.3, 0.9, 1.2])
def test_nuts_transition_matches_jax_vmap_kernel(step_size, extra):
    q0 = 1.5 * np.random.default_rng(4).normal(size=(N, D))
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    states = jax.vmap(lambda q: JM.init_state(_jgauss, q))(jnp.asarray(q0))
    new_j, info_j = _jax_kernel(extra)(keys, states,
                                       jnp.asarray(step_size, DT),
                                       jnp.asarray(IM))
    noise, dirs, merges, leaves = _jax_draws(keys)

    st = TM.init_state(_tgauss, _t(q0))
    new_t, info_t = TM.nuts_transition(
        lambda q: TM.value_and_grad(_tgauss, q), st,
        torch.tensor(step_size, dtype=T64), _t(IM), _t(noise),
        _doubling_draws(dirs, merges, leaves), max_depth=MAX_DEPTH,
        extra_uturn_checks=extra)
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    for f in ("accept_prob", "energy"):
        np.testing.assert_allclose(_np(getattr(info_t, f)),
                                   np.asarray(getattr(info_j, f)),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    for f in ("divergent", "depth", "num_steps"):
        np.testing.assert_array_equal(_np(getattr(info_t, f)),
                                      np.asarray(getattr(info_j, f)),
                                      err_msg=f)
    # The masks are exercised: chains stop at different depths, and with
    # the larger steps some diverge and some do not.
    assert len(np.unique(_np(info_t.depth))) > 1
    n_div = int(info_t.divergent.sum())
    if step_size > 0.5:
        assert 0 < n_div < N
    else:
        assert n_div == 0 and not bool((new_t.q == st.q).all())


def test_nuts_transition_matches_jax_where_the_density_is_nan():
    """Chains that step into a NaN density diverge there (the energy change
    NaN -> -inf) and keep computing NaN rows beside the others, which end
    as JAX's do: nothing leaks across the chains axis."""
    q0 = 1.5 * np.random.default_rng(4).normal(size=(N, D))
    q0[:, 0] = np.minimum(q0[:, 0], NAN_EDGE - 0.1)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    states = jax.vmap(lambda q: JM.init_state(_jgauss_nan, q))(
        jnp.asarray(q0))
    new_j, info_j = _jax_kernel(True, _jgauss_nan)(
        keys, states, jnp.asarray(0.3, DT), jnp.asarray(IM))
    st = TM.init_state(_tgauss_nan, _t(q0))
    new_t, info_t = TM.nuts_transition(
        lambda q: TM.value_and_grad(_tgauss_nan, q), st,
        torch.tensor(0.3, dtype=T64), _t(IM), _t(_jax_draws(keys)[0]),
        _doubling_draws(*_jax_draws(keys)[1:]), max_depth=MAX_DEPTH)
    for a, b in zip(list(new_t) + [info_t.accept_prob, info_t.energy],
                    list(new_j) + [info_j.accept_prob, info_j.energy]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    for f in ("divergent", "depth", "num_steps"):
        np.testing.assert_array_equal(_np(getattr(info_t, f)),
                                      np.asarray(getattr(info_j, f)),
                                      err_msg=f)
    n_div = int(info_t.divergent.sum())
    assert 0 < n_div < N and bool(torch.isfinite(new_t.logp).all())


@pytest.mark.parametrize("extra", [True, False])
def test_nuts_transition_matches_jax_in_deep_trees(extra):
    """Small steps at max_depth=10, the default: trees of up to 1,023
    leaves, where the checkpoint slots run up to the clamped top and a
    sub-subtree check spans up to nine (full_pipeline's preconditioned
    NUTS adapts into such trees)."""
    depth, n = 10, 32
    q0 = 1.5 * np.random.default_rng(4).normal(size=(n, D))
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    states = jax.vmap(lambda q: JM.init_state(_jgauss, q))(jnp.asarray(q0))
    new_j, info_j = _jax_kernel(extra, max_depth=depth)(
        keys, states, jnp.asarray(0.01, DT), jnp.asarray(IM))
    noise, dirs, merges, leaves = _jax_draws(keys, depth)
    st = TM.init_state(_tgauss, _t(q0))
    new_t, info_t = TM.nuts_transition(
        lambda q: TM.value_and_grad(_tgauss, q), st,
        torch.tensor(0.01, dtype=T64), _t(IM), _t(noise),
        _doubling_draws(dirs, merges, leaves), max_depth=depth,
        extra_uturn_checks=extra)
    for a, b in zip(list(new_t) + [info_t.accept_prob, info_t.energy],
                    list(new_j) + [info_j.accept_prob, info_j.energy]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    for f in ("divergent", "depth", "num_steps"):
        np.testing.assert_array_equal(_np(getattr(info_t, f)),
                                      np.asarray(getattr(info_j, f)),
                                      err_msg=f)
    assert int(info_t.depth.max()) == depth and int(info_t.depth.min()) < 8


def test_subtree_slots_take_the_clamped_indices():
    """``_slots``: consecutive slots as a slice (either way), other lists
    by index."""
    stack = torch.arange(7.0)[:, None]
    assert _np(TM.nuts._slots(stack, [2, 3, 4]))[:, 0].tolist() == [2, 3, 4]
    assert _np(TM.nuts._slots(stack, [4, 3, 2]))[:, 0].tolist() == [4, 3, 2]
    assert _np(TM.nuts._slots(stack, [6, 6, 1]))[:, 0].tolist() == [6, 6, 1]
    assert [TM.nuts._trailing_ones(k) for k in range(8)] == \
        [0, 1, 0, 2, 0, 1, 0, 3]


def test_nuts_kernel_deterministic_and_draws_lazily():
    """One generator seed twice gives bit-identical transitions; the
    lockstep counters count what ran."""
    kern = TM.nuts_kernel(_tgauss, max_depth=6)
    q0 = _t(np.random.default_rng(5).normal(size=(16, 3)))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        st = TM.init_state(_tgauss, q0)
        before = dict(TM.nuts.LOCKSTEP)
        for _ in range(3):
            st, info = kern(gen, st, torch.tensor(0.5, dtype=T64),
                            torch.ones(3, dtype=T64))
        counts = {k: TM.nuts.LOCKSTEP[k] - before[k] for k in before}
        runs.append((st, info, counts))
    (s1, i1, c1), (s2, i2, c2) = runs
    for a, b in zip(list(s1) + list(i1), list(s2) + list(i2)):
        assert torch.equal(a, b)
    assert c1 == c2 and c1["transitions"] == 3
    # Every chain takes at least the leaves of its own tree; the lockstep
    # runs the deepest.
    assert c1["leaves"] >= int(i1.num_steps.max())
    assert bool((i1.depth >= 1).all()) and bool((i1.num_steps >= 1).all())
    assert bool((i1.accept_prob <= 1.0).all())


# ------------------------------------------------------------------
# Statistical ports of tests/test_mcmc.py's NUTS tests.

def _gauss_logp(mu, cov):
    prec = _t(np.linalg.inv(cov))
    mu = _t(mu)

    def logp(q):
        d = q - mu
        return -0.5 * ((d @ prec) * d).sum(-1)

    return logp


def test_nuts_gaussian_moments():
    """tests/test_mcmc.py:34."""
    mu = np.array([1.0, -2.0])
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    samples, _, stats = TM.sample(_gauss_logp(mu, cov),
                                  torch.Generator().manual_seed(0), dim=2,
                                  num_chains=8, num_warmup=500,
                                  num_samples=1000, dtype=T64, device="cpu")
    assert samples.shape == (8, 1000, 2)
    assert stats.num_steps.shape == (1000, 8)
    s = _np(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), mu, atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.2)
    assert int(stats.divergent.sum()) == 0
    acc = float(stats.accept_prob.mean())
    assert 0.6 < acc <= 1.0
    assert np.all(TM.split_rhat_per_dim(_np(samples)) < 1.02)
    assert np.all(TM.ess_per_dim(_np(samples)) > 500)


def test_nuts_50d_correlated_gaussian():
    """tests/test_mcmc.py:62 (the BASELINE 50D correlated Gaussian)."""
    dim, rho = 50, 0.7
    idx = np.arange(dim)
    cov = rho ** np.abs(idx[:, None] - idx[None, :])
    samples, _, _ = TM.sample(_gauss_logp(np.zeros(dim), cov),
                              torch.Generator().manual_seed(2), dim=dim,
                              num_chains=8, num_warmup=600, num_samples=600,
                              dtype=T64, device="cpu")
    s = _np(samples).reshape(-1, dim)
    assert np.abs(s.mean(0)).max() < 0.25
    np.testing.assert_allclose(s.var(0), np.ones(dim), rtol=0.35)
    emp = np.corrcoef(s.T)
    assert abs(emp[0, 1] - rho) < 0.15
    assert np.all(TM.split_rhat_per_dim(_np(samples)) < 1.05)


class _ExactFunnelFlow:
    """v = 3 xi_0; x_i = exp(v / 2) xi_i (tests/test_mcmc.py:103-120)."""

    def __init__(self, dim):
        self.dim = dim

    def forward_and_ladj(self, xi):
        v = 3.0 * xi[..., :1]
        x = torch.exp(v / 2.0) * xi[..., 1:]
        ladj = np.log(3.0) + (self.dim - 1) * v[..., 0] / 2.0
        return torch.cat([v, x], -1), ladj

    def forward(self, xi):
        return self.forward_and_ladj(xi)[0]


def test_funnel_flow_preconditioned():
    """tests/test_mcmc.py:82: Neal's funnel through its exact whitening
    flow is N(0, I) up to a constant; NUTS on it recovers the funnel."""
    dim = 5

    def funnel_logp(q):
        v = q[..., 0]
        return -0.5 * (v * v / 9.0) - 0.5 * (
            (q[..., 1:] ** 2).sum(-1) * torch.exp(-v) + (dim - 1) * v)

    target = TM.flow_preconditioned(funnel_logp, _ExactFunnelFlow(dim))
    xi = torch.randn(100, dim, generator=torch.Generator().manual_seed(3),
                     dtype=T64)
    diff = _np(target.logdensity_fn(xi) + 0.5 * (xi * xi).sum(-1))
    np.testing.assert_allclose(diff, np.full(100, diff[0]), atol=1e-8)

    samples, _, stats = TM.sample(target.logdensity_fn,
                                  torch.Generator().manual_seed(4), dim=dim,
                                  num_chains=8, num_warmup=400,
                                  num_samples=800, dtype=T64, device="cpu")
    z = _np(target.push_forward(samples)).reshape(-1, dim)
    assert abs(z[:, 0].mean()) < 0.3
    np.testing.assert_allclose(z[:, 0].var(), 9.0, rtol=0.2)
    assert int(stats.divergent.sum()) == 0


def test_nuts_kernel_invariance():
    """tests/test_mcmc.py:135: chains started at exact target draws keep
    the target under repeated fixed-parameter transitions."""
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    logp = _gauss_logp(np.zeros(2), cov)
    kern = TM.nuts_kernel(logp, max_depth=8)
    n = 8192
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn(n, 2, generator=gen, dtype=T64) @ _t(
        np.linalg.cholesky(cov).T)
    states = TM.init_state(logp, q0)
    for step_size in [0.3, 0.9]:
        st = states
        for _ in range(5):
            st, _ = kern(gen, st, torch.tensor(step_size, dtype=T64),
                         torch.ones(2, dtype=T64))
        s = _np(st.q)
        # sd of cov entries ~ 2*sqrt(2/N) ~ 0.03; allow 4 sigma.
        np.testing.assert_allclose(s.mean(0), np.zeros(2), atol=0.08)
        np.testing.assert_allclose(np.cov(s.T), cov, atol=0.13)


def test_nuts_energy_is_total_hamiltonian():
    """tests/test_mcmc.py:165: the energy is -logp + kinetic at the
    accepted leaf, above the potential alone, with BFMI near 1."""
    logp = lambda q: -0.5 * (q * q).sum(-1)
    kern = TM.nuts_kernel(logp, max_depth=6)
    n, steps = 256, 40
    gen = torch.Generator().manual_seed(1)
    st = TM.init_state(logp, torch.randn(n, 2, generator=gen, dtype=T64))
    energies = []
    for _ in range(steps):
        st, info = kern(gen, st, torch.tensor(0.5, dtype=T64),
                        torch.ones(2, dtype=T64))
        assert bool((info.energy > -st.logp).all())
        energies.append(_np(info.energy))
    b = TM.bfmi(np.stack(energies, axis=1))
    assert 0.7 < b < 1.4, b


def test_sample_nuts_runs_on_the_generators_device_by_default():
    """``sample`` defaults to NUTS; a CPU generator with device='cpu' runs
    it here, and ``max_depth`` bounds every tree."""
    prec = _t(PREC).float()
    samples, final, stats = et.mcmc.sample(
        lambda q: -0.5 * ((q @ prec) * q).sum(-1),
        torch.Generator().manual_seed(6), dim=3, num_chains=4,
        num_warmup=30, num_samples=20, max_depth=3, device="cpu")
    assert samples.shape == (4, 20, 3) and samples.dtype == torch.float32
    assert bool(torch.isfinite(samples).all())
    assert int(stats.num_steps.max()) <= (1 << 3) - 1
    assert final.q.shape == (4, 3)
