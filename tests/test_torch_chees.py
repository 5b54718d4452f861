"""The port's ChEES-HMC (``enflows_tpu_torch/mcmc/chees.py``) against the
JAX package, on the CPU in float64.

The deterministic parts are held to JAX on the same inputs: the van der
Corput jitter exactly, the step count, the ChEES gradient and the Adam
ascent to 1e-12. One proposal transition of all chains, given the
``vmap``-ed JAX kernel's own per-chain draws (``chees.py:123-137``), is held
to it at 1e-10, proposal and endpoint velocity included; the whole warmup
and a short sampling run, fed the draws of JAX's per-iteration keys
``split(fold_in(key, t), nchains)`` (``chees.py:215``, ``:290``), at 1e-8.
Random streams cannot match between the frameworks, so the sampler is held
to the statistical gates of tests/test_chees.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflows_tpu.mcmc import chees as JC
from enflows_tpu.mcmc import init_state as jax_init_state

from enflows_tpu_torch import mcmc as TM
from enflows_tpu_torch.mcmc import chees as TC

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
# The deterministic helpers.

@pytest.mark.parametrize("n,offset", [(1, 0), (256, 0), (500, 0), (4, 4),
                                      (300, 1 << 20)])
def test_halton_base2_matches_jax(n, offset):
    np.testing.assert_array_equal(TC.halton_base2(n, offset),
                                  JC.halton_base2(n, offset))


def test_halton_base2_properties():
    """tests/test_chees.py:28."""
    u = TC.halton_base2(256)
    assert u.shape == (256,) and np.all((u > 0) & (u < 1))
    np.testing.assert_allclose(u[:4], [0.5, 0.25, 0.75, 0.125])
    assert abs(u.mean() - 0.5) < 0.01
    np.testing.assert_allclose(TC.halton_base2(4, offset=4),
                               [0.625, 0.375, 0.875, 0.0625])


@pytest.mark.parametrize("traj,step", [(0.05, 0.1), (1.0, 0.1), (3.7, 0.3),
                                       (1e4, 0.01), (0.3, 0.1)])
def test_num_leapfrog_steps_matches_jax(traj, step):
    got = TC._num_leapfrog_steps(torch.tensor(traj, dtype=T64),
                                 torch.tensor(step, dtype=T64), 512)
    ref = JC._num_leapfrog_steps(jnp.asarray(traj, DT),
                                 jnp.asarray(step, DT), 512)
    assert int(got) == int(ref)


def _random_info(rng, n, d):
    acc = rng.uniform(size=n)
    acc[::5] = 0.0
    return dict(accept_prob=acc, q_prop=rng.normal(size=(n, d)),
                v_prop=rng.normal(size=(n, d)))


@pytest.mark.parametrize("zero_weight", [False, True])
def test_chees_grad_matches_jax(zero_weight):
    rng = np.random.default_rng(1)
    q0 = rng.normal(size=(32, 3))
    fields = _random_info(rng, 32, 3)
    if zero_weight:
        fields["accept_prob"][:] = 0.0
    none = dict(accepted=None, divergent=None, energy=None, num_steps=None)
    ref = JC._chees_grad(jnp.asarray(q0), JC.ChEESInfo(
        **{k: jnp.asarray(v) for k, v in fields.items()}, **none),
        jnp.asarray(0.7, DT))
    got = TC._chees_grad(_t(q0), TC.ChEESInfo(
        **{k: _t(v) for k, v in fields.items()}, **none),
        torch.tensor(0.7, dtype=T64))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12,
                               atol=1e-12)


def test_adam_ascent_matches_jax_step_by_step():
    grads = np.random.default_rng(2).normal(size=40) * 3.0
    aj = JC.ChEESAdaptState(log_h=jnp.asarray(-1.0, DT),
                            m=jnp.zeros((), DT), v=jnp.zeros((), DT),
                            t=jnp.zeros((), DT))
    zero = torch.zeros((), dtype=T64)
    at = TC.ChEESAdaptState(log_h=torch.tensor(-1.0, dtype=T64), m=zero,
                            v=zero, t=zero)
    for g in grads:
        aj = JC._adam_ascent(aj, jnp.asarray(g, DT), lr=0.05)
        at = TC._adam_ascent(at, torch.tensor(g, dtype=T64), lr=0.05)
        for fj, ft in zip(aj, at):
            np.testing.assert_allclose(float(ft), float(fj), rtol=1e-12)


# ------------------------------------------------------------------
# Transitions and whole phases with JAX's own draws.

IM = np.array([0.7, 1.0, 1.6])


def _jax_draws(keys, d):
    """The JAX proposal kernel's draws from its per-chain keys
    (``chees.py:123-137``): unit normals and acceptance uniforms."""
    def one(key):
        k_mom, k_acc = jax.random.split(key)
        return (jax.random.normal(k_mom, (d,), DT),
                jax.random.uniform(k_acc, (), DT))
    return jax.vmap(one)(keys)


@pytest.mark.parametrize("step_size,num_steps", [(0.3, 7), (0.45, 4)])
def test_proposal_transition_matches_jax_vmap_kernel(step_size, num_steps):
    n, d = 64, 3
    q0 = 1.5 * np.random.default_rng(3).normal(size=(n, d))
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    kern = JC.hmc_proposal_kernel(_jgauss)
    states = jax.vmap(lambda q: jax_init_state(_jgauss, q))(jnp.asarray(q0))
    new_j, info_j = jax.jit(jax.vmap(kern, in_axes=(0, 0, None, None, None)))(
        keys, states, jnp.asarray(step_size, DT), jnp.asarray(IM),
        jnp.asarray(num_steps))
    noise, u = _jax_draws(keys, d)

    st = TM.init_state(_tgauss, _t(q0))
    new_t, info_t = TC.hmc_proposal_transition(
        lambda q: TM.value_and_grad(_tgauss, q), st,
        torch.tensor(step_size, dtype=T64), _t(IM), num_steps,
        _t(noise) * torch.rsqrt(_t(IM)), _t(u))
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    for f in ("accept_prob", "energy", "q_prop", "v_prop"):
        np.testing.assert_allclose(_np(getattr(info_t, f)),
                                   np.asarray(getattr(info_j, f)),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    for f in ("accepted", "divergent"):
        np.testing.assert_array_equal(_np(getattr(info_t, f)),
                                      np.asarray(getattr(info_j, f)))
    assert info_t.num_steps == int(info_j.num_steps[0])
    assert 0 < int(info_t.accepted.sum()) < n     # both branches taken


def _patch_draws(monkeypatch, key, iterations, nchains, d):
    """Feed the port's transitions the draws of JAX's per-iteration keys
    split(fold_in(key, t), nchains), t = 0, 1, ..."""
    per_t = iter([_jax_draws(jax.random.split(jax.random.fold_in(key, t),
                                              nchains), d)
                  for t in range(iterations)])

    def draws(generator, q):
        noise, u = next(per_t)
        return _t(noise), _t(u)

    monkeypatch.setattr(TC, "_draws", draws)


N_W, NUM_WARMUP = 32, 40
VAR = np.array([1.0, 2.0, 0.5])


def _jdiag(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(VAR))


def _tdiag(q):
    return -0.5 * (q * q / _t(VAR)).sum(-1)


def _warmup_inputs(logp=_jgauss):
    q0 = np.random.default_rng(6).normal(size=(N_W, 3))
    states = jax.vmap(lambda q: jax_init_state(logp, q))(jnp.asarray(q0))
    return q0, states


def test_chees_warmup_matches_jax(monkeypatch):
    """The whole warmup: 40 iterations of 32 chains (a window ends at
    iteration 35: ``build_schedule(40)``), every draw JAX's.

    Dual averaging feeds the chains' mean acceptance back into the step
    size with a gain above 1 early on, so a rounding difference grows
    from iteration to iteration. On a diagonal Gaussian it stays far
    below the tolerance over these 40 iterations; on the correlated
    target of the transition tests it outgrows 1e-8 within a few dozen,
    and JAX's own jitted and eager warmups part there alike."""
    in_slow, window_end = TM.build_schedule(NUM_WARMUP)
    assert window_end.sum() >= 1 and in_slow.sum() > 0
    key = jax.random.PRNGKey(8)
    q0, states = _warmup_inputs(_jdiag)
    ref = jax.jit(lambda s: JC.chees_warmup(_jdiag, s, key, NUM_WARMUP))(
        states)
    _patch_draws(monkeypatch, key, NUM_WARMUP, N_W, 3)
    got = TC.chees_warmup(_tdiag, TM.init_state(_tdiag, _t(q0)), None,
                          NUM_WARMUP)
    for f in ("step_size", "trajectory_length", "inv_mass_diag"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-8,
                                   err_msg=f)
    for a, b in zip(got.states, ref.states):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)
    # The adapted mass is not the identity any more: the window ended.
    assert not np.allclose(_np(got.inv_mass_diag), 1.0)


def test_run_chains_chees_matches_jax(monkeypatch):
    """A short sampling run at fixed settings, every draw JAX's."""
    key = jax.random.PRNGKey(9)
    q0, states = _warmup_inputs()
    step, traj = 0.35, 1.9
    ref = jax.jit(lambda s: JC.run_chains_chees(
        _jgauss, s, key, 25, jnp.asarray(step, DT), jnp.asarray(traj, DT),
        jnp.asarray(IM)))(states)
    _patch_draws(monkeypatch, key, 25, N_W, 3)
    got = TC.run_chains_chees(
        _tgauss, TM.init_state(_tgauss, _t(q0)), None, 25,
        torch.tensor(step, dtype=T64), torch.tensor(traj, dtype=T64),
        _t(IM))
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-10)
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)
    for f in ("accept_prob", "energy"):
        np.testing.assert_allclose(_np(getattr(got[2], f)),
                                   np.asarray(getattr(ref[2], f)),
                                   rtol=1e-8, atol=1e-10, err_msg=f)
    for f in ("divergent", "num_steps"):
        np.testing.assert_array_equal(_np(getattr(got[2], f)),
                                      np.asarray(getattr(ref[2], f)))
    assert len(np.unique(_np(got[2].num_steps))) > 1    # jittered


# ------------------------------------------------------------------
# Statistical ports of tests/test_chees.py.

def _gauss_logp(mu, cov, dtype=T64):
    prec = _t(np.linalg.inv(cov)).to(dtype)
    mu = _t(mu).to(dtype)

    def logp(q):
        d = q - mu
        return -0.5 * ((d @ prec) * d).sum(-1)

    return logp


def test_chees_gaussian_moments_2d():
    """tests/test_chees.py:40."""
    mu = np.array([1.0, -2.0])
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    samples, _, stats = TM.chees_sample(
        _gauss_logp(mu, cov), torch.Generator().manual_seed(0), dim=2,
        num_chains=64, num_warmup=400, num_samples=500, dtype=T64,
        device="cpu")
    s = _np(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.2)
    acc = float(stats.accept_prob.mean())
    assert 0.45 < acc < 0.95, acc
    assert int(stats.divergent.sum()) == 0


def test_chees_anisotropic_gaussian_trajectory_adapts():
    """tests/test_chees.py:55: on a 100:1 anisotropic Gaussian the adapted
    trajectory exceeds the step."""
    var = torch.tensor([100.0, 1.0, 1.0, 1.0], dtype=T64)
    samples, _, stats = TM.chees_sample(
        lambda q: -0.5 * (q * q / var).sum(-1),
        torch.Generator().manual_seed(1), dim=4, num_chains=128,
        num_warmup=600, num_samples=500, dtype=T64, device="cpu")
    traj, step = float(stats.trajectory_length), float(stats.step_size)
    assert traj > step, (traj, step)
    s = _np(samples).reshape(-1, 4)
    np.testing.assert_allclose(s.var(axis=0), _np(var), rtol=0.25)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.35)


def test_chees_via_sample_dispatch():
    """tests/test_chees.py:75: ``sample(algorithm='chees')`` runs ChEES
    (float32 by default)."""
    samples, _, stats = TM.sample(
        _gauss_logp(np.zeros(2), np.eye(2), torch.float32),
        torch.Generator().manual_seed(2), dim=2, algorithm="chees",
        num_chains=32, num_warmup=200, num_samples=200, device="cpu")
    assert samples.shape == (32, 200, 2) and samples.dtype == torch.float32
    assert isinstance(stats, TM.ChEESSampleStats)
    s = _np(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.15)


def test_chees_deterministic():
    """tests/test_chees.py:86: one generator seed twice, bit-identical."""
    logp = _gauss_logp(np.zeros(2), np.eye(2), torch.float32)
    out = [TM.chees_sample(logp, torch.Generator().manual_seed(3), dim=2,
                           num_chains=8, num_warmup=50, num_samples=50,
                           device="cpu") for _ in range(2)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][2].num_steps, out[1][2].num_steps)


def test_chees_ess_competitive_on_correlated_gaussian():
    """tests/test_chees.py:95: per-draw ESS above a tenth of the draws."""
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]])
    samples, _, _ = TM.chees_sample(
        _gauss_logp(np.zeros(2), cov), torch.Generator().manual_seed(4),
        dim=2, num_chains=64, num_warmup=400, num_samples=400, dtype=T64,
        device="cpu")
    e = TM.ess_per_dim(_np(samples))
    total = samples.shape[0] * samples.shape[1]
    assert e.min() > 0.1 * total, (e, total)
