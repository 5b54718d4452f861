"""The port's fused leapfrog (B6) and the HMC step and sampler built on it
against the JAX package, on the CPU.

On a CPU tensor ``fused_leapfrog`` runs its plain version, which is held to
JAX's jnp leapfrog oracle (tests/test_fused_leapfrog.py:41) in float64 to
1e-10, and to JAX's Pallas kernel B6 in interpret mode in float32 at 2e-4
(rtol = atol, the tolerance of tests/test_fused_leapfrog.py); one HMC step is
held to JAX's ``fused_flow_hmc_step`` given that step's own draws. The CUDA
kernel cannot run here: what surrounds it is checked instead (the predicate,
the tile choice, and that every C entry point matches the signature its
ctypes binding declares).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflows_tpu.ops.pallas.leapfrog import (
    fused_flow_hmc_step as jax_hmc_step, fused_leapfrog as jax_leapfrog)
from test_fused_leapfrog import _chain, _jnp_leapfrog, _logp

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.mcmc.fused_hmc import _sample
from enflows_tpu_torch.ops import _build
from enflows_tpu_torch.ops import leapfrog as TL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-4


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _inputs(d, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.normal(size=(n, d))).astype(dtype),
            rng.normal(size=(n, d)).astype(dtype))


@pytest.mark.parametrize("d,mass", [(2, False), (5, False), (50, False),
                                    (4, True)])
def test_plain_matches_jnp_oracle_f64(d, mass):
    jchain = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    _chain(d))
    q, p = _inputs(d, 37, d, np.float64)
    im = np.linspace(0.5, 2.0, d) if mass else None
    eps, L = 0.05, 5
    logp = _logp(jchain)
    oracle = jax.jit(lambda q, p: _jnp_leapfrog(
        logp, q, p, eps, L, None if im is None else jnp.asarray(im)))
    qr, pr = oracle(jnp.asarray(q), jnp.asarray(p))
    got = TL.leapfrog_plain(from_jax(jchain, device="cpu"), _t(q), _t(p),
                            eps, L, None if im is None else _t(im))
    for a, b in zip(got, (qr, pr, logp(jnp.asarray(q)), logp(qr))):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("d,mass_and_base", [(2, False), (5, False),
                                             (50, False), (2, True)])
def test_plain_matches_pallas_interpret_f32(d, mass_and_base):
    """Against the TPU kernel itself (interpret mode), float32."""
    jchain = _chain(d)
    q, p = _inputs(d, 37, 10 + d, np.float32)
    kw = {}
    if mass_and_base:
        kw = dict(inv_mass_diag=np.array([0.5, 2.0], np.float32),
                  base_mean=np.array([0.5, -0.3], np.float32),
                  base_var=np.array([1.5, 0.7], np.float32))
    ref = jax_leapfrog(jchain, jnp.asarray(q), jnp.asarray(p), 0.05, 6,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    before = dict(TL.LAUNCHES)
    got = TL.fused_leapfrog(from_jax(jchain, device="cpu"), _t(q), _t(p),
                            0.05, 6, **{k: _t(v) for k, v in kw.items()})
    assert TL.LAUNCHES == before            # a CPU tensor launches nothing
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_plain_logp_is_the_pushforward_density():
    """logp_0 is the diagonal-Gaussian density of f(q) plus ladj, constants
    included, as FlowPushforwardTarget defines it; num_steps = 0 leaves q
    and p and gives logp_L = logp_0."""
    chain = from_jax(_chain(3), device="cpu", dtype=torch.float64)
    q, p = map(_t, _inputs(3, 11, 4, np.float64))
    mu, var = _t([0.2, -0.1, 0.4]), _t([0.5, 1.0, 2.0])
    target = et.mcmc.FlowPushforwardTarget(chain.inverse(), mu, var)
    q0, p0, lp0, lpL = TL.leapfrog_plain(chain, q, p, 0.1, 0,
                                         base_mean=mu, base_var=var)
    assert torch.equal(q0, q) and torch.equal(p0, p)
    np.testing.assert_allclose(_np(lp0), _np(target(q)), rtol=1e-12)
    assert torch.equal(lp0, lpL)


@pytest.mark.parametrize("mass_and_base", [False, True])
def test_hmc_step_matches_jax_with_its_draws(mass_and_base):
    d, n, eps, L = 2, 64, 1.6, 8
    jchain = _chain(d)
    q = (0.3 * np.random.default_rng(5).normal(size=(n, d))).astype(
        np.float32)
    kw = {}
    if mass_and_base:
        kw = dict(inv_mass_diag=np.array([0.6, 1.5], np.float32),
                  base_mean=np.array([0.5, -0.3], np.float32),
                  base_var=np.array([1.5, 0.7], np.float32))
    key = jax.random.PRNGKey(8)
    ref = jax_hmc_step(jchain, key, jnp.asarray(q), eps, L,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    # The step's draws (leapfrog.py:297-313), from the same key.
    k_mom, k_acc = jax.random.split(key)
    noise = jax.random.normal(k_mom, (n, d), jnp.float32)
    u = jax.random.uniform(k_acc, (n,), jnp.float32)
    got = TL.flow_hmc_transition(
        TL.fused_leapfrog, from_jax(jchain, device="cpu"), _t(q), _t(noise),
        _t(u), eps, L, **{k: _t(v) for k, v in kw.items()})
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_array_equal(_np(got[3]), np.asarray(ref[3]))
    assert 0 < int(got[3].sum()) < n          # both branches taken


def test_fused_flow_hmc_step_draws_from_its_generator():
    """fused_flow_hmc_step is flow_hmc_transition over fused_leapfrog with
    its momentum normals, then its uniforms, from ``generator``."""
    chain = from_jax(_chain(3), device="cpu")
    q = 0.3 * torch.randn(20, 3, generator=torch.Generator().manual_seed(0))
    got = TL.fused_flow_hmc_step(chain, torch.Generator().manual_seed(4), q,
                                 0.4, 5)
    g = torch.Generator().manual_seed(4)
    noise, u = torch.randn(20, 3, generator=g), torch.rand(20, generator=g)
    ref = TL.flow_hmc_transition(TL.leapfrog_plain, chain, q, noise, u, 0.4,
                                 5)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_fused_flow_hmc_sample_full_sampler():
    """tests/test_fused_leapfrog.py:119 on the port: warmup + jittered
    sampling recover the preconditioned target's pushforward."""
    d = 2
    chain = from_jax(_chain(d), device="cpu")
    draws, q_final, stats = et.mcmc.fused_flow_hmc_sample(
        chain, torch.Generator().manual_seed(7), dim=d, num_chains=64,
        num_warmup=100, num_samples=150, num_steps=8, device="cpu")
    assert draws.shape == (64, 150, d) and torch.equal(draws[:, -1], q_final)
    assert stats.accept_prob.shape == (150, 64) and stats.num_steps == 8
    acc = float(stats.accept_prob.mean())
    assert 0.6 < acc <= 1.0, acc
    assert float(stats.step_size) > 0.01
    with torch.no_grad():
        y = _np(chain(draws[:, 50:, :].reshape(-1, d)))
    assert np.abs(y.mean(0)).max() < 0.1, y.mean(0)
    assert np.abs(y.std(0) - 1.0).max() < 0.1, y.std(0)


def test_sampler_body_takes_the_leapfrog_it_is_given():
    """The same sampler over leapfrog_plain and over fused_leapfrog (whose
    CPU path is leapfrog_plain) gives identical draws from one seed."""
    chain = from_jax(_chain(3), device="cpu")
    q0 = 0.1 * torch.randn(16, 3, generator=torch.Generator().manual_seed(1))
    runs = [_sample(lf, chain, torch.Generator().manual_seed(2), q0, None,
                    None, num_warmup=5, num_samples=4, num_steps=3,
                    jitter_steps=True, initial_step_size=0.2,
                    target_accept=0.8)[0]
            for lf in (TL.leapfrog_plain, TL.fused_leapfrog)]
    assert torch.equal(runs[0], runs[1])


def _baseline_chain(d):
    """The BASELINE leapfrog chain (benchmarks/bench_mcmc.py:333-338)."""
    v = lambda val: torch.full((d,), val)
    return et.compose(et.Johnson(v(0.0), v(5.0), v(0.0), v(5.0)),
                      et.invert(et.CenterStretch(v(0.0), v(1.0), v(0.0))),
                      et.Householder(torch.randn(4, d)).canonicalize())


def test_predicate():
    assert TL.is_fusible_leapfrog(_baseline_chain(50), 50)
    assert TL.is_fusible_leapfrog(_baseline_chain(128), 128)
    assert not TL.is_fusible_leapfrog(_baseline_chain(129), 129)
    assert not TL.is_fusible_leapfrog(_baseline_chain(50), 50, torch.float64)
    v = torch.ones(300)
    wide = et.Chain.of(et.ScaleShift(v, 0 * v), et.JohnsonInv(0 * v, 5 * v,
                                                              0 * v, 5 * v))
    assert TL.is_fusible_leapfrog(wide, 300)
    many = et.Chain.of(*[et.ScaleShift(torch.ones(2), torch.zeros(2))] * 33)
    assert not TL.is_fusible_leapfrog(many, 2)


@pytest.mark.parametrize("n,d,n_stages", [(8192, 50, 3), (256, 8, 3),
                                          (1 << 20, 2, 5), (5, 2048, 3),
                                          (3000, 128, 2)])
def test_tile_covers_the_card_and_fits(n, d, n_stages):
    sms = 132
    tile = TL.leapfrog_tile(n, d, n_stages, sms)
    grid = -(-n // tile)
    assert tile >= 1 and tile * TL._chain_bytes(n_stages, d) <= TL._SMEM_MAX
    assert grid >= min(n, sms)
    if (n, d) == (8192, 50):
        assert (tile, grid) == (32, 256)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_points_match_their_bindings(name):
    """Each ctypes signature has as many arguments as the C function it
    binds, and a pointer wherever the C side takes one."""
    src = "".join(open(p).read() for p in _build.sources())
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    params = [a.strip() for a in m.group(1).split(",")]
    sig = _build._SIGNATURES[name]
    assert len(params) == len(sig), (params, sig)
    for c_arg, ct in zip(params, sig):
        assert ("*" in c_arg) == (ct is _build._P), (c_arg, ct)


def test_b6_source_reuses_the_shared_stage_bodies():
    src = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                            "leapfrog.cu")).read()
    assert '#include "stages.cuh"' in src
    assert "householder_apply(" in src and "stage_bwd" in src
    for f in ("elementwise.cu", "leapfrog.cu", "coupling.cu"):
        body = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                                 f)).read()
        assert "void householder_apply" not in body, f
    shared = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                               "stages.cuh")).read()
    assert shared.count("void householder_apply") == 1
