"""The port's fused leapfrog (B6) and the HMC step and sampler built on it
against the JAX package, on the CPU.

On a CPU tensor ``fused_leapfrog`` runs its plain version, which is held to
JAX's jnp leapfrog oracle (tests/test_fused_leapfrog.py:41) in float64 to
1e-10, and to JAX's Pallas kernel B6 in interpret mode in float32 at 2e-4
(rtol = atol, the tolerance of tests/test_fused_leapfrog.py); one HMC step is
held to JAX's ``fused_flow_hmc_step`` given that step's own draws. The CUDA
kernel cannot run here: its algorithm is replayed in float64 (``replay_b6``:
the wrapper's plan and buffers, lane-strided elements, the kernel's
summation order) and held to both, and what surrounds it is checked (the
reflection plan, the predicate, the launch geometry, the source's
structure, and that every C entry point matches the signature its ctypes
binding declares).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
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
_LOG_2PI = 1.8378770664093453
_LOG2 = 0.6931471805599453


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
    """Every shape gets a launch within the kernel's launch bounds (so its
    registers fit) and the card's shared memory, whose lane groups cover
    every chain and every column; 8192 x 50 fills the card in under two
    waves (one would need 64 registers, at which its kernel spills)."""
    sms = 132
    geo = TL.leapfrog_geometry(n, d, n_stages, n_rows=4 * (d <= 128))
    assert geo.block <= TL._LF_BLOCK and geo.block % 32 == 0
    assert geo.smem <= TL._SMEM_MAX
    assert geo.chains_per_block * geo.G == geo.block
    assert geo.grid * geo.chains_per_block >= n > (geo.grid - 1) * \
        geo.chains_per_block
    assert geo.G * geo.E >= min(d, 128) and geo.G <= 32
    if (n, d) == (8192, 50):
        assert (geo.G, geo.E, geo.block) == (16, 4, 128)
        waves = geo.grid / (sms * TL._LF_MIN_BLOCKS_E4)
        assert 1.0 < waves < 2.0, waves


def test_geometry_constants_match_the_source():
    """The wrapper's launch constants are the kernel's."""
    src = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                            "leapfrog.cu")).read()
    for macro, value in (("LF_BLOCK_MAX", TL._LF_BLOCK),
                         ("LF_MIN_BLOCKS_E4", TL._LF_MIN_BLOCKS_E4),
                         ("LF_NREG", TL._LF_NREG),
                         ("LF_NCONST", TL._LF_NCONST)):
        assert re.search(rf"#define {macro} {value}\b", src), macro
    assert re.search(rf"HD = {TL._HD}\b", src)


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


def _brace_block(src, start):
    """The text from ``start`` to the brace that closes the first one
    opened after it."""
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError("unbalanced braces")


def test_b6_source_reuses_the_shared_stage_bodies():
    """B6 includes the shared stage header and runs no barrier inside its
    trajectory loop; the tile-wide dense Householder product is gone from
    every source (B1-B3 and B6 apply Householder stages per lane group)."""
    csrc = os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc")
    src = open(os.path.join(csrc, "leapfrog.cu")).read()
    assert '#include "stages.cuh"' in src
    loop = _brace_block(src, src.index("for (int step = 0; step <= L;"))
    assert "lf_grad<" in loop and "__syncthreads" not in loop
    grads = [_brace_block(src, m.start()) for m in
             re.finditer(r"__device__ __forceinline__ void lf_\w+\(", src)]
    assert grads and not any("__syncthreads" in g for g in grads)
    for f in ("elementwise.cu", "leapfrog.cu", "coupling.cu", "stages.cuh"):
        body = open(os.path.join(csrc, f)).read()
        assert "householder_apply" not in body, f


# ------------------------------------------------------------------
# B6's algorithm, replayed in float64 on the CPU.

@pytest.mark.parametrize("d", [2, 5, 50, 128])
@pytest.mark.parametrize("kind", ["plain", "reversed", "inverted"])
def test_reflection_rows_reproduce_the_householder_matrix(d, kind):
    """The wrapper's reflection plan, normalized rows in the order they are
    applied, gives x Q^T forward and c Q reversed, in float64 to 1e-12."""
    rng = np.random.default_rng(d)
    V = torch.from_numpy(rng.normal(size=(4, d)))
    stage = et.Householder(V, reversed=kind == "reversed")
    if kind == "inverted":
        stage = stage.inverse()
    Q = et.bijectors.householder.householder_matrix(stage.vmat(),
                                                    torch.float64)
    x, c = (torch.from_numpy(rng.normal(size=(7, d))) for _ in range(2))
    rows = TL.reflection_rows(stage, torch.float64)
    y, ct = x.clone(), c.clone()
    for w in rows:
        y = y - 2.0 * (y @ w)[:, None] * w
    for w in rows.flip(0):
        ct = ct - 2.0 * (ct @ w)[:, None] * w
    np.testing.assert_allclose(_np(y), _np(x @ Q.T), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(ct), _np(c @ Q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(y), _np(stage.forward(x)), rtol=0,
                               atol=1e-12)


def _lane_sum(v):
    """A sum over a lane group as the kernel takes it: v (..., G), each
    lane's partial; __shfl_xor_sync steps at offsets 1, 2, 4, ... Returns
    the (identical) value of every lane."""
    G = v.shape[-1]
    off = 1
    while off < G:
        v = v + v[..., torch.arange(G) ^ off]
        off <<= 1
    return v


def _replay_consts(args, stages, c0, dc):
    """lf_consts: the (4 + 5 n_stages, dc) constants of columns c0..c0+dc-1,
    clamped to d - 1 beyond d (im = 0 there)."""
    d = args.im.shape[0]
    j = torch.clamp(torch.arange(c0, c0 + dc), max=d - 1)
    par = lambda slot: args.pbuf[slot * d + j]
    zero = torch.zeros(dc, dtype=torch.float64)
    rows = [args.mu[j], args.iv[j],
            torch.where(torch.arange(c0, c0 + dc) < d, args.im[j], zero)]
    lc = -0.5 * (_LOG_2PI - torch.log(args.iv[j]))
    k5 = []
    for k in range(args.plan.n_stages):
        code, s = args.plan.words[4 * k:4 * k + 2]
        c = [zero] * 5
        if code == 0:
            c[:2] = [par(s), par(s + 1)]
            lc = lc + torch.log(torch.abs(par(s)))
        elif code == 1:
            a, b, cc = par(s), par(s + 1), par(s + 2)
            c[:4] = [b, b * (cc + a), b * (cc - a), 1 / b]
        elif code == 2:
            a, b = par(s), par(s + 1)
            c = [b, par(s + 2), a * b - _LOG2, 1 / b, torch.exp(-2 * a * b)]
        elif code == 3:
            delta, lam = par(s + 1), par(s + 3)
            c = [par(s), delta, par(s + 2), 1 / lam, delta / lam]
            lc = lc + torch.log(torch.abs(delta / lam))
        elif code == 4:
            delta, lam = par(s + 1), par(s + 3)
            c = [par(s), 1 / delta, lam, par(s + 2), lam / delta]
            lc = lc + torch.log(torch.abs(lam / delta)) - _LOG2
        k5 += c
    return torch.stack(rows + [lc] + k5)


def _replay_stage(code, x, k, ends):
    """The elementwise stage bodies lf_ss .. lf_ji: (y, A, Bk, le)."""
    sg = torch.sign
    if code == 0:
        return x * k[0] + k[1], k[0], 0.0, 0.0
    if code == 1:
        b = k[0]
        u1, u2 = b * x - k[1], b * x - k[2]
        e1, e2 = torch.exp(-u1.abs()), torch.exp(-u2.abs())
        r1, r2 = 1 / (1 + e1), 1 / (1 + e2)
        s1 = torch.where(u1 >= 0, torch.ones_like(e1), e1) * r1
        s2 = torch.where(-u2 >= 0, torch.ones_like(e2), e2) * r2
        S = s1 + s2
        p1, p2 = e1 * r1 * r1, e2 * r2 * r2
        y = (torch.clamp(u1, min=0) - torch.clamp(-u2, min=0)
             + torch.log1p((e1 - e2) * r2)) * k[3]
        return y, S, b * (p1 - p2) / S, torch.log(S) if ends else 0.0
    if code == 2:
        b, e2ab = k[0], k[4]
        m = torch.clamp(torch.abs(b * x), min=1e-6)
        em = torch.exp(-m)
        one_m = 1 - em
        r2 = one_m * one_m + 4 * e2ab * em
        denom = one_m + r2 * torch.rsqrt(r2)
        log_s = m + k[2] + torch.log(denom)
        y = k[1] + sg(x) * log_s * k[3]
        ae = 2 * em / denom
        q = ae * e2ab
        A, Bq = 1 / (1 + ae), q / (1 + q)
        pA, pB = A * A * ae, Bq / (1 + q)
        S = A + Bq
        Sy = b * torch.where(x >= 0, pA - pB, pB - pA)
        return y, 1 / S, -Sy / (S * S), -torch.log(S) if ends else 0.0
    if code == 3:
        il = k[3]
        u = (x - k[2]) * il
        rs = torch.rsqrt(1 + u * u)
        s = (1 + u * u) * rs
        y = k[0] + k[1] * sg(u) * torch.log(u.abs() + s)
        return y, k[4] * rs, -u * il * rs * rs, -torch.log(s) if ends else 0.0
    v = (x - k[0]) * k[1]
    av = v.abs()
    ei, e = torch.exp(-av), torch.exp(av)
    y = k[2] * (sg(v) * 0.5 * (e - ei)) + k[3]
    tanh_v = sg(v) * (1 - ei * ei) / (1 + ei * ei)
    return (y, k[4] * 0.5 * (e + ei), tanh_v * k[1],
            av + torch.log1p(ei * ei) if ends else 0.0)


def _replay_reflect(x, rows, adjoint):
    """lf_reflect on lane-strided x (n, E, G); rows (k, E, G), zero beyond
    d: each dot product a lane partial over i = 0..E-1, then _lane_sum."""
    for w in (rows.flip(0) if adjoint else rows):
        part = torch.zeros(x.shape[0], x.shape[2], dtype=x.dtype)
        for i in range(x.shape[1]):
            part = part + w[i] * x[:, i]
        x = x - 2.0 * _lane_sum(part)[:, None, :] * w
    return x


def _replay_dense(x, M, d):
    """lf_dense: y[j] = sum over m = l + G i (i outer, l inner, m < d) of
    x[m] M[m, j], for the valid columns j."""
    n, E, G = x.shape
    y = torch.zeros_like(x)
    cols = (torch.arange(G)[None, :] + G * torch.arange(E)[:, None])
    ok = cols < d
    for i2 in range(E):
        for lane in range(G):
            m = lane + G * i2
            if m < d:
                row = torch.where(ok, M[m][torch.clamp(cols, max=d - 1)], 0.0)
                y = y + x[:, i2, lane][:, None, None] * row
    return y


def _replay_grad(args, stages_words, cst, rows, x, nv, ends):
    """lf_grad on lane-strided x (n, E, G): the forward folding each run of
    elementwise stages into (P, B), the base's cotangent, the adjoint
    sweep. Returns (g, the lane's logp share (n, G) or None), summed as the
    kernel sums it: stage by stage, element by element, valid ones only."""
    n, E, G = x.shape
    lay = lambda row: row.reshape(E, G)
    valid = (torch.arange(G)[None, :] + G * torch.arange(E)[:, None]) < nv
    lane = torch.zeros(n, G, dtype=x.dtype)

    def add(e):            # element by element, valid ones only
        nonlocal lane
        for i in range(E):
            lane = lane + torch.where(valid[i], e[:, i], 0.0)
    P, B = torch.ones_like(x), torch.zeros_like(x)
    saved = {}
    for k, (code, a, b, slot) in enumerate(stages_words):
        if code >= 5:
            if slot >= 0:
                saved[slot] = (P, B)
            P, B = torch.ones_like(x), torch.zeros_like(x)
            if code == 5:
                x = _replay_reflect(x, rows[a:a + b], False)
            else:
                x = _replay_dense(x, args.qtbuf[a], args.im.shape[0])
            continue
        kc = [lay(cst[4 + 5 * k + c]) for c in range(5)]
        x, A, Bk, e = _replay_stage(code, x, kc, ends)
        B = B + P * Bk
        P = P * A
        if ends and code > 0:
            add(e)
    dv = x - lay(cst[0])
    if ends:
        add(-0.5 * dv * dv * lay(cst[1]) + lay(cst[3]))
    c = (-dv * lay(cst[1])) * P + B
    for code, a, b, slot in reversed(stages_words):
        if code < 5:
            continue
        if code == 5:
            c = _replay_reflect(c, rows[a:a + b], True)
        else:
            c = _replay_dense(c, args.qbuf[a], args.im.shape[0])
        if slot >= 0:
            Ps, Bs = saved[slot]
            c = c * Ps + Bs
    return c, lane if ends else None


def replay_b6(chain, q, p, step_size, num_steps, inv_mass_diag=None,
              base_mean=None, base_var=None, elements=None):
    """B6's algorithm in float64: the wrapper's plan and buffers
    (``_prepare``) and geometry, lane-strided element ownership in column
    tiles, the hoisted constants, reflections with the kernel's summation
    order, the (P, B) runs, the ladj only at the ends, and both half kicks
    of a gradient right after it."""
    n, d = q.shape
    args = TL._prepare(chain, q, step_size, inv_mass_diag, base_mean,
                       base_var, elements, dtype=torch.float64)
    G, E = TL.lane_group(d, elements)
    dc = G * E
    words = [tuple(args.plan.words[4 * k:4 * k + 4])
             for k in range(args.plan.n_stages)]
    eps = args.eps
    rows = torch.zeros(args.plan.n_rows, dc, dtype=torch.float64)
    rows[:, :min(d, dc)] = args.rows[:, :dc]
    rows = rows.reshape(-1, E, G)
    q_out, p_out = torch.zeros_like(q), torch.zeros_like(p)
    lp0 = torch.zeros(n, dtype=torch.float64)
    lpL = torch.zeros_like(lp0)
    for c0 in range(0, d, dc):
        nv = d - c0
        cst = _replay_consts(args, chain, c0, dc)
        im = cst[2].reshape(E, G)

        def lanes(v):
            out = torch.zeros(n, dc, dtype=torch.float64)
            out[:, :min(nv, dc)] = v[:, c0:c0 + dc]
            return out.reshape(n, E, G)
        qq, pp = lanes(q), lanes(p)
        g = None
        for step in range(num_steps + 1):
            if step > 0:
                qq = qq + eps * pp * im
            ends = step in (0, num_steps)
            g, lane = _replay_grad(args, words, cst, rows, qq, nv, ends)
            if step == 0:               # each tile's sum over the group
                lp0 = lp0 + _lane_sum(lane)[:, 0]
            if step == num_steps:
                lpL = lpL + _lane_sum(lane)[:, 0]
            if step > 0:                # the end of this step
                pp = pp + 0.5 * eps * g
            if step < num_steps:        # the start of the next
                pp = pp + 0.5 * eps * g
        w = min(nv, dc)
        q_out[:, c0:c0 + w] = qq.reshape(n, dc)[:, :w]
        p_out[:, c0:c0 + w] = pp.reshape(n, dc)[:, :w]
    return q_out, p_out, lp0, lpL


def _jax_chain(kinds, d, rng):
    """A JAX chain from numpy draws (kinds applied first to last, as in
    chip_smoke.py's sweep_chain; "~" inverts a stage)."""
    u = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, d))
    stages = []
    for kind in kinds:
        k = kind.strip("~")
        if k == "ss":
            s = ef.ScaleShift(a=u(0.5, 2.0), b=u(-1.0, 1.0))
        elif k in ("cs", "cc"):
            cls = ef.CenterStretch if k == "cs" else ef.CenterContract
            s = cls(a=u(0.1, 1.0), b=u(0.5, 2.5), c=u(-0.5, 0.5))
        elif k in ("j", "ji"):
            cls = ef.Johnson if k == "j" else ef.JohnsonInv
            s = cls(gamma=u(-0.5, 0.5), delta=u(2.0, 6.0), xi=u(-0.5, 0.5),
                    lam=u(2.0, 6.0))
        else:
            s = ef.Householder(V=jnp.asarray(rng.normal(size=(3, d))))
        stages.append(ef.invert(s) if kind.startswith("~") else s)
    return ef.Chain(tuple(stages))


REPLAY = [  # (d, kinds applied first to last, options)
    (2, ["j", "hh", "cs"], ()),                    # a dense Householder
    (5, ["ss", "hh", "ji", "cc"], ()),             # dense, E = 1
    (50, ["hh", "cc", "j"], ()),                   # the BASELINE's shape
    (50, ["cc", "hh", "j"], ("E2",)),              # G = 32, E = 2
    (40, ["j", "hh", "~cs", "~hh", "ss"], ("mass",)),
    (128, ["j", "hh", "cc", "hh", "ji", "hh", "cs", "hh", "ss"], ()),
    (300, ["ss", "ji", "cc"], ()),                 # column tiles
    (6, ["hh", "j", "cc"], ("base",)),
]


@pytest.mark.parametrize("d,kinds,opts", REPLAY,
                         ids=[f"d{d}-{'-'.join(k)}{''.join(o)}"
                              for d, k, o in REPLAY])
def test_b6_replay_matches_plain_and_jnp_oracle_f64(d, kinds, opts):
    rng = np.random.default_rng(d + len(kinds))
    jchain = _jax_chain(kinds, d, rng)
    chain = from_jax(jchain, device="cpu", dtype=torch.float64)
    n, eps, L = 9, 0.05, 4
    q = 0.5 * rng.normal(size=(n, d))
    p = rng.normal(size=(n, d))
    kw = {}
    if "mass" in opts:
        kw["inv_mass_diag"] = rng.uniform(0.5, 2.0, d)
    if "base" in opts:
        kw.update(base_mean=rng.uniform(-0.5, 0.5, d),
                  base_var=rng.uniform(0.5, 1.5, d))
    tkw = {k: _t(v) for k, v in kw.items()}
    got = replay_b6(chain, _t(q), _t(p), eps, L,
                    elements=2 if "E2" in opts else None, **tkw)
    plain = TL.leapfrog_plain(chain, _t(q), _t(p), eps, L, **tkw)
    for a, b in zip(got, plain):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-10, atol=1e-10)
    if "base" in opts:
        return                          # the oracle's base is N(0, I)
    logp = _logp(jchain)
    im = kw.get("inv_mass_diag")
    qr, pr = jax.jit(lambda q, p: _jnp_leapfrog(
        logp, q, p, eps, L, None if im is None else jnp.asarray(im)))(
            jnp.asarray(q), jnp.asarray(p))
    for a, b in zip(got, (qr, pr, logp(jnp.asarray(q)), logp(qr))):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def _johnson_inv_edge(dtype):
    """C-3's corner: JohnsonInv at |v| = 88 (e^{|v|} ~ 1.65e38, the last
    decade that f32 holds) followed by a ScaleShift that brings y back to
    O(10), so that logp and its gradient stay finite in f32."""
    v = lambda *a: torch.tensor(a, dtype=dtype)
    chain = et.compose(et.JohnsonInv(v(0.0, 0.0), v(1.0, 1.0), v(0.0, 0.0),
                                     v(1.0, 1.0)),
                       et.ScaleShift(v(1e-37, 1e-37), v(0.0, 0.0)))
    q = v(88.0, -88.0)[None].repeat(3, 1) - v(0.0, 0.5, 1.0)[:, None]
    return chain, q, torch.zeros_like(q)


def test_b6_replay_at_the_johnson_inv_edge():
    """replay_b6 and the plain version agree in float64 at C-3's corner."""
    chain, q, p = _johnson_inv_edge(torch.float64)
    got = replay_b6(chain, q, p, 1e-3, 2)
    ref = TL.leapfrog_plain(chain, q, p, 1e-3, 2)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-10, atol=1e-10)


def _ex2_ftz(v):
    """e^v as B6's lf_exp computes it in f32: ex2.approx.ftz flushes results
    below 2^-126 to 0 (and gives inf from 2^128)."""
    r = torch.exp(v.float())
    return torch.where(r < 2.0 ** -126, torch.zeros_like(r), r)


def test_b6_johnson_inv_stays_finite_where_f32_does():
    """B6's JohnsonInv body in f32 with flushed exponentials at |v| in
    (87.3, 88.7), where e^{-|v|} flushes to 0 but e^{|v|} is finite: the
    source computes e^{|v|} directly (as lf_exp(|v|)); taking it as
    1 / e^{-|v|} turns y and dy/dx inf there."""
    src = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                            "leapfrog.cu")).read()
    body = _brace_block(src, src.index("void lf_ji("))
    assert "lf_exp(av)" in body and "lf_rcp(ei)" not in body
    av = torch.tensor([87.5, 88.0, 88.6], dtype=torch.float32)
    ei = _ex2_ftz(-av)
    assert bool((ei == 0).all())                    # flushed
    e = _ex2_ftz(av)
    sinh, cosh = 0.5 * (e - ei), 0.5 * (e + ei)
    assert bool(torch.isfinite(sinh).all() and torch.isfinite(cosh).all())
    assert not bool(torch.isfinite(1 / ei).any())   # the old form


def test_replay_plan_takes_every_path():
    """The replayed chains reach every path of B6: reflections and dense
    Householder stages, runs in registers and in lane-private shared
    memory, column tiles, E = 1, 2 and 4."""
    plans = {}
    for d, kinds, opts in REPLAY:
        chain = from_jax(_jax_chain(kinds, d, np.random.default_rng(0)),
                         device="cpu")
        plans[(d, tuple(kinds))] = (
            TL.leapfrog_plan(chain, d), TL.lane_group(
                d, 2 if "E2" in opts else None))
    assert any(pl.dense for pl, _ in plans.values())
    assert any(pl.reflect for pl, _ in plans.values())
    assert any(pl.n_smem_slots > 0 for pl, _ in plans.values())
    assert any(pl.nreg == 0 for pl, _ in plans.values())
    assert {E for _, (G, E) in plans.values()} == {1, 2, 4}
    assert any(d > G * E for (d, _), (_, (G, E)) in plans.items())
