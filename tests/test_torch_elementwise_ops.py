"""The port's fused-chain ops (B1-B3) against the JAX package, on the CPU.

On a CPU tensor the port's wrappers run their plain versions; these are held
against JAX's Pallas kernels B1/B2/B3, which run in interpret mode on the CPU
(B2 forced the way tests/test_pallas_fused.py forces it), in float32 at the
tolerances of tests/test_pallas_fused.py: y 2e-5, ladj 2e-4, gradients rtol
2e-4 / atol 2e-5.

The CUDA kernels cannot run here. What they compute beyond the stage bodies
is checked instead: the hand-derived stage adjoints that the CUDA code
implements (``_adjoint_*``) against autograd in float64, and a pure-torch
replay of the grad kernel's algorithm (the plan's parameter layout, tiles,
stored stage inputs, the reverse sweep, the Householder dQ and the pull-back
onto the Parameters) against autograd of the plain path.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.ops.pallas import elementwise as EW
from enflows_tpu.ops.pallas.elementwise import (
    fused_forward_and_ladj_packed, fused_negll_value_and_grad as jax_b3)
from test_pallas_fused import full_chain

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.ops import elementwise as TE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_TOL, LADJ_TOL, G_RTOL, G_ATOL = 2e-5, 2e-4, 2e-4, 2e-5


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _grads_close(jax_chain_grads, torch_grads):
    """JAX's gradient pytree (a Chain) against the port's grads keyed by
    parameter name (stages.<i>.<field>)."""
    for i, sj in enumerate(jax_chain_grads.stages):
        for f in type(sj).__dataclass_fields__:
            if f == "mode":
                continue
            np.testing.assert_allclose(
                _np(torch_grads[f"stages.{i}.{f}"]), _np(getattr(sj, f)),
                rtol=G_RTOL, atol=G_ATOL, err_msg=f"stage {i} field {f}")


def _data(d, n=640, seed=0):
    return np.random.default_rng(seed + d).normal(size=(n, d)).astype(
        np.float32)


@pytest.mark.parametrize("d", [2, 3, 50])
def test_b1_plain_matches_pallas(d):
    jchain = full_chain(d)
    tchain = from_jax(jchain, device="cpu")
    x = _data(d)
    yj, lj = fused_forward_and_ladj_packed(jchain, jnp.asarray(x).reshape(-1),
                                           d)
    yt, lt = TE.fused_forward_and_ladj(tchain, torch.from_numpy(x))
    assert yt.dtype == torch.float32 and lt.shape == (x.shape[0],)
    np.testing.assert_allclose(_np(yt), _np(yj).reshape(-1, d), rtol=Y_TOL,
                               atol=Y_TOL)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=LADJ_TOL,
                               atol=LADJ_TOL)


@pytest.mark.parametrize("d", [2, 3, 50])
def test_b2_plain_matches_pallas(d):
    jchain = full_chain(d)
    tchain = from_jax(jchain, device="cpu")
    x = _data(d, seed=1)

    def loss(c, xf):
        y, l = fused_forward_and_ladj_packed(c, xf, d)
        return jnp.sum(jnp.sin(y)) + jnp.sum(l * l)

    old = EW._PALLAS_BACKWARD
    try:
        EW._PALLAS_BACKWARD = "force"
        gcj, gxj = jax.grad(loss, argnums=(0, 1))(
            jchain, jnp.asarray(x).reshape(-1))
    finally:
        EW._PALLAS_BACKWARD = old
    xt = torch.from_numpy(x).requires_grad_(True)
    y, l = TE.fused_forward_and_ladj(tchain, xt)
    (torch.sin(y).sum() + (l * l).sum()).backward()
    np.testing.assert_allclose(_np(xt.grad), _np(gxj).reshape(-1, d),
                               rtol=G_RTOL, atol=G_ATOL)
    _grads_close(gcj, {k: p.grad for k, p in tchain.named_parameters()})


@pytest.mark.parametrize("d", [2, 3, 50])
def test_b3_plain_matches_pallas(d):
    jchain = full_chain(d)
    tchain = from_jax(jchain, device="cpu")
    x = _data(d, seed=2)
    vj, gj = jax_b3(jchain, jnp.asarray(x).reshape(-1), d)
    before = dict(TE.LAUNCHES)
    vt, gt = TE.fused_negll_value_and_grad(tchain, torch.from_numpy(x))
    assert TE.LAUNCHES == before          # a CPU tensor launches nothing
    assert set(gt) == {k for k, _ in tchain.named_parameters()}
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    _grads_close(gj, gt)


# ------------------------------------------------------------------
# Hand-derived adjoints against autograd, float64, at random points away
# from exact zeros (AD through sign(u)*log(|u|+s) and through the 1e-6 clamp
# of CenterStretch gives a different value from the analytic derivative at
# u = 0 and t = 0).

def _stage_params(kind, rng, d):
    u = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, size=d))
    if kind is et.ScaleShift:
        return [u(0.5, 2.0) * torch.from_numpy(rng.choice([-1.0, 1.0], d)),
                u(-1.0, 1.0)]
    if kind in (et.CenterStretch, et.CenterContract):
        return [u(0.0, 1.5), u(0.5, 2.5), u(-0.5, 0.5)]
    return [u(-0.5, 0.5), u(2.0, 6.0), u(-0.5, 0.5), u(2.0, 6.0)]


@pytest.mark.parametrize("kind", list(TE._ADJOINT), ids=lambda k: k.__name__)
def test_stage_adjoint_matches_autograd(kind):
    rng = np.random.default_rng(7)
    n, d = 400, 3
    params = [p.requires_grad_(True) for p in _stage_params(kind, rng, d)]
    mag = rng.uniform(0.05, 4.0, size=(n, d))
    t = torch.from_numpy(mag * rng.choice([-1.0, 1.0], size=(n, d)))
    t.requires_grad_(True)
    cy = torch.from_numpy(rng.normal(size=(n, d)))
    ce = torch.from_numpy(rng.normal(size=(n, d)))
    y, e = TE._APPLY[kind](t, *params)
    auto = torch.autograd.grad((cy * y).sum() + (ce * e.expand(y.shape)).sum(),
                               [t, *params])
    ct, gs = TE._ADJOINT[kind](t.detach(), *(p.detach() for p in params),
                               cy, ce)
    np.testing.assert_allclose(_np(ct), _np(auto[0]), rtol=1e-10,
                               atol=1e-12)
    assert len(gs) == len(params)
    for g, ga in zip(gs, auto[1:]):
        np.testing.assert_allclose(_np(g.sum(0)), _np(ga), rtol=1e-10,
                                   atol=1e-10)


# ------------------------------------------------------------------
# A pure-torch replay of csrc/elementwise.cu's kernels B1-B3.

_LOG2 = 0.6931471805599453
_LOG_2PI = 1.8378770664093453
_NC = TE._EW_NCONST


def _lane_sum(v):
    """A sum over a lane group as the kernels take it: v (..., G), each
    lane's partial; __shfl_xor_sync steps at offsets 1, 2, 4, ..."""
    G = v.shape[-1]
    off = 1
    while off < G:
        v = v + v[..., torch.arange(G) ^ off]
        off <<= 1
    return v


def _replay_consts(plan, pbuf, c0, dc):
    """ew_consts: (EW_NCONST n_stages, dc) constants of columns c0.., clamped
    to d - 1 beyond d."""
    d = plan.d
    j = torch.clamp(torch.arange(c0, c0 + dc), max=d - 1)
    par = lambda slot: pbuf[slot * d + j]
    out = []
    for k in range(plan.n_stages):
        code, s = plan.words[4 * k:4 * k + 2]
        c = [torch.zeros(dc, dtype=pbuf.dtype)] * _NC
        if code == 0:
            a = par(s)
            c[:4] = [a, par(s + 1), torch.log(a.abs()), 1 / a]
        elif code == 1:
            c[:4] = [par(s), par(s + 1), par(s + 2), 1 / par(s + 1)]
        elif code == 2:
            a, b = par(s), par(s + 1)
            c = [b, par(s + 2), a * b, 1 / b, 4 * torch.exp(-2 * (a * b)), a]
        elif code == 3:
            delta, lam = par(s + 1), par(s + 3)
            c = [par(s), delta, par(s + 2), 1 / lam, 1 / delta,
                 torch.log((delta / lam).abs())]
        elif code == 4:
            delta, lam = par(s + 1), par(s + 3)
            c = [par(s), 1 / delta, lam, par(s + 2), 1 / lam,
                 torch.log((lam / delta).abs())]
        out += c
    return torch.stack(out) if out else torch.zeros(0, dc)


def _cs_terms(t, k):
    m = torch.clamp(torch.abs(k[0] * t), min=1e-6)
    em = torch.exp(-m)
    one_m = 1 - em
    denom = one_m + torch.sqrt(one_m * one_m + k[4] * em)
    return em, denom, m + k[2] - _LOG2 + torch.log(denom)


def _fwd_body(code, t, k):
    """f_ss .. f_ji: (y, ladj term)."""
    sg = torch.sign
    if code == 0:
        return t * k[0] + k[1], k[2].expand(t.shape)
    if code == 1:
        a, b = k[0], k[1]
        xu = t - k[2]
        u1, u2 = b * (xu - a), b * (xu + a)
        e1, e2 = torch.exp(-u1.abs()), torch.exp(-u2.abs())
        r1, r2 = 1 / (1 + e1), 1 / (1 + e2)
        s1 = torch.where(u1 >= 0, torch.ones_like(e1), e1) * r1
        s2 = torch.where(-u2 >= 0, torch.ones_like(e2), e2) * r2
        y = (torch.clamp(u1, min=0) - torch.clamp(-u2, min=0)
             + torch.log1p((e1 - e2) * r2)) * k[3]
        return y, torch.log(s1 + s2)
    if code == 2:
        em, denom, log_s = _cs_terms(t, k)
        ae = 2 * em / denom
        q = 0.25 * ae * k[4]
        return (k[1] + sg(t) * log_s * k[3],
                -torch.log(1 / (1 + ae) + q / (1 + q)))
    if code == 3:
        u = (t - k[2]) * k[3]
        s = torch.sqrt(1 + u * u)
        return (k[0] + k[1] * (sg(u) * torch.log(u.abs() + s)),
                k[5] - torch.log(s))
    v = (t - k[0]) * k[1]
    av = v.abs()
    ei, e = torch.exp(-av), torch.exp(av)
    return (k[2] * (sg(v) * 0.5 * (e - ei)) + k[3],
            k[5] + av + torch.log1p(ei * ei) - _LOG2)


def _bwd_body(code, t, y, cy, ce, k):
    """b_ss .. b_ji: (ct, parameter terms), given the stage's input t and
    its output y."""
    sg = torch.sign
    if code == 0:
        return cy * k[0], (cy * t + ce * k[3], cy)
    if code == 1:
        a, b, ib = k[0], k[1], k[3]
        xu = t - k[2]
        xm, xp = xu - a, xu + a
        u1, u2 = b * xm, b * xp
        e1, e2 = torch.exp(-u1.abs()), torch.exp(-u2.abs())
        r1, r2 = 1 / (1 + e1), 1 / (1 + e2)
        s1 = torch.where(u1 >= 0, torch.ones_like(e1), e1) * r1
        s2 = torch.where(-u2 >= 0, torch.ones_like(e2), e2) * r2
        p1, p2 = e1 * r1 * r1, e2 * r2 * r2
        S = s1 + s2
        iS = 1 / S
        ct = cy * S + ce * b * (p1 - p2) * iS
        return ct, (cy * (s2 - s1) - ce * b * (p1 + p2) * iS,
                    cy * (s1 * xm + s2 * xp - y) * ib
                    + ce * (p1 * xm - p2 * xp) * iS, -ct)
    if code == 2:
        b, ib, a = k[0], k[3], k[5]
        em, denom, _ = _cs_terms(t, k)
        s = sg(t)
        yu = y - k[1]
        ae = 2 * em / denom
        q = 0.25 * ae * k[4]
        A, rq = 1 / (1 + ae), 1 / (1 + q)
        B = q * rq
        pA, pB = A * A * ae, B * rq
        pos = s >= 0
        s1, s2 = torch.where(pos, A, B), torch.where(pos, B, A)
        p1, p2 = torch.where(pos, pA, pB), torch.where(pos, pB, pA)
        iS = 1 / (s1 + s2)
        Sy = b * (p1 - p2)
        dy_da = (s1 - s2) * iS
        dy_db = -(s1 * (yu - a) + s2 * (yu + a) - t) * ib * iS
        dE_da = -(Sy * dy_da - b * (p1 + p2)) * iS
        dE_db = -(Sy * dy_db + p1 * (yu - a) - p2 * (yu + a)) * iS
        return (cy * iS + ce * (-Sy * iS * iS),
                (cy * dy_da + ce * dE_da, cy * dy_db + ce * dE_db, cy))
    if code == 3:
        delta, il, i_d = k[1], k[3], k[4]
        u = (t - k[2]) * il
        i_s = 1 / torch.sqrt(1 + u * u)
        cu = cy * delta * i_s - ce * u * i_s * i_s
        ct = cu * il
        return ct, (cy, cy * ((y - k[0]) * i_d) + ce * i_d, -ct,
                    -(cu * u + ce) * il)
    i_d = k[1]
    v = (t - k[0]) * i_d
    ei, e = torch.exp(-v.abs()), torch.exp(v.abs())
    cv = (cy * k[2] * (0.5 * (e + ei))
          + ce * sg(v) * (1 - ei * ei) / (1 + ei * ei))
    ct = cv * i_d
    return ct, (-ct, -(cv * v + ce) * i_d, cy,
                cy * (sg(v) * 0.5 * (e - ei)) + ce * k[4])


def _dense(x, M, d):
    """ew_dense: y[j] = sum over m = l + G i (i outer, l inner, m < d) of
    x[m] M[m, j] for the valid columns j; 0 beyond d."""
    n, E, G = x.shape
    y = torch.zeros_like(x)
    cols = torch.arange(G)[None, :] + G * torch.arange(E)[:, None]
    ok = cols < d
    for i2 in range(E):
        for lane in range(G):
            m = lane + G * i2
            if m < d:
                row = torch.where(ok, M[m][torch.clamp(cols, max=d - 1)], 0.0)
                y = y + x[:, i2, lane][:, None, None] * row
    return y


def _replay(chain, x, mode, gy=None, gladj=None):
    """B1 (mode "fwd"), B2 ("bwd") or B3 ("negll") as csrc/elementwise.cu
    computes them, in x's dtype: the wrapper's plan and buffers
    (``_chain_plan``) and lane group, lane-strided elements in column tiles
    with pad elements (x = 0, constants of column d - 1), the hoisted
    constants, stage inputs in registers (NREG) or in the lane's words after
    its accumulators, each stage's adjoint given its input and output,
    Householder stages as reflections (inputs recovered from the stage's
    output) or dense Q, and the lane words mapped onto the outputs as
    ew_write maps them. Returns B1 (y, ladj), B2 (gx, grads),
    B3 (negll, grads), grads keyed by parameter name."""
    n, d = x.shape
    dt = x.dtype
    plan, bufs = TE._chain_plan(chain, d, x.device, dt)
    pbuf, rbuf, qbuf = (b.detach() for b in bufs)
    G, E = plan.G, plan.E
    dc, nst, nreg = G * E, plan.n_stages, TE._EW_NREG[E]
    words = [plan.words[4 * k:4 * k + 4] for k in range(nst)]
    rows = torch.zeros(plan.n_rows, dc, dtype=dt)
    rows[:, :min(d, dc)] = rbuf[:, :dc]
    rows = rows.reshape(-1, E, G)
    z = lambda *shape: torch.zeros(*shape, dtype=dt)
    y, ladj, gx = z(n, d), z(n), z(n, d)
    loss = z(())
    p_sum, w_sum = z(plan.n_pslots, d), z(plan.n_rows, d)
    q_sum = z(plan.n_dense, d, d)
    for c0 in range(0, d, dc):
        cst = _replay_consts(plan, pbuf, c0, dc).reshape(-1, E, G)
        cols = c0 + torch.arange(G)[None, :] + G * torch.arange(E)[:, None]
        valid = cols < d
        w = min(d - c0, dc)

        def lanes(v):
            out = z(n, dc)
            out[:, :w] = v[:, c0:c0 + w]
            return out.reshape(n, E, G)

        def unlanes(v, out):
            out[:, c0:c0 + w] = v.reshape(n, dc)[:, :w]

        priv = z(n, plan.n_words(mode), G)   # each sample's lane words
        regs = {}

        def save(k, v):
            if k < nreg:
                regs[k] = v
            else:
                base = plan.n_acc + (k - nreg) * E
                priv[:, base:base + E] = v

        def load(k):
            if k < nreg:
                return regs[k]
            base = plan.n_acc + (k - nreg) * E
            return priv[:, base:base + E].clone()

        xx = lanes(x)
        ls = z(n, G)
        for k, (code, a, b, _) in enumerate(words):
            if mode != "fwd":
                save(k, xx)
            if code < TE._HH:
                xx, el = _fwd_body(code, xx, cst[_NC * k:_NC * k + _NC])
                ls = ls + torch.where(valid, el, 0.0).sum(1)
            elif code == TE._HH:
                for wr in rows[a:a + b]:
                    xx = xx - 2 * _lane_sum((wr * xx).sum(1))[:, None] * wr
            else:
                xx = _dense(xx, qbuf[a].T, d)
        if mode == "fwd":
            unlanes(xx, y)
            ladj = ladj + _lane_sum(ls)[:, 0]
            continue
        if mode == "negll":
            ls = ls + torch.where(valid, -0.5 * (xx * xx + _LOG_2PI),
                                  0.0).sum(1)
            loss = loss + ls.sum()
            c, ce = xx, -1.0
        else:
            c, ce = lanes(gy), gladj[:, None, None]
        out = xx                  # stage k's output
        for k in range(nst - 1, -1, -1):
            code, a, b, acc = words[k]
            t = load(k)
            if code < TE._HH:
                c, gs = _bwd_body(code, t, out, c, ce,
                                  cst[_NC * k:_NC * k + _NC])
                for q, g in enumerate(gs):
                    priv[:, acc + q * E:acc + q * E + E] += g
            elif code == TE._HH:
                zz = out
                for r in range(b - 1, -1, -1):
                    wr = rows[a + r]
                    dz = _lane_sum((wr * zz).sum(1))[:, None]
                    dcw = _lane_sum((wr * c).sum(1))[:, None]
                    zz = zz - 2 * dz * wr
                    priv[:, acc + r * E:acc + r * E + E] += \
                        -2 * (-dz * c + dcw * zz)
                    c = c - 2 * dcw * wr
            else:
                for i2 in range(E):
                    for lane in range(G):
                        m = lane + G * i2
                        if m < d:
                            for i in range(E):
                                priv[:, acc + i * d + m] += \
                                    c[:, i] * t[:, i2, lane][:, None]
                c = _dense(c, qbuf[a], d)
            out = t
        if mode == "bwd":
            unlanes(torch.where(valid, c, 0.0), gx)
        # The tile's epilogue: every lane word summed over the samples and
        # written where ew_write puts it.
        tot = priv[:, :plan.n_acc].sum(0)
        for word in range(plan.n_acc):
            for lane in range(G):
                v = tot[word, lane]
                if word < plan.n_pslots * E:
                    q, i = divmod(word, E)
                    j = c0 + lane + G * i
                    if j < d:
                        p_sum[q, j] = v
                    continue
                for code, a, b, acc in words:
                    o = word - acc
                    if code == TE._HH and 0 <= o < b * E:
                        r, i = divmod(o, E)
                        if lane + G * i < d:
                            w_sum[a + r, lane + G * i] = v
                    elif code == TE._HD and 0 <= o < E * d:
                        i, m = divmod(o, d)
                        if lane + G * i < d:
                            q_sum[a, lane + G * i, m] = v
    if mode == "fwd":
        return y, ladj
    scale = 1.0 / n if mode == "negll" else 1.0
    grads = TE._grads_by_name(chain, list(bufs), [
        p_sum.reshape(-1) * scale, w_sum * scale, q_sum * scale])
    return (-loss / n if mode == "negll" else gx), grads


def replay_b1(chain, x):
    """B1's algorithm (``_replay``): (y, ladj)."""
    return _replay(chain, x, "fwd")


def replay_b3(chain, x, gy=None, gladj=None):
    """B3's algorithm (``_replay``): (negll, grads); with the cotangents
    gy and gladj, B2's, the other instantiation of the same kernel:
    (gx, grads)."""
    if gy is None:
        return _replay(chain, x, "negll")
    return _replay(chain, x, "bwd", gy, gladj)


def _jax_kinds_chain(kinds, d, rng):
    """A JAX chain from numpy draws (kinds applied first to last, as
    chip_smoke.py's sweep_chain; "~" inverts a stage), or the flagship."""
    if kinds == "flagship":
        from __graft_entry__ import _flagship_flow
        return _flagship_flow(d, jnp.float64)
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


def _flagship_torch(d):
    from __graft_entry__ import _flagship_flow
    return from_jax(_flagship_flow(d), device="cpu")


# chip_smoke.py's SWEEP shapes (its scalar-parameter row as vectors).
SWEEP_SHAPES = [
    (1, ["j", "cs", "~ss"]), (2, ["ss", "hh", "cc", "ji", "cs", "j"]),
    (3, ["~hh", "j", "cs", "hh", "ss"]), (4, ["ss", "cs", "j"]),
    (50, ["j", "cc", "hh", "ji", "~ss", "cs"]), (128, ["cs", "hh", "hh", "j"]),
    (128, ["hh"]), (5, []), (300, ["ss", "ji", "cc"]),
    (2048, ["ss", "j", "cs"]),
]


REPLAY = [  # (d, kinds applied first to last), and the path each takes
    (2, "flagship"),                                 # G = 1, dense Q
    (50, "flagship"),                                # reflections, spills
    (2, ["ss", "hh", "cc", "ji", "cs", "j"]),        # E = 2, a spill
    (5, ["ss", "hh", "ji", "cc"]),                   # lane groups, dense
    (3, ["~hh", "j", "cs", "hh", "ss"]),             # G = 1, a pad element
    (128, ["cs", "hh", "~hh", "j"]),                 # G = 32, reflections
    (300, ["ss", "ji", "cc"]),                       # column tiles
    (1, ["j", "cs", "~ss"]),
]
_REPLAY_IDS = [f"d{d}-{k if isinstance(k, str) else '-'.join(k)}"
               for d, k in REPLAY]


def _replay_case(d, kinds, n=23):
    rng = np.random.default_rng(d + 7)
    jchain = _jax_kinds_chain(kinds, d, rng)
    chain = from_jax(jchain, device="cpu", dtype=torch.float64)
    x = rng.normal(size=(n, d)) * 1.5
    return jchain, chain, x, rng


def _grads_close_f64(jax_grads, torch_grads, tol=1e-10):
    for i, sj in enumerate(jax_grads.stages):
        for f in type(sj).__dataclass_fields__:
            if f != "mode":
                np.testing.assert_allclose(
                    _np(torch_grads[f"stages.{i}.{f}"]),
                    np.asarray(getattr(sj, f)), rtol=tol, atol=tol,
                    err_msg=f"stage {i} field {f}")


def _all_close(got, ref, tol=1e-10):
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), rtol=tol,
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("d,kinds", REPLAY, ids=_REPLAY_IDS)
def test_replay_b3_matches_plain_and_jax(d, kinds):
    from enflows_tpu.train import mvnormal_negll as jax_negll
    jchain, chain, x, _ = _replay_case(d, kinds)
    v, g = replay_b3(chain, torch.from_numpy(x))
    v0, g0 = TE.negll_value_and_grad_plain(chain, torch.from_numpy(x))
    np.testing.assert_allclose(float(v), float(v0), rtol=1e-12)
    _all_close(g, g0)
    vj, gj = jax.value_and_grad(jax_negll)(jchain, jnp.asarray(x))
    np.testing.assert_allclose(float(v), float(vj), rtol=1e-12)
    _grads_close_f64(gj, g)


@pytest.mark.parametrize("d,kinds", REPLAY, ids=_REPLAY_IDS)
def test_replay_b1_matches_plain_and_jax(d, kinds):
    jchain, chain, x, _ = _replay_case(d, kinds)
    y, ladj = replay_b1(chain, torch.from_numpy(x))
    y0, l0 = TE.forward_and_ladj_plain(chain, torch.from_numpy(x))
    yj, lj = jchain.forward_and_ladj(jnp.asarray(x))
    for got, ref in ((y, y0), (ladj, l0), (y, yj), (ladj, lj)):
        np.testing.assert_allclose(_np(got), np.asarray(_np(ref)),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d,kinds", REPLAY, ids=_REPLAY_IDS)
def test_replay_b2_matches_plain_and_jax(d, kinds):
    jchain, chain, x, rng = _replay_case(d, kinds)
    gy, gl = rng.normal(size=x.shape), rng.normal(size=x.shape[0])
    gx, g = replay_b3(chain, torch.from_numpy(x), torch.from_numpy(gy),
                      torch.from_numpy(gl))
    xr = torch.from_numpy(x).requires_grad_(True)
    y, l = TE.forward_and_ladj_plain(chain, xr)
    gx0, = torch.autograd.grad([y, l], [xr], [torch.from_numpy(gy),
                                               torch.from_numpy(gl)],
                               retain_graph=True)
    g0 = TE._grads_by_name(chain, [y, l], [torch.from_numpy(gy),
                                           torch.from_numpy(gl)])
    np.testing.assert_allclose(_np(gx), _np(gx0), rtol=1e-10, atol=1e-10)
    _all_close(g, g0)
    _, vjp = jax.vjp(lambda c, xx: c.forward_and_ladj(xx), jchain,
                     jnp.asarray(x))
    gcj, gxj = vjp((jnp.asarray(gy), jnp.asarray(gl)))
    np.testing.assert_allclose(_np(gx), np.asarray(gxj), rtol=1e-10,
                               atol=1e-10)
    _grads_close_f64(gcj, g)


def test_replay_cases_take_every_path():
    """The replayed chains reach every path of B1-B3: one-thread groups
    with a dense Q, lane groups with reflections and with a dense Q, stage
    inputs beyond the registers, a pad element, column tiles, E = 1, 2, 4."""
    seen = set()
    for d, kinds in REPLAY:
        chain = from_jax(_jax_kinds_chain(kinds, d, np.random.default_rng(0)),
                         device="cpu")
        pl = TE.chain_plan(chain, d)
        seen |= {name for name, hit in (
            ("G=1 dense", pl.G == 1 and pl.dense),
            ("groups dense", pl.G > 1 and pl.dense),
            ("reflections", pl.reflect),
            ("spill", pl.n_words("negll") > pl.n_acc),
            ("pad", pl.G * pl.E > d),
            ("column tiles", d > pl.G * pl.E),
            (f"E={pl.E}", True)) if hit}
    assert seen == {"G=1 dense", "groups dense", "reflections", "spill",
                    "pad", "column tiles", "E=1", "E=2", "E=4"}, seen


# ------------------------------------------------------------------
# Float32 stability corners (tests/test_bijector_elementwise.py:105-150):
# |b x| >> 88, through the plain path and the kernels' replay in float32.

def _corner_cases():
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    return [
        et.ScaleShift(t([1.3, 0.4, -2.0]), t([2.5, -1.2, 0.3])),
        et.CenterStretch(t([4.0, 4.1, 0.5]), t([2.0, 2.1, 1.0]),
                         t([3.0, 3.1, -0.2])),
        et.CenterContract(t([4.0, 4.1, 0.5]), t([2.0, 2.1, 1.0]),
                          t([3.0, 3.1, -0.2])),
        et.Johnson(t([10.0, -1.0, 0.0]), t([3.5, 2.0, 1.0]),
                   t([10.0, 0.0, -1.0]), t([1.0, 2.0, 0.5])),
        et.JohnsonInv(t([0.3, -1.0, 0.0]), t([3.5, 2.0, 1.0]),
                      t([1.0, 0.0, -1.0]), t([1.0, 2.0, 0.5])),
    ]


CORNER_X = [[-200.0, 0.0, 200.0], [-5.0, 1e-3, 5.0]]
# JohnsonInv at v ~ 88.5: e^{|v|} is finite in f32 up to |v| ~ 88.7.
JI_EDGE_X = [[88.5 * 3.5 + 0.3, -88.5 * 2.0 - 1.0, 88.0], [0.0, 1.0, -2.0]]


def _corner_rows(f):
    rows = JI_EDGE_X if isinstance(f, et.JohnsonInv) else CORNER_X
    return torch.tensor(rows, dtype=torch.float32)


def _finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


@pytest.mark.parametrize("route", ["plain", "replay"])
@pytest.mark.parametrize("f", _corner_cases(),
                         ids=lambda f: type(f).__name__)
def test_float32_corners_stay_finite(f, route):
    """Finite f32 y, ladj, input cotangents and parameter gradients at the
    corners, for the plain path and for B1 / B2 / B3 as the replay computes
    them in f32; JohnsonInv's y and ladj at its last finite |v| (the JAX
    test skips it: sinh overflows at 200)."""
    chain = et.Chain.of(f)
    x = _corner_rows(f)
    gy, gl = torch.ones_like(x), torch.ones(x.shape[0])
    if route == "plain":
        y, ladj = TE.forward_and_ladj_plain(chain, x)
        _, g3 = TE.negll_value_and_grad_plain(chain, x)
        xr = x.clone().requires_grad_(True)
        yy, ll = TE.forward_and_ladj_plain(chain, xr)
        gx = torch.autograd.grad([yy, ll], [xr], [gy, gl])[0]
        g2 = TE._grads_by_name(chain, [*TE.forward_and_ladj_plain(chain, x)],
                               [gy, gl])
    else:
        y, ladj = replay_b1(chain, x)
        _, g3 = replay_b3(chain, x)
        gx, g2 = replay_b3(chain, x, gy, gl)
    assert y.dtype == torch.float32
    assert _finite(y, ladj), (y, ladj)
    if not isinstance(f, et.JohnsonInv):  # its derivatives ~ v cosh v overflow
        assert _finite(gx, *g3.values(), *g2.values()), (gx, g3, g2)


# ------------------------------------------------------------------
# Dispatch and import rules.

def test_fusible_predicate():
    c2 = from_jax(full_chain(2), device="cpu")
    assert TE.is_fusible_chain(c2, 2, torch.float32)
    assert not TE.is_fusible_chain(c2, 2, torch.float64)
    assert not TE.is_fusible_chain(c2, 2, torch.bfloat16)
    assert TE.is_fusible_chain(from_jax(full_chain(128), device="cpu"), 128)
    assert not TE.is_fusible_chain(
        from_jax(full_chain(129), device="cpu"), 129)
    ew = lambda d: et.compose(et.Johnson(torch.zeros(d), torch.ones(d),
                                         torch.zeros(d), torch.ones(d)),
                              et.ScaleShift(torch.ones(d), torch.zeros(d)))
    assert TE.is_fusible_chain(ew(2048), 2048)
    assert not TE.is_fusible_chain(ew(2049), 2049)
    long_chain = et.Chain.of(*[et.ScaleShift(1.0, 0.0) for _ in range(33)])
    assert not TE.is_fusible_chain(long_chain, 2)
    # The flagship at d=2: one thread a sample, two elements each, 14 slots
    # and the dense Q's four sums per lane in shared memory beside the
    # constants, and the fifth stage's input (four in registers); 4 blocks
    # of 256 resident per SM at 64 registers.
    flag = _flagship_torch(2)
    plan = TE.chain_plan(flag, 2)
    assert (plan.G, plan.E, plan.dense, plan.reflect) == (1, 2, (2,), ())
    assert plan.n_acc == 14 * 2 + 2 * 2 and plan.n_words("negll") == 34
    geo = TE.chain_geometry(plan, 1 << 22, "negll", lambda b, sm: 4)
    assert (geo.block, geo.grid, geo.scratch) == (256, 4 * 132, False)
    assert 4 * geo.smem <= 4 * TE._SMEM_MAX
    # Every admitted chain has a launch: words that do not fit shared
    # memory at 32 threads go to a device scratch.
    big = et.Chain.of(*[et.Householder(torch.randn(128, 128))] * 32)
    assert TE.is_fusible_chain(big, 128)
    plan = TE.chain_plan(big, 128)
    assert plan.dense and not plan.reflect
    geo = TE.chain_geometry(plan, 1000, "negll")
    assert geo.scratch and geo.smem <= TE._SMEM_MAX
    for d, kinds in SWEEP_SHAPES:
        chain = from_jax(_jax_kinds_chain(kinds, d, np.random.default_rng(d)),
                         device="cpu")
        assert TE.is_fusible_chain(chain, d)
        for mode in ("fwd", "bwd", "negll"):
            geo = TE.chain_geometry(TE.chain_plan(chain, d), 100, mode)
            assert 32 <= geo.block <= 256 and geo.smem <= TE._SMEM_MAX


def _brace_block(src, start):
    """The text from ``start`` to the brace that closes the first one
    opened after it."""
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError("unbalanced braces")


def test_kernels_have_no_barrier_in_their_sample_loops():
    """B1, B2 and B3 walk their samples with no __syncthreads (nor any
    function that has one) inside the grid-stride loop, stage no tile in
    shared memory, and take their constants' words from the wrapper."""
    src = open(os.path.join(ROOT, "enflows_tpu_torch", "ops", "csrc",
                            "elementwise.cu")).read()
    loops = [_brace_block(src, m.start()) for m in re.finditer(
        r"for \(long long s0 = g0; s0 < a\.n; s0 \+= gstride\)", src)]
    assert len(loops) == 2                   # ew_fwd_kernel, ew_grad_kernel
    helpers = {m.group(1): _brace_block(src, m.start()) for m in re.finditer(
        r"__device__ __forceinline__ \w+ (\w+)\(", src)}
    for loop in loops:
        assert "__syncthreads" not in loop
        called = {h for h in helpers if re.search(rf"\b{h}\b", loop)}
        assert called and not any("__syncthreads" in helpers[h]
                                  for h in called), called
    assert "householder_apply" not in src and "tile" not in src.split(
        "#include")[1].replace("column tile", "").replace("tile's", "")
    for macro, value in (("EW_BLOCK_MAX", TE._EW_BLOCK),
                         ("EW_NCONST", TE._EW_NCONST)):
        assert re.search(rf"#define {macro} {value}\b", src), macro
    assert re.search(r"ew_nreg\(int E\) \{\s*return E == 1 \? (\d+) : "
                     r"E == 2 \? (\d+) : (\d+);\s*\}", src).groups() == tuple(
        str(TE._EW_NREG[e]) for e in (1, 2, 4))
    assert re.search(rf"HD = {TE._HD}\b", src)


def test_wrappers_reject_what_the_kernels_do_not_take():
    chain = from_jax(full_chain(2), device="cpu")
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        TE.fused_forward_and_ladj(chain, torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError):
        TE.fused_negll_value_and_grad(chain, torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError):      # a stage with no fused kernel
        TE.fused_forward_and_ladj(et.Identity(), torch.zeros(4, 2))


def test_import_needs_no_jax_nor_triton():
    code = ("import sys, enflows_tpu_torch, enflows_tpu_torch.interop, "
            "enflows_tpu_torch.ops._build; "
            "bad = [m for m in ('jax', 'triton') if m in sys.modules]; "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
