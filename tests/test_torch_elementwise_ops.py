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
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
# A pure-torch replay of csrc/elementwise.cu's fused_grad_kernel.

_BY_CODE = {code: kind for kind, code in TE._CODE.items()}


def _n_params(kind):
    return len(inspect.signature(TE._APPLY[kind]).parameters) - 1


def _replay_grad_kernel(chain, x, gy=None, gladj=None, tile=37):
    n, d = x.shape
    plan, pbuf, qbuf = TE._chain_plan(chain, d, x.device)
    P = pbuf.detach().view(plan.n_pslots, d)
    Q = qbuf.detach()
    p_sum = torch.zeros_like(P)
    q_sum = torch.zeros_like(Q)
    loss = torch.zeros((), dtype=torch.float32)
    gx = torch.empty_like(x)
    for s0 in range(0, n, tile):
        ins = [x[s0:s0 + tile]]
        for code, arg in zip(plan.codes, plan.args):
            t = ins[-1]
            if code == TE._HH:
                ins.append(t @ Q[arg].T)
                continue
            kind = _BY_CODE[code]
            np_ = _n_params(kind)
            y, el = TE._APPLY[kind](t, *P[arg:arg + np_])
            loss += el.expand(y.shape).sum()
            ins.append(y)
        if gy is None:
            cy = ins[-1]
            loss += (-0.5 * (cy * cy + 1.8378770664093453)).sum()
            ce = -torch.ones_like(cy)
        else:
            cy = gy[s0:s0 + tile]
            ce = gladj[s0:s0 + tile, None].expand(cy.shape)
        for k in range(len(plan.codes) - 1, -1, -1):
            code, arg = plan.codes[k], plan.args[k]
            if code == TE._HH:
                q_sum[arg] += cy.T @ ins[k]
                cy = cy @ Q[arg]
                continue
            kind = _BY_CODE[code]
            np_ = _n_params(kind)
            cy, gs = TE._ADJOINT[kind](ins[k], *P[arg:arg + np_], cy, ce)
            for i, g in enumerate(gs):
                p_sum[arg + i] += g.expand(cy.shape).sum(0)
        gx[s0:s0 + tile] = cy
    scale = 1.0 / n if gy is None else 1.0
    grads = TE._grads_by_name(chain, [pbuf, qbuf],
                              [p_sum.reshape(-1) * scale, q_sum * scale])
    return (-loss / n if gy is None else gx), grads


def _flagship_torch(d):
    from __graft_entry__ import _flagship_flow
    return from_jax(_flagship_flow(d), device="cpu")


@pytest.mark.parametrize("chain_name,d", [("full", 2), ("full", 50),
                                          ("flagship", 2), ("flagship", 5)])
def test_grad_kernel_replay_matches_autograd(chain_name, d):
    tchain = (from_jax(full_chain(d), device="cpu")
              if chain_name == "full" else _flagship_torch(d))
    # The 2D example's model: an inverted ScaleShift computes 1/a from the
    # shared Parameter, which the pull-back has to reach.
    tchain = et.Chain.of(tchain, et.ScaleShift(torch.full((d,), 1.3),
                                               torch.zeros(d)).inverse())
    x = torch.from_numpy(_data(d, n=300, seed=3))
    v_ref, g_ref = TE.negll_value_and_grad_plain(tchain, x)
    v, g = _replay_grad_kernel(tchain, x)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-5)
    for k in g_ref:
        np.testing.assert_allclose(_np(g[k]), _np(g_ref[k]), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=k)
    # B2: arbitrary cotangents of (y, ladj).
    rng = np.random.default_rng(d)
    gy = torch.from_numpy(rng.normal(size=(300, d)).astype(np.float32))
    gl = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    xr = x.clone().requires_grad_(True)
    y, l = TE.forward_and_ladj_plain(tchain, xr)
    gx_auto, = torch.autograd.grad([y, l], [xr], [gy, gl], retain_graph=True)
    g_auto = TE._grads_by_name(tchain, [y, l], [gy, gl])
    gx, g = _replay_grad_kernel(tchain, x, gy, gl)
    np.testing.assert_allclose(_np(gx), _np(gx_auto), rtol=G_RTOL,
                               atol=G_ATOL)
    for k in g_auto:
        np.testing.assert_allclose(_np(g[k]), _np(g_auto[k]), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=k)


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
    # A tile of B2/B3 holds every stage's input and the per-slot sums.
    tile, smem = TE._grad_tile(5, 14, 2, True)
    assert tile == 512 and smem == 512 * 4 * 2 * 21 + 128


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
