"""The port's fused coupling ops (B4, B5) against the JAX package, on the CPU.

On a CPU tensor ``fused_coupling_forward_and_ladj`` runs its plain version
through the same plan as the kernels (Permutes absorbed into the
conditioner weights, elementwise parameters per physical lane, the last
layer's columns lane-grouped). It is held in float32 against JAX's jnp
path, and in two tests against JAX's Pallas kernel in interpret mode, at
the tolerances of tests/test_coupling.py: y 3e-5, ladj 3e-4 (rtol = atol),
gradients 2e-4.
A parameter gradient is a sum over the batch whose f32 rounding in either
framework scales with its largest entries (up to ~800 here), so each leaf
is held within 2e-4 * (1 + max|g_jax|); gx is held elementwise.

The CUDA kernels cannot run here. What they compute beyond the plan is
checked instead: the kernels' padded plan (K and N padded to multiples of
8, padded last-layer slabs) against the plan in float64 to 1e-12, its
packing into the B-fragment order of the TF32 tensor-core product, the
hand-derived adjoints that csrc/coupling.cu implements (``_adjoint_*``)
against autograd in float64, and a pure-torch replay of B5's algorithm on
the padded plan (tiles, stored stage inputs, the layer-major scratch of
layer inputs and pre-activations, the slab-by-slab reverse sweep, the
chunked and split weight-gradient reduction and its gather back onto the
plan) against autograd of the plain path.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu.bijectors import (
    coupling_stack as jax_coupling_stack,
    spline_coupling_stack as jax_spline_stack)
from enflows_tpu.infer import coupling_flow_template
from enflows_tpu.train import optimize_whitening as jax_optimize_whitening

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.ops import coupling as TC
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.train import optimize_whitening

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_TOL, LADJ_TOL, G_TOL = 3e-5, 3e-4, 2e-4
F32 = jnp.float32
DIM = 8
# A half-preserving permutation that is not its own inverse.
CYCLE = (1, 2, 3, 0, 6, 7, 4, 5)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _key(i):
    return jax.random.PRNGKey(i)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        tree)


def _jax_stack(kind, dtype=F32):
    """Perturbed JAX stacks at d=8: the kinds the fused path takes."""
    if kind == "affine":
        c = jax_coupling_stack(_key(1), DIM, 3, (16, 16), dtype=dtype)
    elif kind == "spline":
        c = jax_spline_stack(_key(2), DIM, 3, (16,), n_bins=5, bound=3.0,
                             dtype=dtype)
    elif kind == "mixed":
        a = jax_coupling_stack(_key(3), DIM, 2, (16, 16), dtype=dtype)
        s = jax_spline_stack(_key(4), DIM, 2, (12,), n_bins=4, bound=3.0,
                             activation="silu", dtype=dtype)
        c = ef.Chain.of(*a.stages, ef.Permute(perm=CYCLE), *s.stages)
    elif kind == "template":
        c = coupling_flow_template(3, (16, 16))(DIM, _key(5), dtype)
    else:  # "cycle": non-involutive Permutes before and inside the stack
        a = jax_coupling_stack(_key(6), DIM, 2, (16,), dtype=dtype)
        c = ef.Chain.of(ef.Permute(perm=CYCLE), a.stages[0],
                        ef.Permute(perm=CYCLE), *a.stages[1:])
    return _perturb(c, seed=len(kind))


KINDS = ["affine", "spline", "mixed", "template", "cycle"]


def _x(n=200, seed=0):
    """N(0, 1) inputs, as tests/test_coupling.py draws them, with the first
    two rows outside the spline bound 3."""
    x = np.random.default_rng(seed).normal(size=(n, DIM))
    x[0], x[1] = 3.5, -4.0
    return x.astype(np.float32)


def _named_leaves(jtree, tmodule):
    leaves = jax.tree.leaves(jtree)
    names = [k for k, _ in tmodule.named_parameters()]
    assert len(leaves) == len(names)
    return dict(zip(names, leaves))


def _loss_grads_torch(chain, x, forward):
    params = dict(chain.named_parameters())
    xr = torch.from_numpy(x).requires_grad_(True)
    y, l = forward(chain, xr)
    gs = torch.autograd.grad(torch.sin(y).sum() + l.sum(),
                             [xr, *params.values()])
    return gs[0], dict(zip(params, gs[1:]))


def _jax_loss_grads(jc, x, forward):
    def loss(c, xx):
        y, l = forward(c, xx)
        return jnp.sum(jnp.sin(y)) + jnp.sum(l)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jc, jnp.asarray(x))


_jfwd = jax.jit(lambda c, x: c.forward_and_ladj(x))


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=msg)


def _grads_close(gjax, tmodule, g):
    for name, gj in _named_leaves(gjax, tmodule).items():
        gj = np.asarray(gj)
        err = float(np.abs(_np(g[name]) - gj).max())
        assert err <= G_TOL * (1.0 + float(np.abs(gj).max())), (name, err)


# ------------------------------------------------------------------
# Plain B4 (through the plan) against JAX's jnp path.

@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_b4_matches_jax(kind, inverted):
    jc = _jax_stack(kind)
    if inverted:
        jc = jc.inverse()
    tc = from_jax(jc, device="cpu")
    assert TC.is_fusible_coupling_stack(tc, DIM)
    x = _x(seed=KINDS.index(kind))
    yj, lj = _jfwd(jc, jnp.asarray(x))
    before = dict(TC.LAUNCHES)
    y, l = TC.fused_coupling_forward_and_ladj(tc, torch.from_numpy(x))
    _close(y, yj, Y_TOL, "y")
    _close(l, lj, LADJ_TOL, "ladj")
    yp, lp = TC.fused_coupling_forward_and_ladj(tc, torch.from_numpy(x),
                                                physical_order=True)
    out_map = list(TC._stack_structure(tc, DIM).out_map)
    _close(yp[:, out_map], yj, Y_TOL, "physical-order y")
    _close(lp, lj, LADJ_TOL, "physical-order ladj")
    assert TC.LAUNCHES == before
    # Gradients through the plan onto the chain's Parameters.
    gx, g = _loss_grads_torch(tc, x, TC.fused_coupling_forward_and_ladj)
    gcj, gxj = _jax_loss_grads(jc, x, lambda c, xx: c.forward_and_ladj(xx))
    _close(gx, gxj, G_TOL, "gx")
    _grads_close(gcj, tc, g)


def test_out_map_cotangent_routing():
    """With a Permute that is not its own inverse the output's lane map is
    not an involution, so routing the cotangent of the gathered output by
    out_map instead of argsort(out_map) gives a wrong gx
    (coupling.py:764-767). The kernel's backward gathers gy by argsort; here
    the plain version's autograd is checked against that rule."""
    tc = from_jax(_jax_stack("cycle"), device="cpu")
    st = TC._stack_structure(tc, DIM)
    out_map = np.asarray(st.out_map)
    assert not (out_map[out_map] == np.arange(DIM)).all()
    x = torch.from_numpy(_x(50, seed=9))
    gy = torch.from_numpy(_x(50, seed=10))
    xr = x.clone().requires_grad_(True)
    y, _ = TC.fused_coupling_forward_and_ladj(tc, xr)
    gx_logical, = torch.autograd.grad(y, xr, gy)
    xr = x.clone().requires_grad_(True)
    yp, _ = TC.fused_coupling_forward_and_ladj(tc, xr, physical_order=True)
    gx_routed, = torch.autograd.grad(yp, xr, gy[:, np.argsort(out_map)])
    _close(gx_routed, gx_logical, 1e-6)
    xr = x.clone().requires_grad_(True)
    yp, _ = TC.fused_coupling_forward_and_ladj(tc, xr, physical_order=True)
    gx_wrong, = torch.autograd.grad(yp, xr, gy[:, out_map])
    assert float((gx_wrong - gx_logical).abs().max()) > 1e-2


# ------------------------------------------------------------------
# JAX's Pallas kernel (interpret mode), reached in two tests only: it costs
# seconds per call on the CPU.

def test_plain_b4_matches_pallas_affine_forward_and_gradient():
    from enflows_tpu.ops.pallas.coupling import (
        fused_coupling_forward_and_ladj as jax_fused)
    jc = _jax_stack("affine")
    tc = from_jax(jc, device="cpu")
    x = _x(256, seed=11)
    yj, lj = jax_fused(jc, jnp.asarray(x))
    y, l = TC.fused_coupling_forward_and_ladj(tc, torch.from_numpy(x))
    _close(y, yj, Y_TOL, "y")
    _close(l, lj, LADJ_TOL, "ladj")
    gcj, gxj = _jax_loss_grads(jc, x, jax_fused)
    gx, g = _loss_grads_torch(tc, x, TC.fused_coupling_forward_and_ladj)
    _close(gx, gxj, G_TOL, "gx")
    _grads_close(gcj, tc, g)


def test_plain_b4_matches_pallas_spline_forward_and_inverse():
    from enflows_tpu.ops.pallas.coupling import (
        fused_coupling_forward_and_ladj as jax_fused)
    jc = _jax_stack("spline")
    tc = from_jax(jc, device="cpu")
    x = _x(256, seed=12)
    yj, lj = jax_fused(jc, jnp.asarray(x))
    y, l = TC.fused_coupling_forward_and_ladj(tc, torch.from_numpy(x))
    _close(y, yj, Y_TOL, "y")
    _close(l, lj, LADJ_TOL, "ladj")
    xbj, lbj = jax_fused(jc.inverse(), yj)
    xb, lb = TC.fused_coupling_forward_and_ladj(tc.inverse(), y)
    _close(xb, xbj, Y_TOL, "inverse")
    _close(lb, lbj, LADJ_TOL, "inverse ladj")
    _close(xb, x, 1e-5, "round trip")
    _close(lb, -l, 1e-4, "round trip ladj")


# ------------------------------------------------------------------
# Hand-derived adjoints against autograd, float64.

def _f64(rng, *shape, lo=None, hi=None, scale=1.0):
    a = rng.uniform(lo, hi, size=shape) if lo is not None else \
        rng.normal(size=shape) * scale
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", ["tanh", "gelu", "relu", "silu"])
def test_activation_adjoints(name):
    rng = np.random.default_rng(13)
    pre = _f64(rng, 300, 5, scale=2.0).requires_grad_(True)
    g = _f64(rng, 300, 5)
    auto, = torch.autograd.grad((TC.ACTIVATIONS[name](pre) * g).sum(), pre)
    _close(TC._adjoint_activation(name, pre.detach(), g), auto, 1e-12)


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("kind", ["affine", "spline"])
def test_epilogue_adjoints(kind, inverted):
    rng = np.random.default_rng(14 + inverted)
    n, da, K, bound = 400, 3, 6, 3.0
    if kind == "affine":
        x = _f64(rng, n, da, scale=1.5)
        h = _f64(rng, n, 2 * da)
        fwd = lambda xx, hh: TC._affine_epilogue(xx, hh, da, 2.5, inverted)
        adj = lambda xx, hh, cy, ce: TC._adjoint_affine(
            xx, hh, da, 2.5, inverted, cy, ce)
    else:
        # Inputs inside and outside [-bound, bound]; random points are
        # almost surely away from the bin edges.
        x = _f64(rng, n, da, lo=-4.0, hi=4.0)
        h = _f64(rng, n, (3 * K - 1) * da)
        fwd = lambda xx, hh: TC._spline_epilogue(xx, hh, da, K, bound,
                                                 inverted)
        adj = lambda xx, hh, cy, ce: TC._adjoint_spline(
            xx, hh, da, K, bound, inverted, cy, ce)
    cy = _f64(rng, n, da)
    ce = _f64(rng, n, 1)
    xr, hr = x.clone().requires_grad_(True), h.clone().requires_grad_(True)
    y, el = fwd(xr, hr)
    ax, ah = torch.autograd.grad((cy * y).sum() + (ce * el).sum(), [xr, hr])
    cx, gh = adj(x, h, cy, ce.expand(n, da))
    _close(cx, ax, 1e-10, "cx")
    _close(gh, ah, 1e-10, "g_h")


# ------------------------------------------------------------------
# The kernels' padded plan, and a pure-torch replay of csrc/coupling.cu's B5
# on it.

def _ragged_stack(kind):
    """float64 torch stacks whose last layer runs in several slabs, the last
    one narrower: a K=8 spline at d=40 (G=8: slabs of 8, 8 and 4 half-lanes)
    and an affine one at d=200 (G=92: 92 and 8)."""
    g = torch.Generator().manual_seed(7)
    if kind == "ragged spline":
        c = et.spline_coupling_stack(g, 40, 2, (24,), n_bins=8, bound=3.0,
                                     activation="relu", device="cpu")
    else:
        c = et.coupling_stack(g, 200, 2, (12,), device="cpu")
    c = c.double()
    with torch.no_grad():
        for p in c.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g,
                                      dtype=torch.float64))
    return c


def _stack64(kind, inverted=False):
    """(torch stack in float64, d) for the plan tests."""
    if kind.startswith("ragged"):
        c = _ragged_stack(kind)
        d = 40 if kind == "ragged spline" else 200
    else:
        c = from_jax(_jax_stack(kind, dtype=jnp.float64), device="cpu")
        d = DIM
    return (c.inverse() if inverted else c), d


def _slab_index(G, P, gs):
    """Columns of a padded slab in the plain epilogues' layout for its gs
    half-lanes: parameter p of lane jj at p * G + jj."""
    return [p * G + jj for p in range(P) for jj in range(gs)]


def _replay_b5(st, x, wbuf, pbuf, gy, gl, tile=8, chunk=50, nsplit=3):
    """(gx, wbuf cotangent, pbuf cotangent) the way B5 computes them on the
    padded plan: per chunk of rows, per tile, the forward with every stage's
    input kept and every padded layer's input and pre-activation written to
    a layer-major scratch, the last layer slab by slab; the reverse sweep of
    the hand-derived adjoints slab by slab, overwriting each pre-activation
    with its cotangent; then per layer dW = h_in^T g_pre and db = sum g_pre
    over `nsplit` fixed row ranges of the chunk in the padded layout, the
    partials summed in order and gathered back onto the plan."""
    d = st.dim
    da = d // 2
    pp = TC._padded(st)
    wn = TC._padded_buffer(st, wbuf)
    n = x.shape[0]
    P = pbuf.view(-1, d) if pbuf.numel() else pbuf
    gx = torch.empty_like(x)
    gnat = torch.zeros(pp.nat_len, dtype=x.dtype)
    gp = torch.zeros_like(pbuf).view(-1, d) if pbuf.numel() else pbuf
    for c0 in range(0, n, chunk):
        rows = min(chunk, n - c0)
        h_in = [torch.zeros(rows, Kp, dtype=x.dtype) for Kp, _ in pp.kn]
        g_pre = [torch.zeros(rows, Np, dtype=x.dtype) for _, Np in pp.kn]
        for r0 in range(0, rows, tile):
            sl = slice(c0 + r0, c0 + min(rows, r0 + tile))
            rs = slice(r0, min(rows, r0 + tile))
            ins = [x[sl]]
            for i, it in enumerate(st.items):      # forward, inputs kept
                t = ins[-1]
                if it.kind == "elem":
                    ps = P[it.slot:it.slot + TC._N_PARAMS[it.code]]
                    ins.append(TC._APPLY[TC._BY_CODE[it.code]](t, *ps)[0])
                    continue
                h = torch.nn.functional.pad(
                    t[:, it.src * da:(it.src + 1) * da],
                    (0, pp.kn[it.layer0][0] - da))
                for li in range(it.n_layers):
                    W, b = TC._layer(st, wn, it.layer0 + li, pp)
                    h_in[it.layer0 + li][rs] = h
                    h = h @ W + b
                    g_pre[it.layer0 + li][rs] = h       # pre-activation
                    if li + 1 < it.n_layers:
                        h = TC.ACTIVATIONS[it.act](h)
                tgt = slice((1 - it.src) * da, (2 - it.src) * da)
                G, sw, n_slabs = pp.slabs[i]
                out = t.clone()
                for s in range(n_slabs):               # epilogue per slab
                    j0, gs = s * G, min(G, da - s * G)
                    hs = h[:, [s * sw + c for c in _slab_index(
                        G, TC._n_params(it), gs)]]
                    xs = t[:, tgt][:, j0:j0 + gs]
                    new, _ = (TC._affine_epilogue(xs, hs, gs, it.mls,
                                                  it.inverted)
                              if it.kind == "affine" else
                              TC._spline_epilogue(xs, hs, gs, it.n_bins,
                                                  it.bound, it.inverted))
                    out[:, tgt.start + j0:tgt.start + j0 + gs] = new
                ins.append(out)
            cy = gy[sl].clone()
            ce = gl[sl, None]
            for i in range(len(st.items) - 1, -1, -1):   # reverse sweep
                it, t = st.items[i], ins[i]
                if it.kind == "elem":
                    kind = TC._BY_CODE[it.code]
                    ps = P[it.slot:it.slot + TC._N_PARAMS[it.code]]
                    cy, gs_ = TE._ADJOINT[kind](t, *ps, cy, ce.expand_as(cy))
                    for q, g in enumerate(gs_):
                        gp[it.slot + q] += g.expand_as(cy).sum(0)
                    continue
                src = slice(it.src * da, (it.src + 1) * da)
                tgt = slice((1 - it.src) * da, (2 - it.src) * da)
                last = it.layer0 + it.n_layers - 1
                G, sw, n_slabs = pp.slabs[i]
                g = torch.zeros_like(g_pre[last][rs])
                cy = cy.clone()
                for s in range(n_slabs):               # adjoint per slab
                    j0, gs = s * G, min(G, da - s * G)
                    cols = [s * sw + c for c in _slab_index(
                        G, TC._n_params(it), gs)]
                    hs = g_pre[last][rs][:, cols]
                    lanes = slice(tgt.start + j0, tgt.start + j0 + gs)
                    args = (t[:, lanes], hs, gs)
                    tail = (cy[:, lanes], ce.expand(-1, gs))
                    cx, g_s = (TC._adjoint_affine(*args, it.mls, it.inverted,
                                                  *tail)
                               if it.kind == "affine" else
                               TC._adjoint_spline(*args, it.n_bins, it.bound,
                                                  it.inverted, *tail))
                    g[:, cols] = g_s
                    cy[:, lanes] = cx
                for li in range(it.n_layers - 1, -1, -1):
                    lay = it.layer0 + li
                    W, _ = TC._layer(st, wn, lay, pp)
                    g_pre[lay][rs] = g
                    dh = g @ W.T
                    if li > 0:
                        g = TC._adjoint_activation(
                            it.act, g_pre[lay - 1][rs], dh)
                    else:
                        cy[:, src] = cy[:, src] + dh[:, :da]
            gx[sl] = cy
        for lay, (Kp, Np) in enumerate(pp.kn):   # the dW reduction
            off = pp.nat_offs[lay]
            for s in range(nsplit):
                a, b = rows * s // nsplit, rows * (s + 1) // nsplit
                gnat[off:off + Kp * Np] += (h_in[lay][a:b].T
                                            @ g_pre[lay][a:b]).reshape(-1)
                gnat[off + Kp * Np:off + (Kp + 1) * Np] += \
                    g_pre[lay][a:b].sum(0)
    gw = gnat[torch.as_tensor(pp.grad_idx)]
    return gx, gw, gp.reshape(-1) if pbuf.numel() else gp


@pytest.mark.parametrize("kind,inverted", [("mixed", False),
                                           ("template", True),
                                           ("spline", True),
                                           ("cycle", False),
                                           ("ragged spline", False),
                                           ("ragged affine", True)])
def test_b5_replay_matches_autograd(kind, inverted):
    tc, d = _stack64(kind, inverted)
    st = TC._stack_structure(tc, d)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(123, d)))
    x[0, :], x[1, :] = 3.5, -4.0
    gy = torch.from_numpy(rng.normal(size=(123, d)))
    gl = torch.from_numpy(rng.normal(size=123))
    with torch.no_grad():
        wbuf, pbuf = TC._stack_plan(tc, st, torch.float64, x.device)
    wr, pr = wbuf.clone().requires_grad_(True), pbuf.clone()
    xr = x.clone().requires_grad_(True)
    pr.requires_grad_(pr.numel() > 0)
    y, l = TC.coupling_forward_plain(st, wr, pr, xr)
    wanted = [xr, wr] + ([pr] if pr.numel() else [])
    auto = torch.autograd.grad([y, l], wanted, [gy, gl])
    gx, gw, gp = _replay_b5(st, x, wbuf, pbuf, gy, gl)
    _close(gx, auto[0], 1e-10, "gx")
    _close(gw, auto[1], 1e-10, "wbuf")
    if pr.numel():
        _close(gp, auto[2], 1e-10, "pbuf")


@pytest.mark.parametrize("kind", ["affine", "spline", "mixed", "template",
                                  "cycle", "ragged spline",
                                  "ragged affine"])
def test_padded_plan_matches_plan(kind):
    """The plain version on the kernels' padded plan (zero rows and
    columns, padded slabs) against the unpadded plan, float64: the same y,
    ladj and gradients of x and of the plan's weights to 1e-12."""
    tc, d = _stack64(kind)
    st = TC._stack_structure(tc, d)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(60, d)) * 1.5)
    gy = torch.from_numpy(rng.normal(size=(60, d)))
    gl = torch.from_numpy(rng.normal(size=60))
    with torch.no_grad():
        wbuf, pbuf = TC._stack_plan(tc, st, torch.float64, x.device)
    outs = []
    for padded in (False, True):
        xr = x.clone().requires_grad_(True)
        wr = wbuf.clone().requires_grad_(True)
        y, l = TC.coupling_forward_plain(st, wr, pbuf, xr, padded=padded)
        outs.append([y, l, *torch.autograd.grad([y, l], [xr, wr],
                                                [gy, gl])])
    for a, b, what in zip(*outs, ("y", "ladj", "gx", "gw")):
        _close(b, a, 1e-12, what)


def test_kernel_buffer_packs_the_padded_plan():
    """The kernel buffer: each layer's padded W and W^T in the B-fragment
    order of mma.sync.m16n8k8 (lane (n % 8) * 4 + k % 4 holds rows k and
    k + 4 of column n), rounded to TF32, then the padded biases; and the
    weight-gradient gather inverts the padding."""
    tc, d = _stack64("ragged spline")
    st = TC._stack_structure(tc, d)
    pp = TC._padded(st)
    wbuf, _ = TC._stack_plan(tc, st, torch.float32, "cpu")
    wbuf = wbuf.detach()
    wk = TC._kernel_weights(st, wbuf)
    wn = TC._padded_buffer(st, wbuf)
    for li, (Kp, Np) in enumerate(pp.kn):
        W, b = TC._layer(st, wn, li, pp)
        ow, owt, ob = pp.k_offs[li]
        for M, off in ((W, ow), (W.T, owt)):
            R, Cn = M.shape
            frag = wk[off:off + R * Cn].view(R // 8, Cn // 8, 8, 4, 2)
            # frag[kk, nt, g, t, i] = M[8 kk + t + 4 i, 8 nt + g]
            want = M.reshape(R // 8, 2, 4, Cn // 8, 8).permute(0, 3, 4, 2, 1)
            _close(frag, TC._round_tf32(want.contiguous()), 0.0, "packed")
        _close(wk[ob:ob + Np], b, 0.0, "bias")
    assert torch.equal(wn[torch.as_tensor(pp.grad_idx)], wbuf)
    # TF32: 10 mantissa bits, to nearest, ties away from zero.
    v = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11),
                      3.0], dtype=torch.float32)
    _close(TC._round_tf32(v), torch.tensor([1.0 + 2 ** -10, 1.0,
                                            -(1.0 + 2 ** -9), 3.0]), 0.0)


# ------------------------------------------------------------------
# Dispatch and import rules.

def test_fusible_predicate():
    g = torch.Generator().manual_seed(0)
    ok = et.coupling_stack(g, 8, 2, (16,), device="cpu")
    assert TC.is_fusible_coupling_stack(ok, 8)
    assert not TC.is_fusible_coupling_stack(ok, 8, torch.float64)
    assert not TC.is_fusible_coupling_stack(ok, 8, torch.bfloat16)
    odd = et.coupling_stack(g, 5, 2, (8,), device="cpu")
    assert not TC.is_fusible_coupling_stack(odd, 5)
    mixing = et.Chain.of(et.Permute((0, 4, 2, 6, 1, 5, 3, 7)), *ok.stages)
    assert not TC.is_fusible_coupling_stack(mixing, 8)
    assert TC.is_fusible_coupling_stack(
        et.Chain.of(et.Permute(CYCLE), *ok.stages), 8)
    bf16 = et.coupling_stack(g, 8, 2, (16,), device="cpu")
    bf16.stages[0].conditioner.compute_dtype = "bfloat16"
    assert not TC.is_fusible_coupling_stack(bf16, 8)
    elementwise_only = et.Chain.of(et.ScaleShift(torch.ones(8),
                                                 torch.zeros(8)))
    assert not TC.is_fusible_coupling_stack(elementwise_only, 8)
    # The (1024, 1024) d=64 stack that tests/test_coupling.py:289-304 has
    # the TPU accept: B4 and B5 in 16-row tiles (a 1024-column pass); the
    # BASELINE stacks in 64-row tiles.
    big = et.coupling_stack(g, 64, 4, (1024, 1024), device="cpu")
    assert TC.is_fusible_coupling_stack(big, 64)
    for backward in (False, True):
        assert TC._pick_tile(TC._stack_structure(big, 64), backward) == 16
        for base in (et.coupling_stack(g, 64, 4, (512, 512), device="cpu"),
                     et.spline_coupling_stack(g, 64, 4, (512, 512), n_bins=8,
                                              bound=5.0, device="cpu")):
            assert TC._pick_tile(TC._stack_structure(base, 64),
                                 backward) == 64
    huge = et.coupling_stack(g, 64, 2, (4096,), device="cpu")
    assert not TC.is_fusible_coupling_stack(huge, 64)


def test_wrappers_reject_what_the_kernels_do_not_take():
    tc = et.coupling_stack(torch.Generator().manual_seed(0), 8, 2, (16,),
                           device="cpu")
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        TC.fused_coupling_forward_and_ladj(tc, torch.empty(4, 8,
                                                           device="meta"))
    with pytest.raises(ValueError):
        TC.fused_coupling_forward_and_ladj(tc, torch.zeros(8))
    with pytest.raises(ValueError):
        TC.fused_coupling_forward_and_ladj(
            et.Chain.of(et.Permute((0, 4, 2, 6, 1, 5, 3, 7)), *tc.stages),
            torch.zeros(4, 8))


def _trainer_data():
    """The data and stack of tests/test_coupling.py:230-256."""
    key = _key(8)
    dim = 8
    A = jax.random.normal(key, (dim, dim), F32) * 0.3 + jnp.eye(dim,
                                                                dtype=F32)
    X = jax.random.normal(jax.random.fold_in(key, 1), (8192, dim), F32) @ A.T
    stack = jax_coupling_stack(jax.random.fold_in(key, 2), dim, n_layers=2,
                               hidden=(16, 16))
    return X, stack


def test_trainer_coupling_dispatch_matches_jax():
    """optax.adam and torch.optim.Adam place eps alike: both update by
    m_hat / (sqrt(v_hat) + eps), eps = 1e-8, with the same bias
    corrections, so the histories agree to f32 rounding."""
    X, jstack = _trainer_data()
    r_fused = jax_optimize_whitening(X, jstack, optax.adam(3e-3),
                                     nbatches=2, nepochs=3,
                                     use_fused="coupling")
    r_std = jax_optimize_whitening(X, jstack, optax.adam(3e-3), nbatches=2,
                                   nepochs=3, use_fused=False)
    adam = lambda p: torch.optim.Adam(p, lr=3e-3)
    Xt = torch.tensor(np.asarray(X))
    before = dict(TC.LAUNCHES)
    tstack = from_jax(jstack, device="cpu")
    rt = optimize_whitening(Xt, tstack, adam, nbatches=2, nepochs=3,
                            use_fused="coupling")
    assert rt.result is not tstack and rt.negll_history.shape == (6,)
    for ref in (r_fused, r_std):
        np.testing.assert_allclose(rt.negll_history.numpy(),
                                   np.asarray(ref.negll_history), rtol=2e-4,
                                   atol=2e-4)
    for name, leaf in _named_leaves(r_std.result, rt.result).items():
        _close(dict(rt.result.named_parameters())[name], leaf, 2e-3, name)
    # The default dispatch of a CPU batch is the plain path, same history.
    rd = optimize_whitening(Xt, from_jax(jstack, device="cpu"), adam,
                            nbatches=2, nepochs=3)
    _close(rd.negll_history, rt.negll_history, 1e-6)
    assert TC.LAUNCHES == before
    with pytest.raises(ValueError):
        optimize_whitening(Xt[:, :5], et.coupling_stack(
            torch.Generator(), 5, 2, (8,), device="cpu"), adam,
            nbatches=2, nepochs=1, use_fused="coupling")


def test_modules_do_not_import_jax():
    code = ("import sys; import enflows_tpu_torch, "
            "enflows_tpu_torch.ops.coupling, "
            "enflows_tpu_torch.bijectors.coupling, "
            "enflows_tpu_torch.bijectors.spline, enflows_tpu_torch.interop, "
            "enflows_tpu_torch.train.whitening, enflows_tpu_torch.ops._build, "
            "enflows_tpu_torch.train.vi, enflows_tpu_torch.infer, "
            "enflows_tpu_torch.examples.nf_variational_1d; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'enflows_tpu.')) or m == 'enflows_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    for rel in ("ops/coupling.py", "bijectors/coupling.py",
                "bijectors/spline.py", "ops/csrc/coupling.cu", "train/vi.py",
                "infer.py", "examples/nf_variational_1d.py"):
        src = open(os.path.join(ROOT, "enflows_tpu_torch", rel)).read()
        assert "import jax" not in src and "from jax" not in src
        assert "enflows_tpu." not in src.replace("enflows_tpu_torch", "")
