"""bf16 in the port against the JAX package, on the CPU.

Two arithmetics, each where JAX has it:

* the bijector's bf16 conditioner (``MLPConditioner(compute_dtype=
  "bfloat16")``): input, W and b cast to bf16, every layer and activation
  computed in bf16, the output cast to W's dtype
  (``enflows_tpu/bijectors/coupling.py:67-78``);
* the kernels' bf16: bf16 storage (x, y, ladj, gx and B6's q, p, logp
  rounded to bf16, the arithmetic in float32, B1-B3 and B6's chain
  parameters rounded to bf16) and B4/B5's bf16-operand products with
  float32 accumulation (``_mm_bf16``), bias, activation and epilogue in
  float32.

Each comparison states its tolerance. A bf16 ulp is 2^-8 relative at the
top of a binade (2^-7 at its bottom); a value computed by two frameworks in
float32 and rounded once to bf16 may land one ulp apart where the float32
values straddle a rounding boundary, so a per-element bound of one bf16 ulp
holds where both compute the same float32 function. Where one side rounds
intermediate values to bf16 (the bijector's conditioner, JAX's bf16
parameter gradients), the bound is relative, with its reason.
"""
import functools

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
from enflows_tpu.bijectors.householder import householder_matrix
from enflows_tpu.distributions.base import std_normal_logpdf_sum
from enflows_tpu.ops.pallas import elementwise as JEW
from enflows_tpu.ops.pallas.coupling import (
    _mm_bf16, fused_coupling_forward_and_ladj as jax_fused_coupling)
from enflows_tpu.ops.pallas.elementwise import (
    fused_forward_and_ladj as jax_b1, fused_negll_value_and_grad as jax_b3)
from enflows_tpu.ops.pallas.leapfrog import fused_leapfrog as jax_leapfrog
from enflows_tpu.train import optimize_whitening as jax_optimize_whitening

import enflows_tpu_torch as et
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.ops import coupling as TC
from enflows_tpu_torch.ops import elementwise as TE
from enflows_tpu_torch.ops import leapfrog as TL
from enflows_tpu_torch.ops.coupling import _MatmulBF16
from enflows_tpu_torch.train import optimize_whitening

torch.set_num_threads(1)

F32, BF16 = jnp.float32, jnp.bfloat16
DIM = 8


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, F32))


def _ulps(a, b, floor=0.0):
    """Max |a - b| in bf16 ulps of the larger magnitude, elementwise; with
    ``floor``, of at least floor x max|b|: where a result cancels to a small
    fraction of the largest, f32 sums in another order move it by more than
    an ulp of its own magnitude."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    m = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor * np.abs(b).max())
    ulp = np.ldexp(1.0, np.frexp(m)[1] - 8)
    return float((np.abs(a - b) / np.maximum(ulp, 2.0 ** -126)).max())


def _rel(a, b):
    """max|a - b| / (1 + max|b|)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        tree)


def _named(jtree, tmodule):
    leaves = jax.tree.leaves(jtree)
    names = [k for k, _ in tmodule.named_parameters()]
    assert len(leaves) == len(names)
    return dict(zip(names, leaves))


# ------------------------------------------------------------------
# The bijector's bf16 conditioner.

def _bf16_stack(kind, small=False):
    """Perturbed JAX stacks at d=8 with bf16 conditioners; "mixed" puts an
    f32-conditioner affine stack before a bf16 spline stack. ``small``
    (one coupling of each in "mixed", one hidden layer in "affine") for
    JAX's interpret-mode kernels, which compile for seconds a layer."""
    if kind == "affine":
        c = jax_coupling_stack(jax.random.PRNGKey(1), DIM, 2 if small else 3,
                               (16,) if small else (16, 16),
                               compute_dtype="bfloat16")
    elif kind == "spline":
        c = jax_spline_stack(jax.random.PRNGKey(2), DIM, 2, (16,),
                             n_bins=5, bound=3.0, compute_dtype="bfloat16")
    else:
        n = 1 if small else 2
        a = jax_coupling_stack(jax.random.PRNGKey(3), DIM, n,
                               (16,) if small else (16, 16))
        s = jax_spline_stack(jax.random.PRNGKey(4), DIM, n, (12,), n_bins=4,
                             bound=3.0, activation="silu",
                             compute_dtype="bfloat16")
        c = ef.Chain.of(*a.stages, ef.Permute(perm=(1, 2, 3, 0, 6, 7, 4, 5)),
                        *s.stages)
    return _perturb(c, seed=len(kind))


def _x(n=128, seed=0):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)


def _loss_grads(tc, x, forward):
    params = dict(tc.named_parameters())
    xr = torch.from_numpy(x).requires_grad_(True)
    y, l = forward(tc, xr)
    gs = torch.autograd.grad(torch.sin(y.float()).sum() + l.float().sum(),
                             [xr, *params.values()])
    return gs[0], dict(zip(params, gs[1:]))


def _jax_loss_grads(jc, x, forward):
    """(y, ladj, parameter gradients, gx) of ``_loss_grads``'s loss, in one
    compiled function."""
    def loss(c, xx):
        y, l = forward(c, xx)
        return (jnp.sum(jnp.sin(y.astype(F32))) + jnp.sum(l.astype(F32)),
                (y, l))
    (_, (y, l)), (gc, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jc, jnp.asarray(x))
    return y, l, gc, gx


@pytest.mark.parametrize("kind", ["affine", "spline", "mixed"])
def test_bijector_bf16_conditioner_matches_jax(kind):
    """The bijector route: forward, ladj and every gradient against JAX's
    jnp path, both taking the same f32 weights through ``from_jax``. Every
    conditioner layer is rounded to bf16 in both, with f32 sums in the
    products and an ordering of them that differs between XLA and torch, so
    a conditioner output may land one bf16 ulp apart; through the
    coupling's exp(s) and the spline's bins that is ~1e-2 of a value. The
    bound is 2e-2 x (1 + max|JAX|) for y, ladj and each gradient leaf, 25x
    under the error of a conditioner without its bf16 rounding (measured
    0.3-0.6 relative here)."""
    jc = _bf16_stack(kind)
    tc = from_jax(jc, device="cpu")
    assert all(p.dtype == torch.float32 for p in tc.parameters())
    x = _x(seed=ord(kind[0]))
    yj, lj, gcj, gxj = _jax_loss_grads(jc, x,
                                       lambda c, v: c.forward_and_ladj(v))
    y, l = tc.forward_and_ladj(torch.from_numpy(x))
    assert y.dtype == torch.float32 and l.dtype == torch.float32
    assert _rel(y, yj) <= 2e-2 and _rel(l, lj) <= 2e-2, (_rel(y, yj),
                                                        _rel(l, lj))
    gx, g = _loss_grads(tc, x, lambda c, v: c.forward_and_ladj(v))
    assert _rel(gx, gxj) <= 2e-2
    for name, leaf in _named(gcj, tc).items():
        assert g[name].dtype == torch.float32
        assert _rel(g[name], leaf) <= 2e-2, (name, _rel(g[name], leaf))


def test_bijector_bf16_round_trip_and_ladj():
    """tests/test_pallas_fused.py:378-403 on the port: the inverse
    recomputes the same bf16 conditioner, so the round trip is exact up to
    f32 rounding (1e-5), and the ladj is the log-determinant of the
    realized map's autograd Jacobian within 2e-2 (the Jacobian's tangents
    pass through bf16 products themselves)."""
    g = torch.Generator().manual_seed(11)
    stack = et.coupling_stack(g, DIM, n_layers=2, hidden=(32, 32),
                              compute_dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for p in stack.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    x = torch.from_numpy(_x(64, seed=2))
    y, ladj = stack.forward_and_ladj(x)
    xb = stack.inverse().forward(y)
    np.testing.assert_allclose(_np(xb), _np(x), rtol=1e-5, atol=1e-5)
    jac = torch.stack([torch.autograd.functional.jacobian(
        lambda v: stack.forward(v[None])[0], x[i]) for i in range(8)])
    _, logdet = np.linalg.slogdet(jac.double().numpy())
    np.testing.assert_allclose(_np(ladj[:8]), logdet, rtol=2e-2, atol=2e-2)


def test_matmul_bf16_matches_jax_mm_bf16():
    """``_MatmulBF16`` against JAX's ``_mm_bf16``: value and VJP. Both
    round the operands (and the cotangent) to bf16 and sum exact products
    in f32, so they differ by the order of f32 sums: 1e-6 x the sum of the
    terms' magnitudes."""
    rng = np.random.default_rng(7)
    h, W, g = (rng.normal(size=s).astype(np.float32)
               for s in ((64, 48), (48, 40), (64, 40)))
    vj, vjp = jax.vjp(_mm_bf16, jnp.asarray(h), jnp.asarray(W))
    dhj, dWj = vjp(jnp.asarray(g))
    ht, Wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, W))
    v = _MatmulBF16.apply(ht, Wt)
    dh, dW = torch.autograd.grad(v, [ht, Wt], torch.from_numpy(g))
    for got, want, a, b in ((v, vj, h, W), (dh, dhj, g, W.T),
                            (dW, dWj, h.T, g)):
        scale = np.abs(a) @ np.abs(b)
        assert got.dtype == torch.float32
        assert float((np.abs(_np(got) - _np(want)) / (scale + 1e-30))
                     .max()) <= 1e-6
    # The operands really are rounded: a value bf16 cannot hold.
    one = torch.tensor([[1.0 + 2 ** -10]])
    assert float(_MatmulBF16.apply(one, torch.ones(1, 1))) == 1.0


# ------------------------------------------------------------------
# The plain B4/B5 with bf16 products (and bf16 storage) against JAX's
# fused coupling kernel in interpret mode.

@pytest.mark.parametrize("kind,storage", [("affine", "f32"),
                                          ("mixed", "f32"),
                                          ("affine", "bf16")])
def test_plain_bf16_b4_b5_matches_pallas(kind, storage):
    """y, ladj, gx and the parameter gradients of the plain version with
    bf16-operand products (``_MatmulBF16``) against JAX's kernel in
    interpret mode (``_mm_bf16``). Both compute the same f32 function of
    the same bf16-rounded operands; the activations feeding the next
    product are f32 values rounded to bf16 again, where an f32 ordering
    difference can flip a rounding and move a product by 2^-8 of one term.
    Bound: 2e-3 x (1 + max|JAX|) on every output (measured <= 2e-4). With
    bf16 storage y and ladj are bf16 in both and held to 2 bf16 ulps
    elementwise: one for the storage rounding, one for a flipped operand
    rounding upstream."""
    jc = _bf16_stack(kind, small=True)
    tc = from_jax(jc, device="cpu")
    x = _x(256, seed=5)
    if storage == "bf16":
        x = np.array(jnp.asarray(x, BF16).astype(F32))
        xj = jnp.asarray(x, BF16)
        xt = torch.from_numpy(x).bfloat16()
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    assert TC.is_fusible_coupling_stack(tc, DIM, xt.dtype)
    if storage == "bf16":
        yj, lj = jax_fused_coupling(jc, xj)
    else:
        yj, lj, gcj, gxj = _jax_loss_grads(jc, x, jax_fused_coupling)
    before = dict(TC.LAUNCHES_BF16)
    y, l = TC.fused_coupling_forward_and_ladj(tc, xt)
    assert TC.LAUNCHES_BF16 == before                  # the plain version
    assert y.dtype == xt.dtype and l.dtype == xt.dtype
    if storage == "bf16":
        assert yj.dtype == BF16
        assert _ulps(y, yj) <= 2 and _ulps(l, lj) <= 2, (_ulps(y, yj),
                                                        _ulps(l, lj))
        return
    assert _rel(y, yj) <= 2e-3 and _rel(l, lj) <= 2e-3, (_rel(y, yj),
                                                        _rel(l, lj))
    gx, g = _loss_grads(tc, x, TC.fused_coupling_forward_and_ladj)
    assert _rel(gx, gxj) <= 2e-3
    for name, leaf in _named(gcj, tc).items():
        assert g[name].dtype == torch.float32
        assert _rel(g[name], leaf) <= 2e-3, (name, _rel(g[name], leaf))


@pytest.mark.parametrize("kind", ["mixed", "spline"])
def test_bf16_plan_pads_and_packs_for_m16n8k16(kind):
    """A bf16 coupling's padded K and hidden widths are multiples of 16
    (the k-step of its bf16 products) while an f32 one's stay multiples of
    8; its slabs stay multiples of 8, and its last layer's W^T is packed
    slab by slab at the depth B5's dh reads, padded to 16 with zero rows.
    Its packed W (pass by pass, the last layer slab by slab) and W^T hold
    two bf16 values to a word in the order the wgmma kernels stream them:
    per pass of columns padded to 64, per 16-row k-step, per 8-column
    group, two core matrices of 8 columns x 8 rows, each column's 8 values
    contiguous, the lower row in the lower half of a word."""
    jc = _bf16_stack(kind)
    tc = from_jax(jc, device="cpu")
    st = TC._stack_structure(tc, DIM)
    pp = TC._padded(st)
    assert pp.tm == 64
    flags = st.layer_bf16
    assert any(flags) and all(flags) == (kind == "spline")
    for (Kp, Np), bf in zip(pp.kn, flags):
        assert Kp % (16 if bf else 8) == 0 and Np % 8 == 0
    for it, (G, sw, ns) in zip(st.items, pp.slabs):
        if it.kind != "elem":
            assert sw % 8 == 0 and pp.lda >= TC._slab_depth(it, sw)
    last = {it.layer0 + it.n_layers - 1: sw
            for it, (G, sw, ns) in zip(st.items, pp.slabs)
            if it.kind != "elem"}
    # The spline's slab of 4 lanes x 14 parameters is 56 wide: read at 64.
    assert kind != "spline" or set(last.values()) == {56}
    wbuf, _ = TC._stack_plan(tc, st, torch.float32, "cpu")
    wbuf = wbuf.detach()
    wk = TC._kernel_weights(st, wbuf)
    wn = TC._padded_buffer(st, wbuf)
    for li, ((Kp, Np), bf) in enumerate(zip(pp.kn, flags)):
        W, b = TC._layer(st, wn, li, pp)
        ow, owt, ob = pp.k_offs[li]
        torch.testing.assert_close(wk[ob:ob + Np], b, rtol=0, atol=0)
        if not bf:
            continue
        WT = W.T
        if li in last:
            # B5 reads a bf16 slab at its depth padded to 16: W^T's rows
            # slab by slab, zero rows between.
            sw = last[li]
            sk = TC._slab_depth(st.items[0]._replace(bf16=True), sw)
            WT = torch.zeros(Np // sw * sk, Kp)
            for s in range(Np // sw):
                WT[s * sk:s * sk + sw] = W.T[s * sw:(s + 1) * sw]
        for M, off, pw in ((W, ow, last.get(li, Np)), (WT, owt, Kp)):
            R, Cn = M.shape
            pw64 = -(-pw // 64) * 64
            want = []
            for p in range(Cn // pw):
                blk = torch.zeros(R, pw64)
                blk[:, :pw] = M[:, p * pw:(p + 1) * pw]
                # [k-step, group, core, column, value]
                want.append(blk.reshape(R // 16, 2, 8, pw64 // 8, 8)
                            .permute(0, 3, 1, 4, 2).reshape(-1))
            want = torch.cat(want)
            vals = wk[off:off + want.numel() // 2].view(torch.bfloat16)
            torch.testing.assert_close(
                vals.float(), want.bfloat16().float(), rtol=0, atol=0)
    arrays = TC._plan_arrays(st)[2]
    assert [arrays[8 * l + 7] for l in range(len(flags))] == \
        [int(f) for f in flags]


# ------------------------------------------------------------------
# The plain bf16-storage B1-B3 and B6 against JAX's kernels in interpret
# mode.

def _ew_chain(d, k=3):
    """tests/test_pallas_fused.py's full_chain with a Householder stage of
    k reflections."""
    F = F32
    return ef.compose(
        ef.Johnson(gamma=jnp.full(d, 0.3, F), delta=jnp.full(d, 5.0, F),
                   xi=jnp.zeros(d, F), lam=jnp.full(d, 5.0, F)),
        ef.Householder(V=jax.random.normal(
            jax.random.PRNGKey(0), (k, d), F)).canonicalize(),
        ef.invert(ef.CenterStretch(a=jnp.full(d, 1.0, F),
                                   b=jnp.full(d, 1.5, F),
                                   c=jnp.full(d, 0.1, F))),
        ef.ScaleShift(a=jnp.full(d, 1.3, F), b=jnp.full(d, -0.4, F)),
        ef.JohnsonInv(gamma=jnp.zeros(d, F), delta=jnp.full(d, 5.0, F),
                      xi=jnp.zeros(d, F), lam=jnp.full(d, 5.0, F)),
        ef.CenterStretch(a=jnp.full(d, 0.4, F), b=jnp.full(d, 2.0, F),
                         c=jnp.zeros(d, F)))


_jfwd = jax.jit(lambda c, v: c.forward_and_ladj(v))


def _to16(tree):
    return jax.tree.map(lambda p: p.astype(BF16), tree)


def _r16(v):
    """v rounded to bf16 and held in f32, its cotangent rounded to bf16 on
    the way back (``astype``'s transpose), as torch's casts of the port's
    bf16 outputs round theirs."""
    return v.astype(BF16).astype(F32)


def _st16(p):
    """p rounded to bf16 and held in f32, its gradient passed through
    unrounded: the port's ``round_to`` for a plan's parameters."""
    return p + jax.lax.stop_gradient(_r16(p) - p)


@functools.lru_cache(maxsize=None)
def _ew_chain_f32(d, k=3):
    """``_ew_chain`` with every parameter moved off bf16's grid by 2e-2
    normal noise: f32 values that bf16 cannot hold, so that the port's plan
    has to round them (a plan that skipped it differs from JAX in 64-100%
    of the bf16 outputs, from its gradients by 1e-2 to 3e-1 relative)."""
    rng = np.random.default_rng(1000 + d + k)
    leaves, tree = jax.tree.flatten(_ew_chain(d, k))
    moved = [np.asarray(p, np.float32)
             + (0.02 * rng.normal(size=p.shape)).astype(np.float32)
             for p in leaves]
    assert all((p.astype(BF16).astype(np.float32) != p).all() for p in moved)
    return jax.tree.unflatten(tree, [jnp.asarray(p) for p in moved])


def _plan16(c, x):
    """JAX's float32 arithmetic of the bf16 plan for a chain given f32
    parameters: every parameter rounded to bf16, a Householder stage as its
    dense Q built in f32 from the f32 V and then rounded, as JAX's B1 casts
    them into the storage dtype (elementwise.py:269, :296), the gradients
    passed through the rounding as the port's plan passes them. JAX's own bf16
    gradients do not run on the CPU (see below), so this is the reference
    for the port's gradients."""
    ladj = jnp.zeros(x.shape[:-1], F32)
    for s in c.stages:
        if isinstance(s, ef.Householder):
            Q = householder_matrix(jnp.atleast_2d(s.V), dtype=F32)
            x = x @ _st16(Q).T
        else:
            x, l = jax.tree.map(_st16, s).forward_and_ladj(x)
            ladj = ladj + l
    return x, ladj


def _share_unequal(a, b):
    """The share of elements of two bf16 results that are not bit-equal."""
    a, b = _np(a), _np(jnp.asarray(jnp.asarray(b, F32), BF16))
    return float((a != b).mean())


def _q999(err):
    return float(np.quantile(np.asarray(err, np.float64), 0.999))


# (d, reflections): the port's plan applies a Householder stage of k
# reflections with 2k > d as its dense Q, built in f32 and rounded to bf16
# as JAX's _householder_blockdiag rounds it: the same f32 function, held
# per element to one bf16 ulp. With 2k <= d the plan applies the rounded
# reflection rows one by one, another rounding of the same orthogonal map:
# held by JAX's calibrated gate alone.
EW_CASES = [(2, 3), (4, 3), (50, 30), (50, 3)]


# Per-element bounds in bf16 ulps hold values below 2^-7 of the largest to
# the ulp at that level (``_ulps``'s floor).
CANCEL = 2.0 ** -7


def _dense(d, k):
    return 2 * k > d


def _x16(d, seed, n=256):
    """(x16 in JAX, its f32 values in JAX, the same bf16 tensor for the
    port)."""
    x16 = jnp.asarray(np.random.default_rng(seed).normal(size=(n, d)), BF16)
    xr32 = x16.astype(F32)
    return x16, xr32, torch.from_numpy(np.array(xr32)).bfloat16()


@pytest.mark.parametrize("d,k", EW_CASES)
def test_plain_bf16_b1_matches_pallas(d, k):
    """B1 with bf16 storage and f32 parameters that bf16 cannot hold
    (``_ew_chain_f32``): JAX's ``fused_forward_and_ladj(chain, x16,
    force_packed=True)``, which casts the parameters and the dense Q into
    bf16 (elementwise.py:269, :296), against the port's plain version,
    whose plan rounds them. With a dense Q both compute the same f32
    function: every element within one bf16 ulp (of at least 2^-7 of the
    largest, ``CANCEL``), and at most 1% of them
    not bit-equal (an f32 ordering difference straddling a rounding
    boundary; 64-87% without the parameters' rounding). Both against the
    f32 chain on f32 x by tests/test_pallas_fused.py:333-375's calibrated
    gate: the 99.9% quantile of the error within 4x that of the chain's own
    bf16 path (JAX's, on the chain cast to bf16) or 1e-2 x max|f32|."""
    jc = _ew_chain_f32(d, k)
    tc = from_jax(jc, device="cpu")
    assert all(p.dtype == torch.float32 for p in tc.parameters())
    assert TE.is_fusible_chain(tc, d, torch.bfloat16)
    x16, xr32, xt = _x16(d, d + k)
    yj, lj = jax_b1(jc, x16, force_packed=True)
    assert yj.dtype == BF16
    y, l = TE.fused_forward_and_ladj(tc, xt)
    assert y.dtype == torch.bfloat16 and l.dtype == torch.bfloat16
    if _dense(d, k):
        assert _ulps(y, yj, CANCEL) <= 1 and _ulps(l, lj, CANCEL) <= 1, (
            _ulps(y, yj, CANCEL), _ulps(l, lj, CANCEL))
        assert _share_unequal(y, yj) <= 0.01 and _share_unequal(l, lj) \
            <= 0.01, (_share_unequal(y, yj), _share_unequal(l, lj))
    y_ref, l_ref = _jfwd(jc, xr32)
    y_jnp, l_jnp = _jfwd(_to16(jc), x16)
    for got, jnp_path, ref in ((y, y_jnp, y_ref), (l, l_jnp, l_ref)):
        scale = float(np.abs(_np(ref)).max()) + (0.0 if got is y else 1.0)
        e_port = _q999(np.abs(_np(got) - _np(ref)))
        e_jnp = _q999(np.abs(_np(jnp_path) - _np(ref)))
        assert e_port <= max(4.0 * e_jnp, 1e-2 * scale), (e_port, e_jnp)


@pytest.mark.parametrize("d,k", [(2, 3), (50, 30)])
def test_plain_bf16_b2_b3_match_jax(d, k):
    """B2 and B3 with bf16 storage, on f32 parameters that bf16 cannot
    hold. JAX's own bf16 gradients do not run on the CPU: the vjp of its
    bf16 packed forward and its bf16 B3 in interpret mode raise a dtype
    error (a float32 cotangent for a bf16 output of their custom_vjp). So
    the port is held to JAX's autodiff of ``_plan16``, the same f32
    function of the rounded parameters and dense Q, with y and ladj rounded
    to bf16 in the loss as the port's outputs are. gx (bf16 in the port):
    at most 1% of it not bit-equal, each element within 4 bf16 ulps (a y
    or ladj that lands on the neighbouring bf16 value in one package moves
    its row's cotangent; without the parameters' rounding: 330-475 ulps,
    85-94% unequal); every parameter gradient (f32 in the port) within
    1e-3 x (1 + max|JAX|), the same cotangents summed in another order
    (measured <= 1.3e-4; without the parameters' rounding 1e-2 to 3e-1).
    B3, whose cotangents are not rounded: negll (bf16) within one ulp, its
    gradients within 1e-4 (without the rounding 8e-3 to 2e-2)."""
    jc = _ew_chain_f32(d, k)
    tc = from_jax(jc, device="cpu")
    x16, xr32, xt = _x16(d, d)

    def loss(c, xx):
        y, l = _plan16(c, xx)
        return jnp.sum(jnp.sin(_r16(y))) + jnp.sum(_r16(l) ** 2)

    gcj, gxj = jax.jit(jax.grad(loss, argnums=(0, 1)))(jc, xr32)
    xr = xt.clone().requires_grad_(True)
    y, l = TE.fused_forward_and_ladj(tc, xr)
    (torch.sin(y.float()).sum() + (l.float() ** 2).sum()).backward()
    assert xr.grad.dtype == torch.bfloat16
    assert _ulps(xr.grad, gxj, CANCEL) <= 4 and _share_unequal(
        xr.grad, gxj) <= 0.01, (_ulps(xr.grad, gxj, CANCEL),
                                _share_unequal(xr.grad, gxj))
    g = {k_: p.grad for k_, p in tc.named_parameters()}
    for name, leaf in _named(gcj, tc).items():
        assert g[name].dtype == torch.float32
        assert _rel(g[name], leaf) <= 1e-3, (name, _rel(g[name], leaf))

    def negll(c, xx):
        y, l = _plan16(c, xx)
        return -(jnp.sum(std_normal_logpdf_sum(y)) + jnp.sum(l)) / xx.shape[0]

    vj, gj = jax.jit(jax.value_and_grad(negll))(jc, xr32)
    v, gt = TE.fused_negll_value_and_grad(tc, xt)
    assert v.dtype == torch.bfloat16
    assert _ulps(v, vj) <= 1, (float(v), float(vj))
    for name, leaf in _named(gj, tc).items():
        assert gt[name].dtype == torch.float32
        assert _rel(gt[name], leaf) <= 1e-4, (name, _rel(gt[name], leaf))


def _b6_chain(d, reflections):
    F = F32
    stages = [ef.Johnson(gamma=jnp.full(d, 0.2, F), delta=jnp.full(d, 5.0, F),
                         xi=jnp.zeros(d, F), lam=jnp.full(d, 5.0, F))]
    if reflections:
        stages.append(ef.Householder(V=jax.random.normal(
            jax.random.PRNGKey(0), (reflections, d), F)).canonicalize())
    stages.append(ef.invert(ef.CenterStretch(
        a=jnp.full(d, 0.5, F), b=jnp.full(d, 1.5, F), c=jnp.zeros(d, F))))
    rng = np.random.default_rng(reflections)
    return jax.tree.map(lambda p: p + jnp.asarray(
        0.02 * rng.normal(size=p.shape), F), ef.compose(*stages))


@pytest.mark.parametrize("reflections", [6, 0])
def test_plain_bf16_b6_matches_pallas(reflections):
    """B6 with bf16 q and p, on f32 parameters that bf16 cannot hold. JAX's
    bf16 B6 does not run on the CPU (its in-kernel vjp meets the same dtype
    error as its bf16 gradients above), so the port is held to JAX's
    ``fused_leapfrog`` in interpret mode in float32 on the chain cast to
    bf16 and q, p rounded to bf16. Without a Householder stage that is the
    port's f32 function: q_L, p_L, logp_0 and logp_L within one bf16 ulp,
    at most 2% of them not bit-equal (8 leapfrog steps of f32 sums in
    another order; without the parameters' rounding most elements move).
    With one (6 reflections at d=8, a dense Q) the port rounds Q as B1
    does, JAX's f32 run keeps it unrounded (~2^-9 relative in a product):
    within 1e-2 x (1 + max|JAX|), a couple of bf16 ulps."""
    d = 8
    jc = _b6_chain(d, reflections)
    j32 = jax.tree.map(_r16, jc)
    tc = from_jax(jc, device="cpu")
    assert TL.is_fusible_leapfrog(tc, d, torch.bfloat16)
    assert not reflections or TL.leapfrog_plan(tc, d).dense
    rng = np.random.default_rng(3)
    q = jnp.asarray(0.5 * rng.normal(size=(64, d)), BF16).astype(F32)
    p = jnp.asarray(rng.normal(size=(64, d)), BF16).astype(F32)
    outj = jax_leapfrog(j32, q, p, jnp.float32(0.1), 8)
    tq, tp = (torch.from_numpy(np.array(a)).bfloat16() for a in (q, p))
    before = dict(TL.LAUNCHES_BF16)
    out = TL.fused_leapfrog(tc, tq, tp, 0.1, 8)
    assert TL.LAUNCHES_BF16 == before
    for got, want, name in zip(out, outj, ("q", "p", "logp0", "logpL")):
        assert got.dtype == torch.bfloat16
        if reflections:
            assert _rel(got, want) <= 1e-2, (name, _rel(got, want))
        else:
            assert _ulps(got, want, CANCEL) <= 1 and _share_unequal(
                got, want) <= 0.02, (name, _ulps(got, want, CANCEL),
                                     _share_unequal(got, want))


# ------------------------------------------------------------------
# The trainers.

def test_whitening_on_bf16_samples_matches_jax():
    """optimize_whitening on bf16 samples with a fusible chain whose f32
    parameters bf16 cannot hold, Adagrad(0.1) on both sides, 8 steps of 2
    batches, against JAX's own step (``make_train_step``: loss, grad,
    update, canonicalize) over the same batches. The plain path
    (``use_fused=False``) computes the chain in float32 on the bf16 values
    (torch's promotion, as jnp's) in both packages: its history within 1e-5
    relative of JAX's ``mvnormal_negll`` steps. B3's bf16 arithmetic
    (``use_fused=True``, its plain version on a CPU batch: the parameters
    rounded to bf16 each step, negll rounded to bf16) against JAX's steps on
    ``_plan16``'s negll (JAX's own bf16 B3 does not run on the CPU, see
    above): each step's negll within one bf16 ulp, the fitted parameters
    (float32) within 1e-4 x (1 + max|JAX|)."""
    from enflows_tpu.train.whitening import make_train_step, mvnormal_negll

    d = 2
    jc = _ew_chain_f32(d)
    x16 = jnp.asarray(1.5 * np.random.default_rng(9).normal(size=(1024, d))
                      + 0.3, BF16)
    batches = x16.astype(F32).reshape(2, -1, d)

    def negll16(c, xx):
        y, l = _plan16(c, xx)
        return -(jnp.sum(std_normal_logpdf_sum(y)) + jnp.sum(l)) / xx.shape[0]

    def jax_run(loss_fn):
        opt = optax.adagrad(0.1)
        step = jax.jit(make_train_step(opt, loss_fn))
        carry, hist = (jc, opt.init(jc)), []
        for _ in range(4):
            for b in batches:
                carry, v = step(carry, b)
                hist.append(v)
        return carry[0], jnp.stack(hist)

    xt = torch.from_numpy(np.array(batches.reshape(-1, d))).bfloat16()
    before = dict(TE.LAUNCHES_BF16)
    rp = optimize_whitening(xt, from_jax(jc, device="cpu"), nbatches=2,
                            nepochs=4, use_fused=False)
    rt = optimize_whitening(xt, from_jax(jc, device="cpu"), nbatches=2,
                            nepochs=4, use_fused=True)
    assert TE.LAUNCHES_BF16 == before
    np.testing.assert_allclose(_np(rp.negll_history),
                               _np(jax_run(mvnormal_negll)[1]), rtol=1e-5)
    params, hist = jax_run(negll16)
    assert _ulps(rt.negll_history, hist) <= 1, (_np(rt.negll_history), hist)
    got = dict(rt.result.named_parameters())
    for name, leaf in _named(params, rt.result).items():
        assert got[name].dtype == torch.float32
        assert _rel(got[name], leaf) <= 1e-4, (name, _rel(got[name], leaf))


def test_bf16_conditioner_stack_trainer_matches_jax():
    """A short whitening run of a bf16-conditioner coupling stack, Adam
    (3e-3) on both: the port's plain B4/B5 route (bf16 products,
    ``use_fused="coupling"`` on a CPU batch) against JAX's fused trainer
    (its kernels in interpret mode), and the bijector route against JAX's
    jnp path. Both routes compute the same function in each package; the
    histories are held to 1e-3 relative (the f32 products' orderings, and
    a bf16 operand flipped by them, measured <= 1e-4), the parameters to
    1e-2."""
    key = jax.random.PRNGKey(21)
    A = jnp.eye(DIM, dtype=F32) + 0.3 * jax.random.normal(key, (DIM, DIM),
                                                          F32)
    X = jax.random.normal(jax.random.fold_in(key, 1), (4096, DIM), F32) @ A.T
    jstack = jax_coupling_stack(jax.random.fold_in(key, 2), DIM, n_layers=2,
                                hidden=(16,), compute_dtype="bfloat16")
    Xt = torch.tensor(np.asarray(X))
    adam = lambda p: torch.optim.Adam(p, lr=3e-3)
    for fused in ("coupling", False):
        rj = jax_optimize_whitening(X, jstack, optax.adam(3e-3), nbatches=2,
                                    nepochs=2, use_fused=fused)
        rt = optimize_whitening(Xt, from_jax(jstack, device="cpu"), adam,
                                nbatches=2, nepochs=2, use_fused=fused)
        np.testing.assert_allclose(_np(rt.negll_history),
                                   _np(rj.negll_history), rtol=1e-3,
                                   atol=1e-3)
        for name, leaf in _named(rj.result, rt.result).items():
            p = dict(rt.result.named_parameters())[name]
            assert p.dtype == torch.float32 and _rel(p, leaf) <= 1e-2, name


def test_bf16_predicates_and_checks():
    """bf16 is admitted where JAX admits it and float64 stays refused; a
    compute_dtype other than None or "bfloat16" keeps a stack off B4/B5."""
    tc = from_jax(_ew_chain(2), device="cpu")
    assert TE.is_fusible_chain(tc, 2, torch.bfloat16)
    assert TL.is_fusible_leapfrog(tc, 2, torch.bfloat16)
    assert not TE.is_fusible_chain(tc, 2, torch.float64)
    stack = from_jax(_bf16_stack("affine"), device="cpu")
    assert TC.is_fusible_coupling_stack(stack, DIM, torch.bfloat16)
    assert TC._stack_structure(stack, DIM).any_bf16
    stack.stages[0].conditioner.compute_dtype = "float16"
    assert not TC.is_fusible_coupling_stack(stack, DIM)
    with pytest.raises(ValueError):
        et.MLPConditioner([(torch.zeros(2, 2), torch.zeros(2))],
                          compute_dtype="bfloat17")
