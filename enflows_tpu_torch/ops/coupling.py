"""Fused coupling-stack kernels: plan, wrappers, plain versions, dispatch.

PyTorch counterpart of ``enflows_tpu/ops/pallas/coupling.py``. Two kernels,
hand-written in CUDA C++ for Hopper (``csrc/coupling.cu``):

* **B4** ``fused_coupling_forward_and_ladj``: forward and per-sample ladj of
  a whole coupling stack in one launch (replaces ``_fused_coupling_impl``);
* **B5** its backward, the ``backward`` of the same ``autograd.Function``
  (replaces ``_fused_coupling_bwd_impl``): a per-tile recompute and reverse
  sweep, then a batch reduction of the conditioner weight gradients.

Dispatch rule of every wrapper (as in ``ops/elementwise.py``): a CPU tensor
goes to the plain version in this module (B5's plain version is autograd
over it); a CUDA tensor launches the kernel, or raises ``ValueError`` for an
input the kernel does not take and ``RuntimeError`` when a launch fails.
Nothing falls back from a failed kernel to the plain version.

**The plan** (``_stack_plan``, after ``coupling.py:141-286``). The state of
a sample is kept in physical lane order as two halves, ``[0, d/2)`` and
``[d/2, d)``; each coupling conditions on one half and updates the other.
Permutes cost nothing at run time: each is absorbed into the next
coupling's first-layer rows and last-layer columns, and into the per-lane
parameter vectors of elementwise stages. ``out_map`` maps logical output
positions to physical lanes. The conditioner layers are packed into one flat
f32 buffer, each layer as its ``(fan_in, fan_out)`` W followed by its bias;
the elementwise stages' parameters into one buffer of per-lane vectors
(slot q at ``[q*d, (q+1)*d)``). Both are built by differentiable indexing,
so autograd maps the kernels' cotangents of these buffers back onto the
chain's Parameters, as JAX does by a vjp over ``_stack_plan``
(``coupling.py:773-777``).

The last layer's columns are **lane-grouped**: the physical half-lanes
go in groups of G (``_lanes_per_slab``), and group s holds the P
parameters (2 affine, 3K-1 spline) of its Gs lanes at ``s*G*P + p*Gs + jj``.
The kernels compute that layer one group (one N-slab) at a time and run
the group's epilogue before the next, so the widest output a block holds
is one slab (at most ``_SLAB_COLS`` columns), not 32 x (3K-1). The plain
epilogues read the slab layout of the TPU (parameter p of half-lane j at
``p * d/2 + j``) straight from the matmul: the plain version gathers the
last layer's W and b columns into that layout once per call
(``_slab_cols``), which costs nothing per row. With d/2 <= 92 the affine
layout is [scales, shifts], as before, and no gather is made.

**The kernels' padded plan** (``_padded``): every layer's K and N padded
to multiples of 8 (a TF32 k-step) with zero rows and columns, each slab of
the last layer to a multiple of 8 columns; W and W^T packed for the
kernels' path and rounded to TF32, the biases beside them. A coupling with
``compute_dtype="bfloat16"`` takes bf16 products (``_MatmulBF16``'s
arithmetic): its K and hidden widths padded to multiples of 16 (a bf16
k-step), W and W^T rounded to bf16, two to a word, its last layer's W^T
slab by slab at the depth B5's dh reads a slab (``_slab_depth``). It is a
gather of the plan above, so the Parameters are never padded, and the
weight gradients come back through the inverse gather.
``coupling_forward_plain(padded=True)`` runs the plain version on the
padded plan; the CPU tests hold it to the unpadded one in float64.

**Two paths** (``_pick_tile``, the same for B4 and B5). The Hopper path
(64-row tiles; wgmma fed by bulk copies into an mbarrier ring) takes every
stack whose padded widths and slabs are at most 512 and whose shared
memory leaves its ring two slots: W goes pass by pass (the last layer
slab by slab), W^T over its whole width, each k-step of a pass one
contiguous stage in wgmma's K-major layout (``_pack_wg``); B5's scratch and
stage inputs hold whole tiles (``_rows``). The wide path (16-row tiles,
``mma.sync``) takes the wider stacks, its W and W^T in that instruction's
B-fragment order (``_pack``, ``_pack_bf16``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..bijectors.coupling import (ACTIVATIONS, AffineCoupling,
                                  MLPConditioner, Permute)
from ..bijectors.spline import (_DERIV_SHIFT, _MIN_BIN, _MIN_DERIV,
                                RQSplineCoupling, softplus)
from ..utils.profiling import annotate
from .elementwise import (_APPLY, _CODE, ELEMENTWISE_KINDS, STORAGE_DTYPES,
                          _check_cuda_input, _ints, _raise_on, _sm_count,
                          _stages)

# Kernel launches, raised by the wrappers right after every kernel of a call
# has launched without error, and nowhere else: a stack with float32 storage
# and TF32 products only in LAUNCHES; one with a bf16 conditioner or bf16
# storage (the kernels' bf16 paths) in LAUNCHES_BF16.
LAUNCHES = {"coupling_fwd": 0, "coupling_bwd": 0}
LAUNCHES_BF16 = {"coupling_fwd": 0, "coupling_bwd": 0}

_ACT_CODE = {"tanh": 0, "gelu": 1, "relu": 2, "silu": 3}
_KIND_CODE = {"affine": 0, "spline": 1, "elem": 2}

MAX_STAGES = 24      # ENF_CMAX_STAGES in csrc/coupling.cu
MAX_LAYERS = 48      # ENF_CMAX_LAYERS
_SLAB_COLS = 184     # widest last-layer slab
_SMEM_MAX = 232448   # the card's opt-in shared memory per block
_SMEM_PER_SM = 233472
_BWD_CHUNK_ROWS = 1 << 16   # rows per B5 launch (bounds the scratch)
# The Hopper path (64-row tiles, wgmma): a pass of at most two warpgroups'
# 4 n-blocks of 64 columns; the weight ring's barriers (ENF_BARS bytes) and
# at most ENF_MAX_RING slots, each as wide as one k-step of the widest pass
# (2048 bytes an n-block); dW tiles of 128 x 256 over stages of 32 rows, 4
# deep.
_WG_PASS = 512
_WG_BARS = 512
_WG_MAX_RING = 16
_DW_M, _DW_N = 128, 256
_DW_SMEM = _WG_BARS + 4 * (4 * 32 * (_DW_M + _DW_N))
# The wide path (16-row tiles, mma.sync), for stacks the Hopper path does
# not take: ENF_RING weight ring stages of one 8-row k-step of a
# 1024-column pass (16 warps of 8 n8-tiles), dW tiles of 128 x 128 over a
# ring of 3 stages of two 32 x 136 tiles.
_RING = 3
_WIDE_PASS = 1024
_WIDE_DW_TILE = 128
_WIDE_DW_SMEM = 4 * 3 * 2 * 32 * 136


# ------------------------------------------------------------------
# Plan.

class _Item(NamedTuple):
    """One stage of the plan. ``kind`` is "affine", "spline" or "elem"."""
    kind: str
    src: int = 0            # coupling: the physical half that conditions
    inverted: bool = False
    mls: float = 0.0        # affine: max_log_scale
    n_bins: int = 0         # spline
    bound: float = 0.0      # spline
    act: str = ""
    layer0: int = 0         # index of the first layer in the flat list
    n_layers: int = 0
    a_rows: tuple = ()      # coupling: first-layer row for physical lane k
    out_cols: tuple = ()    # coupling: last-layer column gather
    lanes: int = 0          # coupling: half-lanes per last-layer slab
    code: int = 0           # elem: stage code of csrc/stages.cuh
    slot: int = 0           # elem: first parameter slot
    j_of_k: tuple = ()      # elem: logical position of physical lane k
    bf16: bool = False      # coupling: conditioner products in bf16


class _Structure(NamedTuple):
    """The static part of the plan: what the kernel is told at launch."""
    items: tuple
    layers: tuple           # (fan_in, fan_out) per layer, flat
    w_offs: tuple           # offset of each layer's W in the flat buffer
    w_len: int
    n_pslots: int
    dim: int
    out_map: tuple          # logical output position -> physical lane

    @property
    def identity_out(self) -> bool:
        return self.out_map == tuple(range(self.dim))

    @property
    def layer_bf16(self) -> tuple:
        """Per layer, whether its product runs on bf16 operands (its
        coupling's ``compute_dtype == "bfloat16"``)."""
        flags = [False] * len(self.layers)
        for it in self.items:
            for li in range(it.n_layers):
                flags[it.layer0 + li] = it.bf16
        return tuple(flags)

    @property
    def any_bf16(self) -> bool:
        return any(it.bf16 for it in self.items)


def _n_params(it) -> int:
    """Conditioner outputs per half-lane of a coupling item."""
    return 2 if it.kind == "affine" else 3 * it.n_bins - 1


def _lanes_per_slab(da: int, P: int) -> int:
    """G: half-lanes per last-layer slab, as many as keep a slab of G * P
    columns within ``_SLAB_COLS`` (at least 1, at most all d/2)."""
    return min(da, max(1, _SLAB_COLS // P))


def _grouped_col(jp, p, da, P, G):
    """Column of parameter p of physical half-lane jp in the lane-grouped
    layout: slab s = jp // G holds the P parameters of its Gs lanes at
    ``s*G*P + p*Gs + jj``."""
    s, jj = divmod(jp, G)
    return s * G * P + p * min(G, da - s * G) + jj


def _half_alignment(lane_map, dim):
    """(src, a_loc, b_loc) when the logical untouched / transformed halves
    each land on one physical half (``coupling.py:164-177``), else None."""
    da = dim // 2
    a_phys, b_phys = lane_map[:da], lane_map[da:]
    if all(p < da for p in a_phys) and all(p >= da for p in b_phys):
        return 0, list(a_phys), [p - da for p in b_phys]
    if all(p >= da for p in a_phys) and all(p < da for p in b_phys):
        return 1, [p - da for p in a_phys], list(b_phys)
    return None


def _stack_structure(chain, dim: int):
    """The plan's static part, or None where the stack is not expressible
    (``coupling.py:141-286``): a chain of AffineCoupling and
    RQSplineCoupling (split d/2, an MLPConditioner with one of the four
    activations and ``compute_dtype`` None or "bfloat16", kept per coupling
    as JAX keeps it in its plan item, :222), Permutes, and elementwise
    stages, with at least one coupling, where every coupling finds its two
    logical halves on the two physical halves. No tensor is touched."""
    if dim < 2 or dim % 2:
        return None
    da = dim // 2
    lane_map = list(range(dim))
    items, layers, n_slots = [], [], 0
    for s in _stages(chain):
        if isinstance(s, Permute):
            if sorted(s.perm) != list(range(dim)):
                return None
            lane_map = [lane_map[p] for p in s.perm]
        elif isinstance(s, (AffineCoupling, RQSplineCoupling)):
            cond = s.conditioner
            if s.split != da or not isinstance(cond, MLPConditioner) \
                    or cond.activation not in _ACT_CODE \
                    or cond.compute_dtype not in (None, "bfloat16"):
                return None
            align = _half_alignment(lane_map, dim)
            if align is None:
                return None
            src, a_loc, b_loc = align
            shapes = [tuple(d.W.shape) for d in cond.layers]
            spline = isinstance(s, RQSplineCoupling)
            P = 3 * s.n_bins - 1 if spline else 2
            if any(len(kn) != 2 for kn in shapes) or shapes[0][0] != da \
                    or shapes[-1][1] != da * P \
                    or any(shapes[i][1] != shapes[i + 1][0]
                           for i in range(len(shapes) - 1)) \
                    or any(tuple(d.b.shape) != (kn[1],)
                           for d, kn in zip(cond.layers, shapes)):
                return None
            # Lane-grouped layout: param p of physical half-lane b_loc[j]
            # takes the conditioner's column j*P + p (spline) or p*da + j
            # (affine: scales, then shifts).
            G = _lanes_per_slab(da, P)
            cols = np.empty(da * P, np.int64)
            for j in range(da):
                for p in range(P):
                    cols[_grouped_col(b_loc[j], p, da, P, G)] = \
                        j * P + p if spline else p * da + j
            items.append(_Item(
                kind="spline" if spline else "affine", src=src,
                inverted=bool(s.inverted),
                mls=0.0 if spline else float(s.max_log_scale),
                n_bins=int(s.n_bins) if spline else 0,
                bound=float(s.bound) if spline else 0.0,
                act=cond.activation, layer0=len(layers),
                n_layers=len(shapes),
                a_rows=tuple(int(i) for i in np.argsort(a_loc)),
                out_cols=tuple(int(i) for i in cols), lanes=G,
                bf16=cond.compute_dtype == "bfloat16"))
            layers.extend(shapes)
        elif isinstance(s, ELEMENTWISE_KINDS):
            j_of_k = np.empty(dim, np.int64)
            for j, k in enumerate(lane_map):
                j_of_k[k] = j
            items.append(_Item(kind="elem", code=_CODE[type(s)],
                               slot=n_slots,
                               j_of_k=tuple(int(j) for j in j_of_k)))
            n_slots += len(s.fields())
        else:
            return None
    if not any(it.kind != "elem" for it in items):
        return None
    w_offs, off = [], 0
    for K, N in layers:
        w_offs.append(off)
        off += (K + 1) * N
    return _Structure(tuple(items), tuple(layers), tuple(w_offs), off,
                      n_slots, dim, tuple(lane_map))


def _stack_plan(chain, st: _Structure, dtype, device):
    """(wbuf, pbuf): the flat conditioner buffer, each layer as W (K*N)
    then b (N) with the Permutes absorbed, and the per-lane elementwise
    parameter buffer (n_pslots * d,), physical lane order. Differentiable
    functions of the chain's Parameters."""
    flat, pvecs = [], []
    couplings = [s for s in _stages(chain)
                 if isinstance(s, (AffineCoupling, RQSplineCoupling))]
    elems = [s for s in _stages(chain) if isinstance(s, ELEMENTWISE_KINDS)]
    ci = ei = 0
    idx = lambda t: torch.tensor(t, dtype=torch.long, device=device)
    for it in st.items:
        if it.kind == "elem":
            s = elems[ei]
            ei += 1
            jk = idx(it.j_of_k)
            for p in s.fields().values():
                pvecs.append(p.to(device=device, dtype=dtype)
                             .expand(st.dim)[jk])
            continue
        dense = couplings[ci].conditioner.layers
        ci += 1
        for li, d in enumerate(dense):
            W, b = d.W.to(dtype), d.b.to(dtype)
            if li == 0:
                W = W[idx(it.a_rows)]
            if li == len(dense) - 1:
                cols = idx(it.out_cols)
                W, b = W[:, cols], b[cols]
            flat += [W.reshape(-1), b]
    wbuf = torch.cat(flat)
    pbuf = torch.cat(pvecs) if pvecs else torch.zeros(0, dtype=dtype,
                                                      device=device)
    return wbuf, pbuf


def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


def _pack_bf16(M):
    """The entries of an (R, C) matrix (R a multiple of 16, C of 8) in the
    order the B operand of ``mma.sync.m16n8k16.bf16`` is read: per 16-row
    k-step, per 8-column n-tile, 128 values (64 32-bit words, as a TF32
    fragment of ``_pack``), where lane (n % 8) * 4 + (k % 8) // 2 holds in
    its first word rows k, k + 1 (k = 2 (k % 8 // 2)) of column n and in its
    second rows k + 8, k + 9, the lower row in the lower half. Two bf16
    values to a word, so a fragment of 16 rows is read as a TF32 one of 8."""
    R, C = M.shape
    k = np.arange(R)[:, None]
    n = np.arange(C)[None, :]
    pos = (((k // 16) * (C // 8) + n // 8) * 128
           + ((n % 8) * 4 + (k % 8) // 2) * 4 + ((k % 16) // 8) * 2 + k % 2)
    out = np.empty(R * C, M.dtype)
    out[pos.reshape(-1)] = M.reshape(-1)
    return out


def _pack_wg(M, pw: int, bf16: bool, fill):
    """The entries of an (R, C) matrix (R a multiple of the k-step, 8 rows
    TF32 or 16 bf16; C a multiple of ``pw``) in the order the Hopper
    kernels stream them: pass by pass (``pw`` columns, padded with ``fill``
    to a multiple of 64), k-step by k-step, so that each k-step of a pass
    is one contiguous stage, in wgmma's K-major layout without swizzle:
    per 8-column group, two core matrices of 8 columns x 16 bytes of K (4
    TF32 or 8 bf16 values), column after column."""
    R, C = M.shape
    ks = 16 if bf16 else 8
    e = ks // 2
    pw64 = -(-pw // 64) * 64
    k = np.arange(R)[:, None]
    n = np.arange(C)[None, :]
    p, nn = n // pw, n % pw
    pos = ((p * (R // ks) + k // ks) * pw64 * ks + (nn // 8) * (8 * ks)
           + ((k % ks) // e) * (8 * e) + (nn % 8) * e + k % e)
    out = np.full((C // pw) * (R // ks) * pw64 * ks, fill, M.dtype)
    out[pos.reshape(-1)] = M.reshape(-1)
    return out


def _pack(M):
    """The entries of an (R, C) matrix (R, C multiples of 8) in the order
    the B operand of ``mma.sync.m16n8k8.tf32`` is read: per 8-row k-step,
    per 8-column n-tile, 64 floats, where lane (n % 8) * 4 + k % 4 holds
    rows k and k + 4 of column n as one float2. A warp reads a fragment as
    256 contiguous bytes; a pass of n-tiles at one k-step is contiguous."""
    R, C = M.shape
    k = np.arange(R)[:, None]
    n = np.arange(C)[None, :]
    pos = (((k // 8) * (C // 8) + n // 8) * 64
           + ((n % 8) * 4 + k % 4) * 2 + (k % 8) // 4)
    out = np.empty(R * C, M.dtype)
    out[pos.reshape(-1)] = M.reshape(-1)
    return out


class _Geometry(NamedTuple):
    """The padded shapes of a plan and the kernels' buffers they imply."""
    kn: tuple          # (Kp, Np) per layer
    slabs: tuple       # per item (G, slab width, n slabs); zeros for elem
    last_of: tuple     # per layer: (G, P, slab width) of a last layer, or None
    widest: int        # widest padded layer input or hidden layer output
    ldh: int           # wide path: row stride of the activation buffer
    lda: int           # Hopper path: values of K a row of H holds
    ldo: int           # Hopper path: row stride of a slab (the widest slab)
    slot: int          # Hopper path: bytes of a ring slot (the widest pass)
    sk: int            # the widest depth at which B5's dh reads a slab


@functools.lru_cache(maxsize=64)
def _geometry(st: _Structure) -> _Geometry:
    da = st.dim // 2
    kn = list(st.layers)
    slabs, last_of = [], [None] * len(kn)
    for it in st.items:
        if it.kind == "elem":
            slabs.append((0, 0, 0))
            continue
        # A bf16 layer's K (and so the hidden widths) padded to the k-step
        # of its bf16 products, 16. The slab stays a multiple of 8; B5's dh
        # reads each slab as a depth padded to 16 (``_slab_depth``).
        ceil = _ceil16 if it.bf16 else _ceil8
        P, G = _n_params(it), it.lanes
        sw, ns = _ceil8(G * P), -(-da // G)
        slabs.append((G, sw, ns))
        for li in range(it.n_layers):
            K, N = st.layers[it.layer0 + li]
            kn[it.layer0 + li] = (ceil(K), ceil(N))
        last = it.layer0 + it.n_layers - 1
        kn[last] = (kn[last][0], ns * sw)
        last_of[last] = (G, P, sw)
    widest = max([Kp for Kp, _ in kn]
                 + [Np for l, (_, Np) in enumerate(kn) if last_of[l] is None])
    depths = [_slab_depth(it, sl[1]) for it, sl in zip(st.items, slabs)
              if it.kind != "elem"]
    ldo = max(sl[1] for sl in slabs)
    # The wide path's activation buffer also holds B5's slabs (a bf16 slab
    # at its depth padded to 16); a row stride of 4 mod 8 floats makes the
    # A-fragment reads of mma.sync conflict-free.
    return _Geometry(tuple(kn), tuple(slabs), tuple(last_of), widest,
                     max([widest] + depths) + 4,
                     _ceil16(max([widest] + depths)), ldo,
                     2048 * -(-max(widest, ldo) // 64), max(depths))


class _Padded(NamedTuple):
    """The kernels' view of a plan (see the module docstring)."""
    kn: tuple          # (Kp, Np) per layer
    slabs: tuple       # per item (G, slab width, n slabs); zeros for elem
    nat_offs: tuple    # per layer: W (Kp x Np) then b (Np), natural layout
    nat_len: int
    nat_idx: np.ndarray    # natural position -> wbuf index; w_len = zero
    k_offs: tuple      # per layer: packed W, packed W^T, bias offsets (words)
    k_idx: np.ndarray      # kernel-buffer value -> wbuf index
    n_packed: int      # TF32 values first in the kernel buffer: W and W^T
    n_bf16: int        # then the bf16 layers' packed W and W^T values
    grad_idx: np.ndarray   # wbuf index -> natural position
    scr_cols: tuple    # per layer: scratch column base of h_in, g_pre
    cols: int          # scratch floats per row
    widest: int        # widest padded layer input or hidden layer output
    ldh: int           # wide path: row stride of the activation buffer
    tm: int            # rows per tile: 64 (Hopper path) or 16 (wide path)
    lda: int           # Hopper path: values of K a row of H holds
    ldo: int           # Hopper path: row stride of a slab
    slot: int          # Hopper path: bytes of a ring slot


@functools.lru_cache(maxsize=64)
def _padded(st: _Structure) -> _Padded:
    da = st.dim // 2
    geo = _geometry(st)
    kn, last_of = geo.kn, geo.last_of
    tm = _pick_tile(st)
    zero = st.w_len
    nat_idx, nat_offs, off = [], [], 0
    grad_idx = np.empty(st.w_len, np.int64)
    for l, ((K, N), (Kp, Np)) in enumerate(zip(st.layers, kn)):
        col = np.full(Np, -1, np.int64)   # padded column -> plan column
        if last_of[l] is not None:
            G, P, sw = last_of[l]
            for j in range(da):
                s, jj = divmod(j, G)
                for p in range(P):
                    col[s * sw + p * G + jj] = _grouped_col(j, p, da, P, G)
        else:
            col[:N] = np.arange(N)
        ok = col >= 0
        W = np.full((Kp, Np), zero, np.int64)
        W[:K, ok] = st.w_offs[l] + np.arange(K)[:, None] * N + col[ok]
        b = np.full(Np, zero, np.int64)
        b[ok] = st.w_offs[l] + K * N + col[ok]
        pos = off + np.arange(Kp * Np).reshape(Kp, Np)
        grad_idx[W[:K, ok].reshape(-1)] = pos[:K, ok].reshape(-1)
        grad_idx[b[ok]] = off + Kp * Np + np.nonzero(ok)[0]
        nat_offs.append(off)
        nat_idx += [W.reshape(-1), b]
        off += (Kp + 1) * Np
    nat_idx = np.concatenate(nat_idx)
    # The kernel buffer, in 32-bit words: the TF32 layers' packed W, then
    # their W^T (a float a value); the bf16 layers' packed W, then their W^T
    # (two values a word); the biases (f32). The Hopper path streams each
    # W pass by pass (the last layer's slab by slab) and each W^T over its
    # whole width (``_pack_wg``); the wide path reads mma.sync fragments
    # (``_pack``, ``_pack_bf16``).
    flags = st.layer_bf16
    packs, packs_t = {}, {}
    for l, (Kp, Np) in enumerate(kn):
        M = nat_idx[nat_offs[l]:nat_offs[l] + Kp * Np].reshape(Kp, Np)
        MT = M.T
        if flags[l] and last_of[l] is not None:
            # B5's dh reads each slab as a depth padded to 16: W^T's rows
            # slab by slab, zero rows between.
            sw = last_of[l][2]
            sk = _ceil16(sw)
            MT = np.full((Np // sw * sk, Kp), zero, np.int64)
            for s in range(Np // sw):
                MT[s * sk:s * sk + sw] = M.T[s * sw:(s + 1) * sw]
        if tm == 64:
            pw = Np if last_of[l] is None else last_of[l][2]
            packs[l] = _pack_wg(M, pw, flags[l], zero)
            packs_t[l] = _pack_wg(MT, Kp, flags[l], zero)
        else:
            pack = _pack_bf16 if flags[l] else _pack
            packs[l], packs_t[l] = pack(M), pack(MT)
    order = [l for l in range(len(kn)) if not flags[l]]
    order16 = [l for l in range(len(kn)) if flags[l]]
    n_32 = sum(packs[l].size + packs_t[l].size for l in order)
    n_16 = sum(packs[l].size + packs_t[l].size for l in order16)
    k_offs, o_w, o_b = [None] * len(kn), 0, n_32 + n_16 // 2
    for group, per_word in ((order, 1), (order16, 2)):
        o_t = o_w + sum(packs[l].size for l in group) // per_word
        for l in group:
            k_offs[l] = (o_w, o_t)
            o_w += packs[l].size // per_word
            o_t += packs_t[l].size // per_word
        o_w = o_t
    biases = []
    for l, (Kp, Np) in enumerate(kn):
        biases.append(nat_idx[nat_offs[l] + Kp * Np:nat_offs[l]
                              + (Kp + 1) * Np])
        k_offs[l] = (*k_offs[l], o_b)
        o_b += Np
    packs = ([packs[l] for l in order] + [packs_t[l] for l in order]
             + [packs[l] for l in order16] + [packs_t[l] for l in order16])
    scr, c = [], 0
    for Kp, Np in kn:
        scr.append(c)
        c += Kp + Np
    return _Padded(kn, geo.slabs, tuple(nat_offs), off, nat_idx,
                   tuple(k_offs), np.concatenate(packs + biases), n_32,
                   n_16, grad_idx, tuple(scr), c, geo.widest, geo.ldh, tm,
                   geo.lda, geo.ldo, geo.slot)


def _slab_depth(it, sw: int) -> int:
    """The depth at which B5's dh reads a slab of width ``sw``: ``sw``, or
    for a bf16 coupling ``sw`` padded to a multiple of 16."""
    return _ceil16(sw) if it.bf16 else sw


def _layer(st: _Structure, wbuf, li, pp: _Padded = None):
    """(W, b) of layer li: from the plan, or with ``pp`` from the natural
    padded buffer (``_padded_buffer``)."""
    K, N = pp.kn[li] if pp else st.layers[li]
    off = pp.nat_offs[li] if pp else st.w_offs[li]
    return (wbuf[off:off + K * N].view(K, N),
            wbuf[off + K * N:off + (K + 1) * N])


@functools.lru_cache(maxsize=64)
def _index(st: _Structure, name: str, device) -> torch.Tensor:
    """One of ``_padded(st)``'s index arrays as a tensor on ``device``, made
    once: copying the kernel buffer's index from the host took longer than
    B4 itself."""
    return torch.as_tensor(getattr(_padded(st), name), device=device)


def _gather(st: _Structure, wbuf, name: str):
    """wbuf at the index ``name`` of the padded plan, where index len(wbuf)
    reads a zero."""
    ext = torch.cat([wbuf, wbuf.new_zeros(1)])
    return ext[_index(st, name, wbuf.device)]


def _padded_buffer(st: _Structure, wbuf):
    """The natural padded buffer: per layer W (Kp x Np) then b (Np)."""
    return _gather(st, wbuf, "nat_idx")


@functools.lru_cache(maxsize=256)
def _slab_cols(st: _Structure, item: int, padded: bool, device):
    """Index that gathers the slab layout (parameter p of half-lane j at
    p * d/2 + j, what the plain epilogues read) from the columns of a
    coupling's last layer, lane-grouped or padded, as a tensor on
    ``device``; None where the two layouts agree (the affine stacks with
    d/2 <= 92, unpadded)."""
    it = st.items[item]
    da, P, G = st.dim // 2, _n_params(it), it.lanes
    sw = _geometry(st).slabs[item][1]
    col = (lambda j, p: (j // G) * sw + p * G + j % G) if padded else \
        (lambda j, p: _grouped_col(j, p, da, P, G))
    cols = [col(j, p) for p in range(P) for j in range(da)]
    last = it.layer0 + it.n_layers - 1
    width = (_geometry(st).kn if padded else st.layers)[last][1]
    if cols == list(range(width)):
        return None
    return torch.tensor(cols, dtype=torch.long, device=device)


def _ring_slots(st: _Structure, backward: bool,
                recompute: bool = True) -> int:
    """Weight-ring slots of the Hopper path's B4 / B5: as many one-pass
    k-step slots as the shared memory left by everything else holds, at
    most ``_WG_MAX_RING``; fewer than 2 means the stack does not fit."""
    geo = _geometry(st)
    rest = _smem_bytes(st, 64, backward, recompute, ring=0)
    return min(_WG_MAX_RING, (_SMEM_MAX - rest) // geo.slot)


def _hr_bytes(st: _Structure) -> int:
    """Bytes of the Hopper path's activation buffer (``plan_hr`` in
    csrc/coupling.cu): H, 64 x lda values of 4 bytes; with a bf16
    coupling, the larger of that and H in bf16 followed by the f32 area
    its epilogues stage one warpgroup's columns in (64 rows of 64 x
    ceil(n-blocks / 2) + 4)."""
    lda = _geometry(st).lda
    f32 = 4 * 64 * lda
    if not st.any_bf16:
        return f32
    return max(f32, 2 * 64 * lda
               + 4 * 64 * (64 * ((-(-lda // 64) + 1) // 2) + 4))


def _smem_bytes(st: _Structure, tm: int, backward: bool,
                recompute: bool = True, ring: int = None) -> int:
    """Shared memory of B4 / B5 for a row tile of ``tm`` rows, following
    csrc/coupling.cu.

    Hopper path (64 rows): the ring's barriers and ``ring`` slots (by
    default ``_ring_slots``) of one k-step of the widest pass; H
    (``_hr_bytes``); B4 the state (64 x d), the widest slab (64 x ldo) and
    the ladj sums (64); B5 H, or a slab (64 x ldo) and its rounded
    cotangent (64 x the widest slab depth), the state and then the running
    cotangent (64 x d), the ladj cotangents (64), the elementwise-parameter
    sums (n_pslots x d) and, when it ``recompute``s the forward, a slab
    (64 x ldo).

    Wide path (16 rows): the weight ring (3 stages of 8 rows x the pass
    width; in B4 it also holds each last-layer slab between passes), the
    activation buffer (tm x ldh); B4 the state and the per-element ladj
    terms (tm x d each); B5 what its reverse sweep needs of each stage's
    input (an elementwise stage's whole input, tm x d; a coupling's target
    half, tm x d/2), the state and then the running cotangent (tm x d), the
    ladj cotangents (tm) and the elementwise-parameter sums (n_pslots x
    d)."""
    d, geo = st.dim, _geometry(st)
    if tm == 64:
        if ring is None:
            ring = _ring_slots(st, backward, recompute)
        head = _WG_BARS + ring * geo.slot
        if backward:
            return (head + max(_hr_bytes(st), 4 * 64 * (geo.ldo + geo.sk))
                    + 4 * (64 * (d + 1 + (geo.ldo if recompute else 0))
                           + st.n_pslots * d))
        return head + _hr_bytes(st) + 4 * 64 * (d + geo.ldo + 1)
    ring = _RING * 8 * _WIDE_PASS
    if backward:
        saved = sum(d if it.kind == "elem" else d // 2 for it in st.items)
        floats = ring + tm * (saved + d + 1 + geo.ldh) + st.n_pslots * d
    else:
        floats = ring + tm * (2 * d + geo.ldh)
    return 4 * floats


def _pick_tile(st: _Structure) -> int:
    """Rows per block of B4 and B5, the same for both, since B4 writes the
    rows B5 reads in its path's layout: 64, the Hopper path, where every
    padded layer input and hidden output, and every slab, is at most 512
    wide and B4 and B5 (recomputing) leave room for 2 ring slots; else 16,
    the wide path, where every width is at most 1024 and every slab fits
    its ring and B4 and B5 fit 227 KB; 0 when neither does."""
    geo = _geometry(st)
    if max(geo.widest, geo.ldo) <= _WG_PASS and \
            _ring_slots(st, False) >= 2 and _ring_slots(st, True) >= 2:
        return 64
    if geo.widest <= _WIDE_PASS \
            and 16 * (geo.ldo + 4) <= _RING * 8 * _WIDE_PASS \
            and _smem_bytes(st, 16, False) <= _SMEM_MAX \
            and _smem_bytes(st, 16, True) <= _SMEM_MAX:
        return 16
    return 0


def is_fusible_coupling_stack(chain, dim: int, dtype=torch.float32) -> bool:
    """Whether B4/B5 take this stack (``coupling.py:306-319``).

    The storage dtype is float32 or bfloat16 and ``dim`` is even; the chain
    has at least one coupling; every coupling splits at dim/2 and has an
    ``MLPConditioner`` with one of the four activations and
    ``compute_dtype`` None (TF32 products) or "bfloat16" (bf16 products,
    per coupling, so a stack may mix the two); every coupling finds its halves
    on the two physical halves after the Permutes before it; the other
    stages are of the five elementwise kinds. In place of the TPU's tile
    pickers and VMEM budgets, the port's own limits: at most 24 stages
    (Permutes not counted) and 48 conditioner layers, and one of the two
    row tiles of B4 and B5 must take the stack (``_pick_tile``). The
    64-row tile (the Hopper path) holds a pass of 512 columns in two
    warpgroups' registers, so it takes d/2 and hidden widths up to 512
    (padded to multiples of 8) while its shared memory leaves room for two
    ring slots: B4 takes about 512 B + 2 slots of 32 B x the widest pass +
    256 B x (widest layer + d + widest slab + 1). The 16-row tile (the wide
    path) takes widths up to 1024, and the wider states it fits. The
    spline's last layer is computed in slabs of G = 184 // (3K - 1)
    half-lanes, so K <= 61. The BASELINE (512, 512) affine and spline
    stacks and the VI templates at those widths run in 64-row tiles, the
    (1024, 1024) stack in 16-row tiles; (4096,) is refused. A bf16 layer's
    widths are padded to multiples of 16; a 16-deep bf16 k-step is the
    bytes of an 8-deep TF32 one, so the ring and the shared memory are the
    same."""
    if dtype not in STORAGE_DTYPES:
        return False
    st = _stack_structure(chain, dim)
    if st is None or len(st.items) > MAX_STAGES \
            or len(st.layers) > MAX_LAYERS or st.w_len >= 2 ** 31:
        return False
    return _pick_tile(st) > 0


# The trainers' dispatch sends a coupling stack's batch to B4/B5 only at the
# sizes where the kernels were held on trained stacks (ROADMAP C-3): at
# least this many rows and this width. chip_smoke.py [infer B4/B5 hold]
# reads trained (32, 32) templates, affine and spline, forward and
# inverted, at 2^10-2^17 rows against the [B4]/[B5] TF32 gate: at d=50
# they hold at 2^17 rows (54-67% of the limit), as the d=64 BASELINE and VI
# stacks do ([coupling slice], [vi B5 hold]); at d=2 they do not (up to
# 4.8x), and below 2^17 rows readings fall outside it at both widths (up
# to 71x). Against a plain run on the kernels' own TF32-rounded operands
# the same (32, 32) templates hold in 47 of 48 holds: at these widths the
# gate's cuBLAS TF32 yardstick is more exact than TF32 operand rounding.
COUPLING_MIN_ROWS = 1 << 17
COUPLING_MIN_DIM = 50


def coupling_batch_held(rows: int, dim: int) -> bool:
    """Whether the trainers' dispatch sends a batch of ``rows`` rows of a
    fusible coupling stack of width ``dim`` to B4/B5 (see
    ``COUPLING_MIN_ROWS``)."""
    return rows >= COUPLING_MIN_ROWS and dim >= COUPLING_MIN_DIM


# ------------------------------------------------------------------
# Plain B4 (``_tile_apply`` :451-514 and ``_spline_slab_epilogue``
# :322-415 over the whole batch): the kernel's arithmetic in torch.

def _affine_epilogue(x, h, da, mls, inverted):
    """(new target half, per-element ladj terms) of the affine update with
    the soft clamp s = mls * tanh(h_s / mls)."""
    sc = mls * torch.tanh(h[:, :da] / mls)
    t = h[:, da:]
    if inverted:
        return (x - t) * torch.exp(-sc), -sc
    return x * torch.exp(sc) + t, sc


def _spline_bins(x, h, da, K, bound, inverted):
    """The kernel's bin search: floored softmax sizes from the slab-layout
    conditioner output, running bin edges, out-of-range lanes parked in bin
    0 after the ``in_range`` mask (``coupling.py:341-390``). Returns
    (in_range, masks per bin, wk, hk, x0, y0, d0, d1, softmax parts)."""
    slab = lambda k: h[:, k * da:(k + 1) * da]
    mw, mh = slab(0), slab(K)
    for k in range(1, K):
        mw = torch.maximum(mw, slab(k))
        mh = torch.maximum(mh, slab(K + k))
    ew = [torch.exp(slab(k) - mw) for k in range(K)]
    eh = [torch.exp(slab(K + k) - mh) for k in range(K)]
    zw, zh = sum(ew), sum(eh)
    cw = (1.0 - _MIN_BIN * K) * 2.0 * bound
    c0 = 2.0 * bound * _MIN_BIN
    sw = [c0 + e * (cw / zw) for e in ew]
    sh = [c0 + e * (cw / zh) for e in eh]
    deriv = lambda kn: 1.0 if kn in (0, K) else \
        _MIN_DERIV + softplus(slab(2 * K + kn - 1) + _DERIV_SHIFT)
    in_range = (x > -bound) & (x < bound)
    cx = torch.full_like(x, -bound)
    cy = torch.full_like(x, -bound)
    wk = hk = x0 = y0 = d0 = d1 = 0.0
    masks = []
    for k in range(K):
        nx, ny = cx + sw[k], cy + sh[k]
        lo, hi = (cy, ny) if inverted else (cx, nx)
        m = (x >= lo) & (x < hi) if k + 1 < K else (x >= lo)
        m = m & in_range
        if k == 0:
            m = m | ~in_range
        masks.append(m)
        oh = m.to(x.dtype)
        wk = wk + oh * sw[k]
        hk = hk + oh * sh[k]
        x0 = x0 + oh * cx
        y0 = y0 + oh * cy
        d0 = d0 + oh * deriv(k)
        d1 = d1 + oh * deriv(k + 1)
        cx, cy = nx, ny
    return (in_range, masks, wk, hk, x0, y0, d0, d1,
            (ew, eh, zw, zh, cw))


def _spline_solve(x, in_range, wk, hk, x0, y0, d0, d1, inverted):
    """(xi, y before the tails, raw xi of the forward) of the selected bin:
    the rational-quadratic form, or its stable two-root inverse with the
    1e-6 root window and the clamp to [0, 1] (``coupling.py:391-408``)."""
    s = hk / wk
    t = d1 + d0 - 2.0 * s
    if inverted:
        dy = torch.where(in_range, x - y0, 0.5 * hk)
        a = hk * (s - d0) + dy * t
        b = hk * d0 - dy * t
        c = -s * dy
        root = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        q = -0.5 * (b + torch.where(b >= 0.0, 1.0, -1.0) * root)
        r1 = torch.where(q != 0.0, c / torch.where(q != 0.0, q, 1.0), 0.0)
        r2 = torch.where(a != 0.0, q / torch.where(a != 0.0, a, 1.0), r1)
        use_r1 = (r1 >= -1e-6) & (r1 <= 1.0 + 1e-6)
        xi_raw = torch.where(use_r1, r1, r2)
        xi = torch.clamp(xi_raw, 0.0, 1.0)
        return xi, x0 + xi * wk, xi_raw
    xi_raw = torch.where(in_range, (x - x0) / wk, 0.5)
    xi = torch.clamp(xi_raw, 0.0, 1.0)
    y = y0 + hk * (s * xi * xi + d0 * xi * (1.0 - xi)) \
        / (s + t * xi * (1.0 - xi))
    return xi, y, xi_raw


def _spline_epilogue(x, h, da, K, bound, inverted):
    """(new target half, per-element ladj terms) of the RQ-spline update on
    ``x: (n, da)`` from the slab-layout conditioner output
    ``h: (n, da * (3K - 1))`` (``coupling.py:322-415``)."""
    in_range, _, wk, hk, x0, y0, d0, d1, _ = _spline_bins(
        x, h, da, K, bound, inverted)
    xi, y, _ = _spline_solve(x, in_range, wk, hk, x0, y0, d0, d1, inverted)
    s = hk / wk
    t = d1 + d0 - 2.0 * s
    omxi = 1.0 - xi
    denom = s + t * xi * omxi
    num = s * s * (d1 * xi * xi + 2.0 * s * xi * omxi + d0 * omxi * omxi)
    ladj_fwd = torch.log(num) - 2.0 * torch.log(denom)
    ladj = torch.where(in_range, -ladj_fwd if inverted else ladj_fwd, 0.0)
    return torch.where(in_range, y, x), ladj


class _MatmulBF16(torch.autograd.Function):
    """``h @ W`` on bf16 operands with float32 accumulation, whose backward
    runs bf16-operand products too: JAX's ``_mm_bf16``
    (``enflows_tpu/ops/pallas/coupling.py:419-446``). Forward
    dot(h.bf16, W.bf16) in f32; backward g16 = g.bf16, dh = g16 W16^T and
    dW = h16^T g16 in f32, cast to h's and W's dtypes. The operands are
    rounded to nearest even, as the kernels' ``cvt.rn.bf16x2.f32`` rounds
    them; a product of two bf16 values is exact in f32, so the f32 matmul
    of the rounded operands is the bf16 product up to the order of the
    sums. Float64 operands keep float64 sums."""

    @staticmethod
    def forward(ctx, h, W):
        h16, W16 = (_bf16_operand(t) for t in (h, W))
        ctx.save_for_backward(h16, W16)
        ctx.dtypes = (h.dtype, W.dtype)
        return torch.matmul(h16, W16)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h16, W16 = ctx.saved_tensors
        g16 = _bf16_operand(g)
        return (torch.matmul(g16, W16.T).to(ctx.dtypes[0]),
                torch.matmul(h16.T, g16).to(ctx.dtypes[1]))


def _bf16_operand(t):
    """``t`` rounded to bf16 (nearest even), held in its own dtype: float32,
    or float64 where a yardstick computes the bf16-operand products
    exactly."""
    return t.to(torch.bfloat16).to(torch.promote_types(t.dtype,
                                                       torch.float32))


def coupling_forward_plain(st: _Structure, wbuf, pbuf, x,
                           padded: bool = False):
    """Plain B4: (y in physical lane order, per-sample ladj) through the
    plan, one stage at a time over the whole batch, in x's dtype, with the
    conditioner matmuls in ``torch.matmul``. Differentiable: autograd over
    it is the plain B5. ``padded=True`` runs the same function on the
    kernels' padded plan: zero-padded activations, padded W and b, the
    last layer's padded slabs.

    A coupling with ``compute_dtype="bfloat16"`` takes its products through
    ``_MatmulBF16`` (bf16 operands, float32 products; bias, activation and
    epilogue in float32), as the kernels do. A bf16 x (storage) is widened
    to float32, and y and ladj are rounded to bf16 once at the end, as B4
    stores them."""
    d = st.dim
    da = d // 2
    storage = x.dtype
    if storage == torch.bfloat16:
        x = x.to(torch.float32)
    pp = _padded(st) if padded else None
    if padded:
        wbuf = _padded_buffer(st, wbuf)
    halves = [x[:, :da], x[:, da:]]
    ladj = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, it in enumerate(st.items):
        if it.kind == "elem":
            kind = _BY_CODE[it.code]
            ps = [pbuf[(it.slot + i) * d:(it.slot + i + 1) * d]
                  for i in range(_N_PARAMS[it.code])]
            for half in (0, 1):
                sl = slice(half * da, (half + 1) * da)
                halves[half], el = _APPLY[kind](halves[half],
                                                *[p[sl] for p in ps])
                ladj = ladj + el.expand(halves[half].shape).sum(1)
            continue
        act = ACTIVATIONS[it.act]
        mm = _MatmulBF16.apply if it.bf16 else torch.matmul
        h = halves[it.src]
        if padded:
            h = torch.nn.functional.pad(h, (0, pp.kn[it.layer0][0] - da))
        for li in range(it.n_layers):
            W, b = _layer(st, wbuf, it.layer0 + li, pp)
            if li + 1 < it.n_layers:
                h = act(mm(h, W) + b)
                continue
            # The last layer's columns in slab layout: a gather of W and b,
            # whose cost does not grow with the batch.
            cols = _slab_cols(st, i, padded, h.device)
            if cols is not None:
                W, b = W[:, cols], b[cols]
            h = mm(h, W) + b
        tgt = 1 - it.src
        if it.kind == "affine":
            new, el = _affine_epilogue(halves[tgt], h, da, it.mls,
                                       it.inverted)
        else:
            new, el = _spline_epilogue(halves[tgt], h, da, it.n_bins,
                                       it.bound, it.inverted)
        halves[tgt] = new
        ladj = ladj + el.sum(1)
    return torch.cat(halves, dim=1).to(storage), ladj.to(storage)


_BY_CODE = {code: kind for kind, code in _CODE.items()}
_N_PARAMS = {0: 2, 1: 3, 2: 3, 3: 4, 4: 4}     # n_params() of stages.cuh


# ------------------------------------------------------------------
# Hand-derived adjoints. Each returns the input cotangent and the cotangent
# of the conditioner output, elementwise; ``ce`` is the cotangent of the
# per-element ladj terms (the per-sample ladj cotangent, broadcast). The
# CUDA functions of the same names in csrc/coupling.cu follow these lines;
# the CPU tests hold them against autograd of the bodies above.

_GELU_C = math.sqrt(2.0 / math.pi)


def _sigmoid(u):
    """sigma(u) from e^-|u|, the form the kernels use."""
    e = torch.exp(-torch.abs(u))
    return torch.where(u >= 0.0, 1.0, e) / (1.0 + e)


def _adjoint_activation(name, pre, g):
    """Cotangent of the pre-activation ``pre`` from that of act(pre)."""
    if name == "tanh":
        th = torch.tanh(pre)
        return g * (1.0 - th * th)
    if name == "relu":
        return torch.where(pre > 0.0, g, 0.0)
    if name == "silu":
        sg = _sigmoid(pre)
        return g * sg * (1.0 + pre * (1.0 - sg))
    # gelu, tanh form: 0.5 p (1 + tanh(c (p + 0.044715 p^3)))
    T = torch.tanh(_GELU_C * (pre + 0.044715 * pre * pre * pre))
    return g * (0.5 * (1.0 + T) + 0.5 * pre * (1.0 - T * T) * _GELU_C
                * (1.0 + 3.0 * 0.044715 * pre * pre))


def _adjoint_affine(x, h, da, mls, inverted, cy, ce):
    """(cx, g_h) of ``_affine_epilogue``, through the soft clamp and the
    ladj term."""
    th = torch.tanh(h[:, :da] / mls)
    sc = mls * th
    if inverted:
        e = torch.exp(-sc)
        y = (x - h[:, da:]) * e
        cx = cy * e
        g_t = -cy * e
        g_sc = -cy * y - ce
    else:
        e = torch.exp(sc)
        cx = cy * e
        g_t = cy
        g_sc = cy * x * e + ce
    return cx, torch.cat([g_sc * (1.0 - th * th), g_t], dim=1)


def _adjoint_spline(x, h, da, K, bound, inverted, cy, ce):
    """(cx, g_h) of ``_spline_epilogue``: through the selected bin's
    rational-quadratic form (forward), or by implicit differentiation of
    it at the solved root (inverted), its ladj term, the running bin edges,
    the floored softmax of widths and heights and the shifted softplus of
    the slopes. The bin index is constant almost everywhere, so no gradient
    flows through it; where the forward's xi is clamped to [0, 1] none
    flows through xi either."""
    (in_range, masks, wk, hk, x0, y0, d0, d1,
     (ew, eh, zw, zh, cw)) = _spline_bins(x, h, da, K, bound, inverted)
    xi, _, xi_raw = _spline_solve(x, in_range, wk, hk, x0, y0, d0, d1,
                                  inverted)
    s = hk / wk
    t = d1 + d0 - 2.0 * s
    u = xi * (1.0 - xi)
    omxi = 1.0 - xi
    N = s * xi * xi + d0 * u
    D = s + t * u
    M = d1 * xi * xi + 2.0 * s * u + d0 * omxi * omxi
    D2 = D * D
    y_xi = hk * ((2.0 * s * xi + d0 * (1.0 - 2.0 * xi)) * D
                 - N * t * (1.0 - 2.0 * xi)) / D2
    y_s = hk * (xi * xi * D - N * (1.0 - 2.0 * u)) / D2
    y_d0 = hk * (u * D - N * u) / D2
    y_d1 = -hk * N * u / D2
    L_xi = (2.0 * d1 * xi + 2.0 * s * (1.0 - 2.0 * xi) - 2.0 * d0 * omxi) / M \
        - 2.0 * t * (1.0 - 2.0 * xi) / D
    L_s = 2.0 / s + 2.0 * u / M - 2.0 * (1.0 - 2.0 * u) / D
    L_d0 = omxi * omxi / M - 2.0 * u / D
    L_d1 = xi * xi / M - 2.0 * u / D
    if inverted:
        g_xi = cy * wk - ce * L_xi
        lam = -g_xi / y_xi
        cx = g_xi / y_xi
        g_y0 = lam
        g_hk = lam * N / D
        g_s = lam * y_s - ce * L_s
        g_d0 = lam * y_d0 - ce * L_d0
        g_d1 = lam * y_d1 - ce * L_d1
        g_x0 = cy
        g_wk = cy * xi
    else:
        g_xi = cy * y_xi + ce * L_xi
        g_xi = torch.where((xi_raw >= 0.0) & (xi_raw <= 1.0), g_xi, 0.0)
        cx = g_xi / wk
        g_x0 = -g_xi / wk
        g_wk = -g_xi * xi / wk
        g_y0 = cy
        g_hk = cy * N / D
        g_s = cy * y_s + ce * L_s
        g_d0 = cy * y_d0 + ce * L_d0
        g_d1 = cy * y_d1 + ce * L_d1
    g_hk = g_hk + g_s / wk
    g_wk = g_wk - g_s * s / wk
    zero = torch.zeros_like(x)
    cx = torch.where(in_range, cx, cy)
    g_wk, g_hk, g_x0, g_y0, g_d0, g_d1 = (
        torch.where(in_range, g, zero)
        for g in (g_wk, g_hk, g_x0, g_y0, g_d0, g_d1))
    # Bin sizes: the selected bin's size, and every size before it through
    # the running edge x0 / y0.
    after = torch.zeros_like(in_range)
    g_sw, g_sh = [None] * K, [None] * K
    for k in range(K - 1, -1, -1):
        g_sw[k] = torch.where(masks[k], g_wk, torch.where(after, g_x0, zero))
        g_sh[k] = torch.where(masks[k], g_hk, torch.where(after, g_y0, zero))
        after = after | masks[k]
    # Floored softmax: size_k = c0 + cw * p_k.
    cols = []
    for e_, z, g_sz in ((ew, zw, g_sw), (eh, zh, g_sh)):
        S = sum((e_[k] / z) * g_sz[k] for k in range(K))
        cols += [cw * (e_[k] / z) * (g_sz[k] - S) for k in range(K)]
    # Interior slopes: deriv(kn) = MIN_DERIV + softplus(raw[kn-1] + shift).
    for i in range(K - 1):
        sig = _sigmoid(h[:, (2 * K + i) * da:(2 * K + i + 1) * da]
                       + _DERIV_SHIFT)
        g = torch.where(masks[i + 1], g_d0, zero) \
            + torch.where(masks[i], g_d1, zero)
        cols.append(g * sig)
    return cx, torch.cat(cols, dim=1)


# ------------------------------------------------------------------
# CUDA wrappers.

@functools.lru_cache(maxsize=64)
def _plan_arrays(st: _Structure):
    """The C arrays of the plan: 12 ints and 2 floats per stage (the last
    three ints: G, slab width, slabs), 8 ints per padded layer (Kp, Np, the
    packed W, packed W^T and bias offsets in the kernel buffer's words, the
    scratch column base, the offset in the natural padded buffer, 1 where
    the layer's products take bf16 operands)."""
    pp = _padded(st)
    si, sf = [], []
    for it, slab in zip(st.items, pp.slabs):
        si += [_KIND_CODE[it.kind], it.src, int(it.inverted),
               _ACT_CODE.get(it.act, 0), it.n_layers, it.layer0, it.code,
               it.slot, it.n_bins, *slab]
        sf += [it.mls, it.bound]
    li = []
    for l, ((Kp, Np), bf) in enumerate(zip(pp.kn, st.layer_bf16)):
        li += [Kp, Np, *pp.k_offs[l], pp.scr_cols[l], pp.nat_offs[l],
               int(bf)]
    return _ints(si), (ctypes.c_float * max(1, len(sf)))(*sf), _ints(li)


def _round_tf32(t):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _kernel_weights(st: _Structure, wbuf):
    """The kernel buffer, in 32-bit words: the TF32 layers' W and W^T,
    padded, packed in fragment order and rounded to TF32; the bf16 layers'
    W and W^T, packed for m16n8k16 and rounded to bf16 (nearest even), two
    to a word; then the padded biases (f32)."""
    pp = _padded(st)
    vals = _gather(st, wbuf.detach(), "k_idx")
    a, b = pp.n_packed, pp.n_packed + pp.n_bf16
    if a == b:
        vals[:a] = _round_tf32(vals[:a])
        return vals
    return torch.cat([_round_tf32(vals[:a]),
                      vals[a:b].to(torch.bfloat16).view(torch.float32),
                      vals[b:]])


def _grid(tiles: int, smem: int, device) -> int:
    """Persistent grid: the tiles, or as many blocks as fit on the card."""
    per_sm = max(1, _SMEM_PER_SM // (smem + 1024))
    return min(tiles, per_sm * _sm_count(device.index))


def _sv_row(st: _Structure) -> int:
    """Floats per row of the stage inputs B5's sweep keeps: an elementwise
    stage's whole input, a coupling's target half."""
    return sum(st.dim if it.kind == "elem" else st.dim // 2
               for it in st.items)


def _is_bf16(st: _Structure, x) -> bool:
    """Whether a launch takes the kernels' bf16 paths: bf16 storage or a
    bf16 conditioner."""
    return x.dtype == torch.bfloat16 or st.any_bf16


def _rows(st: _Structure, n: int) -> int:
    """Rows of B5's scratch and stage inputs for a batch of n: n padded to
    whole 64-row tiles on the Hopper path, whose kernels write and reduce
    every row of every tile (the padding rows' cotangents are zero)."""
    return -(-n // 64) * 64 if _padded(st).tm == 64 else n


def _launch_fwd(st: _Structure, x, wbuf, pbuf, save: bool = False):
    """B4: (y, ladj, saved). With ``save``, B4 also writes what B5 needs
    (every layer's input and pre-activation, every stage's input) for the
    whole batch, and ``saved`` holds it with the kernel buffer for
    ``_launch_bwd``; otherwise ``saved`` is None. x, y and ladj are in x's
    storage dtype (float32 or bf16: ladj is summed in f32 and rounded once
    as it is stored); the saved rows are f32."""
    from ._build import load_library

    lib = load_library()
    n, d = x.shape
    if x.dtype not in STORAGE_DTYPES:
        raise ValueError(f"B4 takes float32 or bfloat16, got {x.dtype}")
    pp = _padded(st)
    tm = pp.tm
    smem = _smem_bytes(st, tm, backward=False)
    y = torch.empty_like(x)
    ladj = torch.empty(n, dtype=x.dtype, device=x.device)
    wk = _kernel_weights(st, wbuf)
    rows = _rows(st, n)
    saved = None
    if save:
        saved = (torch.empty(rows * pp.cols, dtype=torch.float32,
                             device=x.device),
                 torch.empty(rows * _sv_row(st), dtype=torch.float32,
                             device=x.device), wk)
    scratch, svs = (None, None) if saved is None else \
        (saved[0].data_ptr(), saved[1].data_ptr())
    si, sf, li = _plan_arrays(st)
    bf = int(x.dtype == torch.bfloat16)
    grid = _grid(-(-n // tm), smem, x.device)
    with torch.cuda.device(x.device), \
            annotate("enflows.cuda.fused_coupling_fwd"):
        stream = torch.cuda.current_stream().cuda_stream
        head = (bf, x.data_ptr(), y.data_ptr(), ladj.data_ptr(),
                wk.data_ptr(), pbuf.data_ptr(), si, sf, len(st.items), li,
                len(st.layers), n)
        if tm == 64:
            err = lib.enf_coupling_fwd(
                *head, rows, d, pp.lda, pp.ldo, _ring_slots(st, False),
                pp.slot, scratch, svs, smem, grid, _DERIV_SHIFT, stream)
        else:
            err = lib.enf_coupling_fwd_wide(
                *head, d, pp.ldh, tm, scratch, svs, smem, grid,
                _DERIV_SHIFT, stream)
    _raise_on(lib, err, "B4 (fused coupling forward)")
    if _is_bf16(st, x):
        LAUNCHES_BF16["coupling_fwd"] += 1
    else:
        LAUNCHES["coupling_fwd"] += 1
    return y, ladj, saved


def _dw_tiles(pp: _Padded) -> int:
    """Output tiles of the weight-gradient reduction, over every layer."""
    if pp.tm == 64:
        return sum(-(-Kp // _DW_M) * -(-Np // _DW_N) for Kp, Np in pp.kn)
    return sum(-(-Kp // _WIDE_DW_TILE) * -(-Np // _WIDE_DW_TILE)
               for Kp, Np in pp.kn)


def _launch_bwd(st: _Structure, x, wbuf, pbuf, gy, gl, saved=None,
                weights: bool = True):
    """B5: (gx, wbuf cotangent, pbuf cotangent) for the cotangents gy (n, d)
    in physical lane order and gl (n,). Given B4's ``saved`` rows, the whole
    batch is one launch of the sweep, which then skips its recompute of the
    forward; otherwise the batch goes in chunks of at most
    ``_BWD_CHUNK_ROWS`` rows, each recomputed. Each chunk is one launch of
    the sweep kernel and one of the weight-gradient reduction over fixed
    row splits; the partials are summed here in a fixed order and gathered
    from the padded layout back onto the plan. With ``weights=False`` (no
    parameter wants a gradient, as in the sticking-the-landing inverse
    pass) only the sweep runs, and both parameter cotangents are None. x,
    gy, gl and gx are in x's storage dtype (float32 or bf16); the
    parameter cotangents are f32."""
    from ._build import load_library

    lib = load_library()
    n, d = x.shape
    if x.dtype not in STORAGE_DTYPES or gy.dtype != x.dtype \
            or gl.dtype != x.dtype:
        raise ValueError(f"B5 takes x, gy and gl of one dtype, float32 or "
                         f"bfloat16, got {x.dtype}, {gy.dtype}, {gl.dtype}")
    dev = x.device
    pp = _padded(st)
    tm = pp.tm
    si, sf, li = _plan_arrays(st)
    recompute = saved is None
    if recompute:
        # The Hopper path's recompute writes the stage inputs to device
        # memory as B4 does; the wide path keeps them in shared memory.
        wk = _kernel_weights(st, wbuf)
        chunk = min(n, _BWD_CHUNK_ROWS)
        scratch = torch.empty(_rows(st, chunk) * pp.cols,
                              dtype=torch.float32, device=dev)
        svs = torch.empty(_rows(st, chunk) * _sv_row(st),
                          dtype=torch.float32, device=dev) \
            if tm == 64 else None
    else:
        scratch, svs, wk = saved
        chunk = n
    smem = _smem_bytes(st, tm, True, recompute)
    sms = _sm_count(dev.index)
    nsplit = max(1, min(64, -(-4 * sms // _dw_tiles(pp))))
    gx = torch.empty_like(x)
    n_chunks = -(-n // chunk)
    w_part = torch.empty(n_chunks * nsplit if weights else 0, pp.nat_len,
                         dtype=torch.float32, device=dev)
    p_parts = []
    with torch.cuda.device(dev), annotate("enflows.cuda.fused_coupling_bwd"):
        stream = torch.cuda.current_stream().cuda_stream
        for c in range(n_chunks):
            r0, r1 = c * chunk, min(n, (c + 1) * chunk)
            rows = r1 - r0
            grid = _grid(-(-rows // tm), smem, dev)
            p_part = torch.empty(grid, st.n_pslots * d, dtype=torch.float32,
                                 device=dev)
            head = (int(x.dtype == torch.bfloat16), x[r0:].data_ptr(),
                    gy[r0:].data_ptr(), gl[r0:].data_ptr(),
                    gx[r0:].data_ptr(), wk.data_ptr(), pbuf.data_ptr(), si,
                    sf, len(st.items), li, len(st.layers), rows)
            if tm == 64:
                err = lib.enf_coupling_bwd(
                    *head, _rows(st, rows), d, pp.lda, pp.ldo,
                    _ring_slots(st, True, recompute), pp.slot, smem, grid,
                    st.n_pslots, scratch.data_ptr(), svs.data_ptr(),
                    int(recompute), p_part.data_ptr(), _DERIV_SHIFT, stream)
            else:
                err = lib.enf_coupling_bwd_wide(
                    *head, d, pp.ldh, tm, smem, grid, st.n_pslots,
                    scratch.data_ptr(),
                    None if recompute else svs.data_ptr(),
                    p_part.data_ptr(), _DERIV_SHIFT, stream)
            _raise_on(lib, err, "B5 (fused coupling backward sweep)")
            if not weights:
                continue
            if tm == 64:
                err = lib.enf_coupling_dw(
                    scratch.data_ptr(), li, len(st.layers), _rows(st, rows),
                    nsplit, w_part[c * nsplit:].data_ptr(), pp.nat_len,
                    _DW_SMEM, stream)
            else:
                err = lib.enf_coupling_dw_wide(
                    scratch.data_ptr(), li, len(st.layers), rows, nsplit,
                    w_part[c * nsplit:].data_ptr(), pp.nat_len,
                    _WIDE_DW_SMEM, stream)
            _raise_on(lib, err, "B5 (coupling weight-gradient reduction)")
            p_parts.append(p_part.sum(0))
    if _is_bf16(st, x):
        LAUNCHES_BF16["coupling_bwd"] += 1
    else:
        LAUNCHES["coupling_bwd"] += 1
    if not weights:
        return gx, None, None
    gw = w_part.sum(0)[_index(st, "grad_idx", dev)]
    return gx, gw, sum(p_parts[1:], p_parts[0])


def _rows_fit(st: _Structure, x) -> bool:
    """Whether B4 should write B5's rows for this batch: when they take at
    most half of the memory the card has free (the driver's free memory
    plus what PyTorch's allocator holds unused). The other half is a
    margin for the rest of the step (the gradients, the optimizer, the
    caller's tensors), not a measured optimum."""
    need = 4 * _rows(st, x.shape[0]) * (_padded(st).cols + _sv_row(st))
    free, _ = torch.cuda.mem_get_info(x.device)
    unused = torch.cuda.memory_reserved(x.device) \
        - torch.cuda.memory_allocated(x.device)
    return need <= (free + unused) // 2


class _FusedCoupling(torch.autograd.Function):
    """Forward: B4. Backward: B5 (``coupling.py:719-790``). ``save``: True
    or False to have B4 write B5's rows (B5 then skips its recompute) or
    not; None decides by ``_rows_fit``. Rows are written only when a
    gradient is wanted, x's alone included. When neither buffer of the
    plan wants one, B5 skips its weight-gradient reduction."""

    @staticmethod
    def forward(ctx, x, wbuf, pbuf, st, physical_order, save):
        save = any(ctx.needs_input_grad[:3]) and (
            _rows_fit(st, x) if save is None else save)
        y, ladj, ctx.saved = _launch_fwd(st, x, wbuf, pbuf, save)
        ctx.save_for_backward(x, wbuf, pbuf)
        ctx.st = st
        ctx.gather = not physical_order and not st.identity_out
        if ctx.gather:
            y = y[:, list(st.out_map)]
        return y, ladj

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gl):
        x, wbuf, pbuf = ctx.saved_tensors
        st = ctx.st
        if ctx.gather:
            # The forward returned y_phys[:, out_map]; the vjp of that
            # gather gathers by the inverse permutation (coupling.py:764-767).
            gy = gy[:, np.argsort(st.out_map).tolist()]
        gx, gw, gp = _launch_bwd(st, x, wbuf, pbuf, gy.contiguous(),
                                 gl.contiguous(), ctx.saved,
                                 weights=any(ctx.needs_input_grad[1:3]))
        ctx.saved = None
        return gx, gw, gp, None, None, None


def fused_coupling_forward_and_ladj(chain, x, physical_order: bool = False):
    """(y, per-sample ladj) of a coupling stack on an (n, d) batch in one
    pass (``enflows_tpu/ops/pallas/coupling.py:793-811``).

    ``physical_order=True`` returns y with its lanes in the kernel's
    physical order, for consumers whose reduction of y does not depend on
    lane order (the isotropic base logpdf); otherwise y is gathered into
    logical order. On a CUDA tensor: B4, with B5 as its backward. On a CPU
    tensor: ``coupling_forward_plain`` through the same plan. A bf16 batch
    (storage) gives y and ladj in bf16, x's gradient too, and the
    parameters' gradients in their own dtype; the arithmetic is float32
    with TF32 or bf16 products per coupling (``compute_dtype``)."""
    if x.dim() != 2:
        raise ValueError(f"fused coupling takes an (n, d) batch, got shape "
                         f"{tuple(x.shape)}")
    st = _stack_structure(chain, x.shape[1])
    if st is None:
        raise ValueError(f"chain is not a fusible coupling stack at "
                         f"d={x.shape[1]} (see is_fusible_coupling_stack)")
    if x.device.type == "cpu":
        wbuf, pbuf = _stack_plan(chain, st, torch.promote_types(
            x.dtype, torch.float32), x.device)
        y, ladj = coupling_forward_plain(st, wbuf, pbuf, x)
        if not physical_order and not st.identity_out:
            y = y[:, list(st.out_map)]
        return y, ladj
    _check_cuda_input(chain, x, is_fusible_coupling_stack)
    wbuf, pbuf = _stack_plan(chain, st, torch.float32, x.device)
    return _FusedCoupling.apply(x, wbuf, pbuf, st, physical_order, None)

