"""Fused bijector-chain kernels: wrappers, plain versions and dispatch.

PyTorch counterpart of ``enflows_tpu/ops/pallas/elementwise.py``. Three
kernels, hand-written in CUDA C++ for Hopper (``csrc/elementwise.cu``):

* **B1** ``fused_forward_and_ladj``: whole-chain forward and per-sample ladj
  in one pass (replaces ``_fused_packed_impl``);
* **B2** its backward, the ``backward`` of the same ``autograd.Function``
  (replaces ``_fused_packed_bwd_impl``);
* **B3** ``fused_negll_value_and_grad``: the whitening loss and every
  parameter gradient in one pass (replaces ``_fused_negll_grad_impl``).

Dispatch rule of every wrapper: a CPU tensor goes to the plain
stage-at-a-time version in this module (B2 and B3 by autograd over the plain
stage bodies); a CUDA tensor launches the kernel, or raises ``ValueError``
for an input the kernel does not take and ``RuntimeError`` when the launch
fails. Nothing falls back from a failed kernel to the plain version.

The TPU layout machinery (packing, event padding, the multirow layout,
pattern rows, the block-diagonal Householder, tile constants) has no
counterpart: a contiguous (n, d) CUDA tensor is already row-major flat.

The kernels receive their chain at run time as a plan (``chain_plan``):
four ints per stage, a flat f32 buffer of per-dimension parameter vectors
(scalars broadcast to (d,)), each Householder stage either as its
normalized rows (``reflection_rows``, applied one reflection at a time) or
as its (d, d) matrix Q (``householder_matrix``), and a launch
(``lane_group``, ``chain_geometry``). The kernels' cotangents of those
buffers are mapped back onto the chain's Parameters by autograd through
their construction, as the JAX version does by a vjp over it
(elementwise.py:933-938).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..bijectors.base import Chain
from ..bijectors.center_stretch import CenterContract, CenterStretch
from ..bijectors.householder import Householder, householder_matrix
from ..bijectors.johnson import Johnson, JohnsonInv
from ..bijectors.scale_shift import ScaleShift
from ..distributions.base import std_normal_logpdf

_LOG2 = 0.6931471805599453

ELEMENTWISE_KINDS = (ScaleShift, CenterStretch, CenterContract, Johnson,
                     JohnsonInv)
FUSIBLE_KINDS = ELEMENTWISE_KINDS + (Householder,)

MAX_STAGES = 32              # ENF_MAX_STAGES in csrc/stages.cuh
MAX_HOUSEHOLDER_DIM = 128    # d limit of a chain with a Householder stage
MAX_DIM = 2048               # d limit of an elementwise-only chain

# Kernel launches, one count per kernel, raised by the wrappers right after
# a launch succeeds and nowhere else.
LAUNCHES = {"fwd": 0, "bwd": 0, "negll": 0}

# Stage codes of csrc/stages.cuh; _HD (csrc/elementwise.cu) is a Householder
# stage applied as its dense Q.
_CODE = {ScaleShift: 0, CenterContract: 1, CenterStretch: 2, Johnson: 3,
         JohnsonInv: 4, Householder: 5}
_HH = 5
_HD = 6

_MODE = {"fwd": 0, "bwd": 1, "negll": 2}   # EW_FWD, EW_BWD, EW_NEGLL
_EW_BLOCK = 256           # threads per block (EW_BLOCK_MAX)
_EW_NCONST = 6            # constants per stage and column (EW_NCONST)
_EW_NREG = {1: 8, 2: 4, 4: 2}   # stage inputs in registers (ew_nreg)
_SMEM_MAX = 232448        # the card's opt-in shared memory per block
_MAX_TILE = 128           # columns in flight: 32 lanes x 4 elements


def _stages(chain) -> tuple:
    return tuple(chain.stages) if isinstance(chain, Chain) else (chain,)


def _n_pslots(stages) -> int:
    return sum(len(s.fields()) for s in stages
               if not isinstance(s, Householder))


def is_fusible_chain(chain, dim: int, dtype=torch.float32) -> bool:
    """Whether the fused kernels take this chain
    (``enflows_tpu/ops/pallas/elementwise.py:117-137``).

    Every stage is ScaleShift, CenterContract, CenterStretch, Johnson,
    JohnsonInv or Householder; the dtype is f32 (bf16 storage is not ported
    yet); d <= 128 with a Householder stage and d <= 2048 without; at most
    32 stages. Every such chain has a launch (``chain_plan``,
    ``chain_geometry``)."""
    if dtype != torch.float32 or dim > MAX_DIM or dim < 1:
        return False
    stages = _stages(chain)
    if len(stages) > MAX_STAGES:
        return False
    kinds = ELEMENTWISE_KINDS if dim > MAX_HOUSEHOLDER_DIM else FUSIBLE_KINDS
    return all(type(s) in kinds for s in stages)


# ------------------------------------------------------------------
# Stage bodies (elementwise.py:143-234): the kernels' arithmetic, shared
# transcendentals included. Each returns (y, elementwise ladj term).

def _softplus_from_e(u, e):
    return torch.clamp(u, min=0.0) + torch.log1p(e)


def _sigmoid_from_e(u, e):
    return torch.where(u >= 0.0, torch.ones_like(e), e) / (1.0 + e)


def _apply_scale_shift(t, a, b):
    return t * a + b, torch.log(torch.abs(a))


def _apply_center_contract(t, a, b, c):
    xu = t - c
    u1 = b * (xu - a)
    u2 = b * (xu + a)
    e1 = torch.exp(-torch.abs(u1))
    e2 = torch.exp(-torch.abs(u2))
    y = (_softplus_from_e(u1, e1) - _softplus_from_e(-u2, e2)) / b
    elem = torch.log(_sigmoid_from_e(u1, e1) + _sigmoid_from_e(-u2, e2))
    return y, elem


def _apply_center_stretch(t, a, b, c):
    # The single-exp form of elementwise.py:168-204 in every dtype.
    ab = a * b
    m = torch.clamp(torch.abs(b * t), min=1e-6)
    em = torch.exp(-m)
    one_m = 1.0 - em
    c1 = 4.0 * torch.exp(-2.0 * ab)
    r = torch.sqrt(one_m * one_m + c1 * em)
    denom = one_m + r
    log_s = m + ab - _LOG2 + torch.log(denom)
    y = c + torch.sign(t) * log_s / b
    ae = 2.0 * em / denom
    a2 = torch.exp(2.0 * ab)
    s_sum = 1.0 / (1.0 + ae) + ae / (ae + a2)
    return y, -torch.log(s_sum)


def _apply_johnson(t, gamma, delta, xi, lam):
    u = (t - xi) / lam
    s = torch.sqrt(1.0 + u * u)
    asinh_u = torch.sign(u) * torch.log(torch.abs(u) + s)
    y = gamma + delta * asinh_u
    elem = torch.log(torch.abs(delta / lam)) - torch.log(s)
    return y, elem


def _apply_johnson_inv(t, gamma, delta, xi, lam):
    v = (t - gamma) / delta
    av = torch.abs(v)
    ei = torch.exp(-av)
    e = 1.0 / ei
    sinh_v = torch.sign(v) * 0.5 * (e - ei)
    y = lam * sinh_v + xi
    logcosh = av + torch.log1p(ei * ei) - _LOG2
    elem = torch.log(torch.abs(lam / delta)) + logcosh
    return y, elem


_APPLY = {
    ScaleShift: _apply_scale_shift,
    CenterContract: _apply_center_contract,
    CenterStretch: _apply_center_stretch,
    Johnson: _apply_johnson,
    JohnsonInv: _apply_johnson_inv,
}


# ------------------------------------------------------------------
# Hand-derived stage adjoints. Each takes the stage input t, the parameters
# and the cotangents cy (of y) and ce (of the elementwise ladj term), and
# returns (ct, (g_param, ...)) elementwise, unreduced over samples. The CUDA
# function stage_bwd implements exactly these lines; the CPU tests hold them
# against autograd of the _apply_* bodies above.

def _adjoint_scale_shift(t, a, b, cy, ce):
    return cy * a, (cy * t + ce / a, cy)


def _adjoint_center_contract(t, a, b, c, cy, ce):
    xu = t - c
    u1 = b * (xu - a)
    u2 = b * (xu + a)
    e1 = torch.exp(-torch.abs(u1))
    e2 = torch.exp(-torch.abs(u2))
    y = (_softplus_from_e(u1, e1) - _softplus_from_e(-u2, e2)) / b
    s1 = _sigmoid_from_e(u1, e1)
    s2 = _sigmoid_from_e(-u2, e2)
    p1 = e1 / ((1.0 + e1) * (1.0 + e1))      # sigma' = sigma (1 - sigma)
    p2 = e2 / ((1.0 + e2) * (1.0 + e2))
    S = s1 + s2                               # dy/dt
    ct = cy * S + ce * b * (p1 - p2) / S
    ga = cy * (s2 - s1) - ce * b * (p1 + p2) / S
    gb = (cy * (s1 * (xu - a) + s2 * (xu + a) - y) / b
          + ce * (p1 * (xu - a) - p2 * (xu + a)) / S)
    return ct, (ga, gb, -ct)


def _adjoint_center_stretch(t, a, b, c, cy, ce):
    # y = g^{-1}(t) for g = center_contract(., a, b, c). By implicit
    # differentiation dy/dt = 1/S and dy/dtheta = -(dg/dtheta)/S, with S and
    # dg/dtheta the contract's (above) at x = y; the ladj term is
    # E = -log S(y). With w = |b (y - c)| = log_s, ae = e^{ab - w} and
    # q = ae e^{-2ab}, the contract sigmoids at y are A = 1/(1+ae) and
    # B = q/(1+q) (sigma1 = A, sigma2 = B for t >= 0, swapped for t < 0):
    # the forward's own intermediates, no further exp.
    ab = a * b
    m = torch.clamp(torch.abs(b * t), min=1e-6)
    em = torch.exp(-m)
    one_m = 1.0 - em
    c1 = 4.0 * torch.exp(-2.0 * ab)
    r = torch.sqrt(one_m * one_m + c1 * em)
    denom = one_m + r
    log_s = m + ab - _LOG2 + torch.log(denom)
    sg = torch.sign(t)
    yu = sg * log_s / b
    ae = 2.0 * em / denom
    q = 0.25 * ae * c1
    A = 1.0 / (1.0 + ae)
    B = q / (1.0 + q)
    pA = A * A * ae
    pB = B / (1.0 + q)
    pos = sg >= 0.0
    s1, s2 = torch.where(pos, A, B), torch.where(pos, B, A)
    p1, p2 = torch.where(pos, pA, pB), torch.where(pos, pB, pA)
    S = s1 + s2
    Sy = b * (p1 - p2)                        # dS/dy
    dy_dt = 1.0 / S
    dy_da = (s1 - s2) / S
    dy_db = -(s1 * (yu - a) + s2 * (yu + a) - t) / (b * S)
    dE_dt = -Sy / (S * S)
    dE_da = -(Sy * dy_da - b * (p1 + p2)) / S
    dE_db = -(Sy * dy_db + p1 * (yu - a) - p2 * (yu + a)) / S
    ct = cy * dy_dt + ce * dE_dt
    return ct, (cy * dy_da + ce * dE_da, cy * dy_db + ce * dE_db, cy)


def _adjoint_johnson(t, gamma, delta, xi, lam, cy, ce):
    u = (t - xi) / lam
    s = torch.sqrt(1.0 + u * u)
    asinh_u = torch.sign(u) * torch.log(torch.abs(u) + s)
    cu = cy * delta / s - ce * u / (s * s)    # cotangent of u
    ct = cu / lam
    return ct, (cy, cy * asinh_u + ce / delta, -ct, -(cu * u + ce) / lam)


def _adjoint_johnson_inv(t, gamma, delta, xi, lam, cy, ce):
    v = (t - gamma) / delta
    ei = torch.exp(-torch.abs(v))
    e = 1.0 / ei
    sg = torch.sign(v)
    sinh_v = sg * 0.5 * (e - ei)
    cosh_v = 0.5 * (e + ei)
    tanh_v = sg * (1.0 - ei * ei) / (1.0 + ei * ei)
    cv = cy * lam * cosh_v + ce * tanh_v      # cotangent of v
    ct = cv / delta
    return ct, (-ct, -(cv * v + ce) / delta, cy, cy * sinh_v + ce / lam)


_ADJOINT = {
    ScaleShift: _adjoint_scale_shift,
    CenterContract: _adjoint_center_contract,
    CenterStretch: _adjoint_center_stretch,
    Johnson: _adjoint_johnson,
    JohnsonInv: _adjoint_johnson_inv,
}


# ------------------------------------------------------------------
# Plain versions: stage at a time, in the input's dtype.

def _check_kinds(chain):
    bad = [type(s).__name__ for s in _stages(chain)
           if type(s) not in FUSIBLE_KINDS]
    if bad:
        raise ValueError(f"stages {bad} have no fused kernel")


def forward_and_ladj_plain(chain, x):
    """Plain B1: (y, per-sample ladj), one stage at a time, through the same
    stage bodies as the kernel. Differentiable, so autograd over it is the
    plain B2."""
    t = x
    ladj = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for s in _stages(chain):
        if isinstance(s, Householder):
            Q = householder_matrix(s.vmat(), dtype=t.dtype)
            t = t @ Q.T
            continue
        t, elem = _APPLY[type(s)](t, *s.fields().values())
        ladj = ladj + elem.expand(t.shape).sum(-1)
    return t, ladj


def negll_plain(chain, x):
    """negll = -(sum logN(y) + sum ladj) / n through ``forward_and_ladj_plain``
    (``enflows_tpu/train/whitening.py:49-60``)."""
    y, ladj = forward_and_ladj_plain(chain, x)
    return -(std_normal_logpdf(y).sum() + ladj.sum()) / x.shape[0]


def _grads_by_name(chain, outputs, cotangents=None) -> dict:
    """Pull ``cotangents`` of ``outputs`` back onto every named Parameter of
    ``chain``; a Parameter the outputs do not reach gets zeros."""
    params = dict(chain.named_parameters())
    grads = {k: None for k in params}
    pairs = [(o, c) for o, c in zip(outputs, cotangents or
                                    [None] * len(outputs))
             if o.requires_grad]
    names = [k for k, p in params.items() if p.requires_grad]
    if pairs and names:
        outs, cots = zip(*pairs)
        gs = torch.autograd.grad(
            outs, [params[k] for k in names],
            None if cotangents is None else cots, allow_unused=True)
        grads.update(zip(names, gs))
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in grads.items()}


def negll_value_and_grad_plain(chain, x):
    """Plain B3: (negll, {parameter name: gradient}) by autograd over
    ``negll_plain``."""
    with torch.enable_grad():
        negll = negll_plain(chain, x)
        grads = _grads_by_name(chain, [negll])
    return negll.detach(), grads


# ------------------------------------------------------------------
# The kernels' plan and geometry (csrc/elementwise.cu).

def lane_group(d: int) -> tuple[int, int]:
    """(G, E): G lanes own a sample, E elements each. At d <= 4 a group is
    one thread (E = 1, 2 or 4 covering d); wider, E = 4 and G the power of
    two that covers min(d, 128) columns. Chains wider than 128 (no
    Householder stage) are walked in column tiles of G E = 128."""
    if d <= 4:
        return 1, 1 if d == 1 else 2 if d == 2 else 4
    w = min(d, _MAX_TILE)
    return 1 << math.ceil(math.log2(-(-w // 4))), 4


def reflection_rows(stage, dtype=None):
    """A Householder stage's normalized rows w_r = v_r / |v_r| in the order
    they are applied: y = x Q^T is x <- x - 2 (w_r . x) w_r for r = 0..k-1,
    the adjoint c Q the same in reverse (``householder_matrix``'s Q =
    H_{k-1} ... H_0). Differentiable."""
    V = stage.vmat()
    V = V if dtype is None else V.to(dtype)
    return V * torch.rsqrt((V * V).sum(-1, keepdim=True))


def _header_bytes(n_stages: int, n_rows: int, dc: int) -> int:
    """Shared memory of a block besides the lane-private words: the plan
    (16 bytes a stage), the tile's constants, the reflection rows and 32
    floats for the loss."""
    return 16 * n_stages + 4 * (_EW_NCONST * n_stages * dc + n_rows * dc
                                + 32)


class ChainPlan(NamedTuple):
    """What B1-B3 are told about a chain at width d: 4 ints per stage
    (code, a, b, acc; ``EwPlan`` in csrc/elementwise.cu), which Householder
    stages run as reflections and which as dense Q, and the lane's words."""
    words: tuple
    n_stages: int
    n_pslots: int
    n_rows: int
    n_dense: int
    reflect: tuple         # stage indices applied reflection by reflection
    dense: tuple           # stage indices applied as their dense Q
    n_acc: int             # accumulator words per lane
    d: int
    G: int
    E: int

    def n_words(self, mode: str) -> int:
        """Lane-private words of a lane: B2/B3's accumulators and the stage
        inputs beyond the registers; B1 keeps none."""
        if mode == "fwd":
            return 0
        spill = max(0, self.n_stages - _EW_NREG[self.E])
        return self.n_acc + spill * self.E


def chain_plan(chain, d: int) -> ChainPlan:
    """B1-B3's plan of ``chain`` at width d. Each elementwise stage takes its
    parameter slots in order, its sums at words slot E + i. A Householder
    stage of k reflections runs reflection by reflection where 2 k <= d
    (4 d k FLOP against the dense 2 d^2), its row cotangents at k E words,
    else as its dense Q, dQ at E d words; while the rows would not fit a
    32-thread block's shared memory, the stage with the most rows goes
    dense too."""
    stages = _stages(chain)
    G, E = lane_group(d)
    dc = G * E
    ks = {i: s.vmat().shape[0] for i, s in enumerate(stages)
          if isinstance(s, Householder)}
    reflect = {i for i, k in ks.items() if 2 * k <= d}
    while _header_bytes(len(stages), sum(ks[i] for i in reflect),
                        dc) > _SMEM_MAX:
        reflect.remove(max(sorted(reflect), key=ks.get))
    n_pslots = _n_pslots(stages)
    words, pslot, row, dense, acc = [], 0, 0, [], n_pslots * E
    for i, s in enumerate(stages):
        if i in reflect:
            words += [_HH, row, ks[i], acc]
            row += ks[i]
            acc += ks[i] * E
        elif i in ks:
            words += [_HD, len(dense), 0, acc]
            dense.append(i)
            acc += E * d
        else:
            words += [_CODE[type(s)], pslot, 0, pslot * E]
            pslot += len(s.fields())
    return ChainPlan(tuple(words), len(stages), n_pslots, row, len(dense),
                     tuple(sorted(reflect)), tuple(dense), acc, d, G, E)


class Geometry(NamedTuple):
    block: int             # threads per block
    grid: int
    smem: int              # bytes of shared memory per block
    scratch: bool          # lane-private words in device memory


def chain_geometry(plan: ChainPlan, n: int, mode: str,
                   blocks_per_sm=None, sms: int = 132) -> Geometry:
    """The launch of B1 (mode "fwd"), B2 ("bwd") or B3 ("negll"):
    _EW_BLOCK threads per block (halved, down to 32, while B2/B3's
    lane-private words would not fit shared memory; where they do not fit
    at 32 either, they go to a device scratch at _EW_BLOCK), and as many
    blocks as are resident at once (``blocks_per_sm(block, smem)``, the
    card's occupancy query; 1 if None), each walking its samples in a
    grid-stride loop, but no more than the samples need."""
    dc = plan.G * plan.E
    head = _header_bytes(plan.n_stages, plan.n_rows, dc)
    words = plan.n_words(mode)
    block, scratch = _EW_BLOCK, False
    while block > 32 and head + 4 * words * block > _SMEM_MAX:
        block //= 2
    if head + 4 * words * block > _SMEM_MAX:
        block, scratch = _EW_BLOCK, True
    smem = head + (0 if scratch else 4 * words * block)
    per_sm = blocks_per_sm(block, smem) if blocks_per_sm else 1
    need = -(-n // (block // plan.G))
    return Geometry(block, max(1, min(need, per_sm * sms)), smem, scratch)


# ------------------------------------------------------------------
# CUDA wrappers.

def _chain_plan(chain, d: int, device, dtype=torch.float32):
    """(plan, (pbuf, rbuf, qbuf)): the kernels' plan, the flat
    per-dimension parameter buffer (n_pslots * d,), the reflection stages'
    normalized rows (n_rows, d) and the dense stages' Q (n_dense, d, d), all
    differentiable functions of the chain's Parameters."""
    plan = chain_plan(chain, d)
    stages = _stages(chain)
    pvecs = [p.to(dtype).expand(d) for s in stages
             if not isinstance(s, Householder) for p in s.fields().values()]
    rows = [reflection_rows(stages[i], dtype) for i in plan.reflect]
    qs = [householder_matrix(stages[i].vmat(), dtype=dtype)
          for i in plan.dense]
    f = dict(dtype=dtype, device=device)
    pbuf = torch.cat(pvecs) if pvecs else torch.zeros(0, **f)
    rbuf = torch.cat(rows) if rows else torch.zeros(0, d, **f)
    qbuf = torch.stack(qs) if qs else torch.zeros(0, d, d, **f)
    return plan, (pbuf.contiguous(), rbuf.contiguous(), qbuf.contiguous())


def _check_cuda_input(chain, x, fusible=None):
    """Raise ``ValueError`` unless ``x`` is a non-empty contiguous (n, d)
    float32 CUDA batch, ``fusible(chain, d, dtype)`` holds (default
    ``is_fusible_chain``) and every Parameter lies on x's device."""
    fusible = fusible or is_fusible_chain
    if x.device.type != "cuda":
        raise ValueError(f"fused kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fused kernels take float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"fused kernels take a non-empty (n, d) batch, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused kernels take a contiguous batch")
    if not fusible(chain, x.shape[1], x.dtype):
        raise ValueError(f"chain is not fusible at d={x.shape[1]} "
                         f"(see {fusible.__name__})")
    for name, p in chain.named_parameters():
        if p.device != x.device:
            raise ValueError(f"parameter {name} is on {p.device}, the batch "
                             f"on {x.device}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * max(1, len(values)))(*values)


def _raise_on(lib, err: int, kernel: str):
    if err != 0:
        msg = lib.enf_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def occupancy(mode: str, E: int, block: int, smem: int) -> tuple:
    """(blocks per SM, registers per thread, local bytes) of B1/B2/B3's
    instantiation for E elements per lane at ``block`` threads and ``smem``
    bytes (the card's occupancy query)."""
    return _occupancy(_MODE[mode], E, block, smem)


@functools.cache
def _occupancy(mode: int, E: int, block: int, smem: int) -> tuple:
    from ._build import load_library

    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = lib.enf_chain_occupancy(mode, E, block, smem,
                                  *map(ctypes.byref, vals))
    _raise_on(lib, err, "B1-B3 occupancy query")
    return tuple(v.value for v in vals)


_NAMES = {"fwd": "B1 (fused forward)", "bwd": "B2 (fused bwd)",
          "negll": "B3 (fused negll)"}


def _launch(mode: str, plan: ChainPlan, x, bufs, gy=None, gladj=None):
    """One launch of B1 (``mode`` "fwd": returns (y, ladj)), B2 ("bwd":
    (gx, gp, gw, gq) for the cotangents gy (n, d) and gladj (n,)) or B3
    ("negll": (loss sum, gp, gw, gq), unscaled: c_y = y, c_ladj = -1). gp,
    gw and gq are the cotangents of the plan's buffers, the blocks'
    partials summed here in order (elementwise.py:742, :905)."""
    from ._build import load_library

    lib = load_library()
    n, d = x.shape
    pbuf, rbuf, qbuf = bufs
    dev = x.device
    geo = chain_geometry(
        plan, n, mode, lambda b, sm: occupancy(mode, plan.E, b, sm)[0],
        _sm_count(dev.index))
    f32 = dict(dtype=torch.float32, device=dev)
    qt = qbuf.transpose(1, 2).contiguous()
    outs = {k: torch.empty(0, **f32) for k in
            ("y", "ladj", "gx", "loss", "p", "w", "q", "scratch")}
    if mode == "fwd":
        outs["y"] = torch.empty_like(x)
        outs["ladj"] = torch.empty(n, **f32)
    else:
        outs["p"] = torch.empty(geo.grid, plan.n_pslots * d, **f32)
        outs["w"] = torch.empty(geo.grid, plan.n_rows * d, **f32)
        outs["q"] = torch.empty(geo.grid, plan.n_dense * d * d, **f32)
        if mode == "negll":
            outs["loss"] = torch.empty(geo.grid, **f32)
        else:
            outs["gx"] = torch.empty_like(x)
        if geo.scratch:
            outs["scratch"] = torch.empty(
                geo.grid * geo.block * plan.n_words(mode), **f32)
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
    rows_io = [x, gy, outs["y"], outs["gx"]]
    packed = (plan.G == 1 and d == plan.E and plan.E > 1
              and all(t.data_ptr() % (4 * plan.E) == 0
                      for t in rows_io if t is not None and t.numel()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.enf_fused_chain(
            _MODE[mode], x.data_ptr(), ptr(gy), ptr(gladj), ptr(outs["y"]),
            ptr(outs["ladj"]), ptr(outs["gx"]), ptr(pbuf), ptr(rbuf),
            ptr(qbuf), ptr(qt), ptr(outs["scratch"]), ptr(outs["loss"]),
            ptr(outs["p"]), ptr(outs["w"]), ptr(outs["q"]),
            _ints(plan.words), plan.n_stages, n, d, plan.G, plan.E,
            plan.n_pslots, plan.n_rows, plan.n_dense, plan.n_acc,
            int(packed), geo.grid, geo.block, geo.smem, stream)
    _raise_on(lib, err, _NAMES[mode])
    LAUNCHES[mode] += 1
    if mode == "fwd":
        return outs["y"], outs["ladj"]
    grads = (outs["p"].sum(0), outs["w"].sum(0).view(plan.n_rows, d),
             outs["q"].sum(0).view(plan.n_dense, d, d))
    first = outs["loss"].sum() if mode == "negll" else outs["gx"]
    return (first, *grads)


class _FusedChain(torch.autograd.Function):
    """Forward: B1. Backward: B2 (elementwise.py:510-525, :993-1012)."""

    @staticmethod
    def forward(ctx, x, pbuf, rbuf, qbuf, plan):
        y, ladj = _launch("fwd", plan, x, (pbuf, rbuf, qbuf))
        ctx.save_for_backward(x, pbuf, rbuf, qbuf)
        ctx.plan = plan
        return y, ladj

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gladj):
        x, *bufs = ctx.saved_tensors
        gx, gp, gw, gq = _launch("bwd", ctx.plan, x, bufs, gy.contiguous(),
                                 gladj.contiguous())
        return gx, gp, gw, gq, None


def fused_forward_and_ladj(chain, x):
    """(y, per-sample ladj) of ``chain`` on an (n, d) batch in one pass.

    Counterpart of ``fused_forward_and_ladj_packed``
    (``enflows_tpu/ops/pallas/elementwise.py:1018``) and of the kernel
    ``_fused_packed_impl`` (:441). On a CUDA tensor: B1, with B2 as its
    backward. On a CPU tensor: ``forward_and_ladj_plain``."""
    _check_kinds(chain)
    if x.device.type == "cpu":
        return forward_and_ladj_plain(chain, x)
    _check_cuda_input(chain, x)
    plan, bufs = _chain_plan(chain, x.shape[1], x.device)
    return _FusedChain.apply(x, *bufs, plan)


def fused_negll_value_and_grad(chain, x):
    """(negll, {parameter name: gradient}) of the whitening loss
    negll = -(sum logN(chain(x)) + sum ladj) / n, in one pass.

    Counterpart of ``fused_negll_value_and_grad``
    (``enflows_tpu/ops/pallas/elementwise.py:909-939``). On a CUDA tensor:
    B3, whose cotangents of the plan's buffers (parameters, reflection
    rows, dense Q) are mapped onto the chain's Parameters by autograd
    through the plan's construction. On a CPU tensor:
    ``negll_value_and_grad_plain``. The keys are those of
    ``chain.named_parameters()``."""
    _check_kinds(chain)
    if x.device.type == "cpu":
        return negll_value_and_grad_plain(chain, x)
    _check_cuda_input(chain, x)
    n, d = x.shape
    with torch.enable_grad():
        plan, bufs = _chain_plan(chain, d, x.device)
        loss_sum, *gs = _launch("negll", plan, x,
                                tuple(b.detach() for b in bufs))
        grads = _grads_by_name(chain, list(bufs), [g / n for g in gs])
    return -loss_sum / n, grads
