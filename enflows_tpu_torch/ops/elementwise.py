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

The kernel receives its chain at run time as a plan: one code per stage, a
flat f32 buffer of per-dimension parameter vectors (scalars broadcast to
(d,)) and one (d, d) matrix Q per Householder stage, built here by
``householder_matrix``. The kernels' parameter cotangents are mapped back onto
the chain's Parameters by autograd through that construction, as the JAX
version does by a vjp over it (elementwise.py:933-938).
"""
from __future__ import annotations

import ctypes
import functools
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

# Stage codes of csrc/elementwise.cu.
_CODE = {ScaleShift: 0, CenterContract: 1, CenterStretch: 2, Johnson: 3,
         JohnsonInv: 4, Householder: 5}
_HH = 5

_BLOCK = 256                   # threads per block
_FWD_SMEM = 48 * 1024          # B1: 3 tiles of tile * d floats
_FWD_TILE_MAX = 2048
_GRAD_SMEM = 100 * 1024        # B2/B3: two blocks per SM
_GRAD_SMEM_MAX = 232448 - 128  # the card's opt-in limit, less the scratch
_GRAD_TILE_MAX = 512


def _stages(chain) -> tuple:
    return tuple(chain.stages) if isinstance(chain, Chain) else (chain,)


def _n_pslots(stages) -> int:
    return sum(len(s.fields()) for s in stages
               if not isinstance(s, Householder))


def _grad_tile(n_stages: int, n_pslots: int, d: int, negll: bool):
    """(samples per tile, shared bytes) of B2/B3, or (0, 0) if not even one
    sample fits: every stage's input, the per-slot gradient sums and, for
    B3, the loss sums are held for the whole tile."""
    per_sample = 4 * d * (n_stages + 1 + n_pslots + (1 if negll else 0))
    for budget in (_GRAD_SMEM, _GRAD_SMEM_MAX):
        tile = min(_GRAD_TILE_MAX, budget // per_sample)
        if tile > 0:
            return tile, tile * per_sample + 128
    return 0, 0


def is_fusible_chain(chain, dim: int, dtype=torch.float32) -> bool:
    """Whether the fused kernels take this chain
    (``enflows_tpu/ops/pallas/elementwise.py:117-137``).

    Every stage is ScaleShift, CenterContract, CenterStretch, Johnson,
    JohnsonInv or Householder; the dtype is f32 (bf16 storage is not ported
    yet); d <= 128 with a Householder stage and d <= 2048 without; at most
    32 stages, whose tile fits the card's shared memory."""
    if dtype != torch.float32 or dim > MAX_DIM or dim < 1:
        return False
    stages = _stages(chain)
    if len(stages) > MAX_STAGES:
        return False
    kinds = ELEMENTWISE_KINDS if dim > MAX_HOUSEHOLDER_DIM else FUSIBLE_KINDS
    if not all(type(s) in kinds for s in stages):
        return False
    return _grad_tile(len(stages), _n_pslots(stages), dim, True)[0] > 0


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
# CUDA wrappers.

class _Plan(NamedTuple):
    codes: tuple
    args: tuple
    n_pslots: int
    n_hh: int
    d: int


def _chain_plan(chain, d: int, device):
    """(plan, pbuf, qbuf): the stage codes and arguments, the flat f32
    per-dimension parameter buffer (n_pslots * d,) and the stacked
    Householder matrices (n_hh, d, d), both differentiable functions of the
    chain's Parameters."""
    codes, args, pvecs, qs = [], [], [], []
    for s in _stages(chain):
        codes.append(_CODE[type(s)])
        if isinstance(s, Householder):
            args.append(len(qs))
            qs.append(householder_matrix(s.vmat(), dtype=torch.float32))
        else:
            args.append(len(pvecs))
            pvecs.extend(p.to(torch.float32).expand(d)
                         for p in s.fields().values())
    f32 = dict(dtype=torch.float32, device=device)
    pbuf = torch.cat(pvecs) if pvecs else torch.zeros(0, **f32)
    qbuf = torch.stack(qs) if qs else torch.zeros(0, d, d, **f32)
    plan = _Plan(tuple(codes), tuple(args), len(pvecs), len(qs), d)
    return plan, pbuf.contiguous(), qbuf.contiguous()


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


def _transposed(qbuf):
    """Q^T of each stacked Householder matrix, contiguous: the kernels'
    forward product x Q^T reads it (csrc/stages.cuh, householder_apply)."""
    return qbuf.detach().transpose(1, 2).contiguous()


def _launch_fwd(plan: _Plan, x, pbuf, qbuf):
    from ._build import load_library

    lib = load_library()
    n, d = x.shape
    y = torch.empty_like(x)
    ladj = torch.empty(n, dtype=torch.float32, device=x.device)
    tile = max(1, min(_FWD_TILE_MAX, _FWD_SMEM // (12 * d)))
    grid = min(-(-n // tile), 8 * _sm_count(x.device.index))
    qt = _transposed(qbuf)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.enf_fused_fwd(
            x.data_ptr(), y.data_ptr(), ladj.data_ptr(), pbuf.data_ptr(),
            qt.data_ptr(), _ints(plan.codes), _ints(plan.args),
            len(plan.codes), n, d, tile, grid, _BLOCK, 12 * tile * d, stream)
    _raise_on(lib, err, "B1 (fused forward)")
    LAUNCHES["fwd"] += 1
    return y, ladj


def _launch_grad(plan: _Plan, x, pbuf, qbuf, gy=None, gladj=None):
    """B3 when ``gy`` is None: (loss sum, pbuf cotangent, qbuf cotangent),
    unscaled (c_y = y, c_e = -1). B2 otherwise: (gx, pbuf cotangent, qbuf
    cotangent) for the cotangents gy (n, d) and gladj (n,)."""
    from ._build import load_library

    lib = load_library()
    negll = gy is None
    n, d = x.shape
    tile, smem = _grad_tile(len(plan.codes), plan.n_pslots, d, negll)
    per_sm = 2 if smem <= _GRAD_SMEM + 128 else 1
    grid = min(-(-n // tile), per_sm * _sm_count(x.device.index))
    groups = max(1, _BLOCK // (d * d))
    f32 = dict(dtype=torch.float32, device=x.device)
    p_part = torch.empty(grid, plan.n_pslots * d, **f32)
    q_part = torch.zeros(grid, plan.n_hh, groups, d, d, **f32)
    qt = _transposed(qbuf)
    common = (_ints(plan.codes), _ints(plan.args), len(plan.codes), n, d,
              tile, grid, _BLOCK, smem, plan.n_pslots, plan.n_hh, groups)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if negll:
            loss_part = torch.empty(grid, **f32)
            err = lib.enf_fused_negll(
                x.data_ptr(), pbuf.data_ptr(), qbuf.data_ptr(),
                qt.data_ptr(), *common,
                loss_part.data_ptr(), p_part.data_ptr(), q_part.data_ptr(),
                stream)
        else:
            gx = torch.empty_like(x)
            err = lib.enf_fused_bwd(
                x.data_ptr(), gy.data_ptr(), gladj.data_ptr(), gx.data_ptr(),
                pbuf.data_ptr(), qbuf.data_ptr(), qt.data_ptr(), *common,
                p_part.data_ptr(), q_part.data_ptr(), stream)
    _raise_on(lib, err, "B3 (fused negll)" if negll else "B2 (fused bwd)")
    LAUNCHES["negll" if negll else "bwd"] += 1
    # Per-block partials summed here, deterministically (elementwise.py:742,
    # :905).
    gp = p_part.sum(0)
    gq = q_part.sum((0, 2))
    return (loss_part.sum() if negll else gx), gp, gq


class _FusedChain(torch.autograd.Function):
    """Forward: B1. Backward: B2 (elementwise.py:510-525, :993-1012)."""

    @staticmethod
    def forward(ctx, x, pbuf, qbuf, plan):
        y, ladj = _launch_fwd(plan, x, pbuf, qbuf)
        ctx.save_for_backward(x, pbuf, qbuf)
        ctx.plan = plan
        return y, ladj

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gladj):
        x, pbuf, qbuf = ctx.saved_tensors
        gx, gp, gq = _launch_grad(ctx.plan, x, pbuf, qbuf,
                                  gy.contiguous(), gladj.contiguous())
        return gx, gp, gq, None


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
    plan, pbuf, qbuf = _chain_plan(chain, x.shape[1], x.device)
    return _FusedChain.apply(x, pbuf, qbuf, plan)


def fused_negll_value_and_grad(chain, x):
    """(negll, {parameter name: gradient}) of the whitening loss
    negll = -(sum logN(chain(x)) + sum ladj) / n, in one pass.

    Counterpart of ``fused_negll_value_and_grad``
    (``enflows_tpu/ops/pallas/elementwise.py:909-939``). On a CUDA tensor:
    B3, whose parameter cotangents are mapped onto the chain's Parameters
    by autograd through the plan's construction. On a CPU tensor:
    ``negll_value_and_grad_plain``. The keys are those of
    ``chain.named_parameters()``."""
    _check_kinds(chain)
    if x.device.type == "cpu":
        return negll_value_and_grad_plain(chain, x)
    _check_cuda_input(chain, x)
    n, d = x.shape
    with torch.enable_grad():
        plan, pbuf, qbuf = _chain_plan(chain, d, x.device)
        loss_sum, gp, gq = _launch_grad(plan, x, pbuf.detach(),
                                        qbuf.detach())
        grads = _grads_by_name(chain, [pbuf, qbuf], [gp / n, gq / n])
    return -loss_sum / n, grads
