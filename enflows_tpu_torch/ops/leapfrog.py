"""Fused leapfrog kernel B6: wrapper, plain version, dispatch and the HMC
transition built on it.

PyTorch counterpart of ``enflows_tpu/ops/pallas/leapfrog.py``. For a
flow-preconditioned target with a fusible chain f (the chains of
``ops.elementwise``) and a diagonal-Gaussian base,

    logp(q) = sum_j N(f(q)_j; mu_j, var_j) + ladj_f(q),

``fused_leapfrog`` integrates L velocity-Verlet steps of every chain in one
launch of kernel B6 (``csrc/leapfrog.cu``, replacing ``_fused_leapfrog_impl``),
in which a group of G lanes owns a chain and keeps its state in registers
for the whole trajectory. ``leapfrog_plain`` computes the same in plain
PyTorch. The wrapper hands B6 a plan (``leapfrog_plan``): each Householder
stage as its normalized rows (``reflection_rows``), applied one reflection
at a time, or as its dense Q where that is cheaper; and a launch
(``leapfrog_geometry``).

Dispatch: a CPU tensor takes ``leapfrog_plain``; a CUDA tensor launches B6,
or raises ``ValueError`` for an input it does not take and ``RuntimeError``
when the launch fails. Nothing falls back to the plain version.

The TPU layout (packed lanes, pad lanes with q = 1 and p = 0, pattern rows,
the segment matrix for per-chain sums) has no counterpart: the kernel takes
contiguous (n, d) tensors and (d,) vectors for the base and the mass.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..bijectors.householder import Householder, householder_matrix
from ..distributions.base import _LOG_2PI
from ..utils.profiling import annotate
from .elementwise import (_ADJOINT, _APPLY, _CODE, _HH, _check_cuda_input,
                          _check_kinds, _ints, _raise_on, _stages,
                          is_fusible_chain, reflection_rows, round_to,
                          rounded_rows)

_SMEM_MAX = 232448      # the card's opt-in shared memory per block
_LF_BLOCK = 128         # threads per block (LF_BLOCK_MAX in csrc/leapfrog.cu)
_LF_MIN_BLOCKS_E4 = 5   # blocks per SM of the E = 4 kernel (LF_MIN_BLOCKS_E4)
_LF_NREG = 2            # runs held in registers (LF_NREG)
_LF_NCONST = 5          # constants per stage and column (LF_NCONST)
_HD = 6                 # a Householder stage applied as its dense Q
_MAX_TILE = 128         # columns in flight: 32 lanes x 4 elements

# Kernel launches, raised by the wrapper right after a launch succeeds and
# nowhere else: float32 storage in LAUNCHES, bf16 storage (B6's bf16
# instantiation) in LAUNCHES_BF16.
LAUNCHES = {"leapfrog": 0}
LAUNCHES_BF16 = {"leapfrog": 0}


def lane_group(d: int, elements=None) -> tuple[int, int]:
    """(G, E): G lanes own a chain, E elements each (E in 1, 2, 4), so that
    G E covers min(d, 128) columns; wider chains (no Householder stage) are
    walked in column tiles of G E. ``elements`` forces E."""
    w = min(d, _MAX_TILE)
    E = elements or (1 if w <= 16 else 2 if w <= 32 else 4)
    if E not in (1, 2, 4):
        raise ValueError(f"elements per lane must be 1, 2 or 4, got {E}")
    G = 1 << max(0, math.ceil(math.log2(-(-w // E))))
    if G > 32:
        raise ValueError(f"{E} elements per lane cannot cover d={d} with "
                         f"one warp")
    return G, E


class Geometry(NamedTuple):
    G: int                 # lanes per chain
    E: int                 # elements per lane
    block: int             # threads per block
    chains_per_block: int
    grid: int
    smem: int              # bytes of shared memory per block


def _smem_bytes(n_stages, n_rows, n_smem_slots, G, E, block):
    """B6's shared memory per block: the plan (16 bytes a stage), the
    constants ((4 + 5 n_stages) per column), the reflection rows and the
    lane-private runs."""
    dc = G * E
    return 16 * n_stages + 4 * ((4 + _LF_NCONST * n_stages) * dc
                                + n_rows * dc + n_smem_slots * 2 * E * block)


def leapfrog_geometry(n: int, d: int, n_stages: int, *, n_rows: int = 0,
                      n_smem_slots: int = 0, elements=None) -> Geometry:
    """B6's launch: ``lane_group(d)`` lanes per chain, _LF_BLOCK threads per
    block (halved, down to 32, while the shared memory would not fit: a
    ``leapfrog_plan`` fits at 32), one chain per lane group and blocks
    enough to cover n. 8192 chains at d=50 take G=16, E=4: 8 chains per
    block, 1024 blocks, 1.55 waves of the 132 x _LF_MIN_BLOCKS_E4 the card
    holds at once."""
    G, E = lane_group(d, elements)
    block = _LF_BLOCK
    while block > 32 and _smem_bytes(n_stages, n_rows, n_smem_slots, G, E,
                                     block) > _SMEM_MAX:
        block //= 2
    per = block // G
    return Geometry(G, E, block, per, -(-n // per),
                    _smem_bytes(n_stages, n_rows, n_smem_slots, G, E, block))


class LeapfrogPlan(NamedTuple):
    """What B6 is told about a chain: 4 ints per stage (code, a, b, slot;
    see ``LfPlan`` in csrc/leapfrog.cu), the reflection rows it holds in
    shared memory, the runs stored across a Householder stage, and which
    stages go dense."""
    words: tuple
    n_stages: int
    n_rows: int
    n_slots: int
    dense: tuple           # stage indices applied as their dense Q
    reflect: tuple         # stage indices applied as reflections

    @property
    def nreg(self) -> int:
        return 0 if self.n_slots == 0 else _LF_NREG

    @property
    def n_smem_slots(self) -> int:
        return max(0, self.n_slots - _LF_NREG)


def leapfrog_plan(chain, d: int, elements=None) -> LeapfrogPlan:
    """B6's plan of ``chain`` at width d. A Householder stage of k
    reflections is applied reflection by reflection where 2 k <= d (4 d k
    FLOP against the dense product's 2 d^2), else as its dense Q; while the
    rows would not fit a 32-thread block's shared memory, the stage with the
    most rows goes dense too. Each elementwise stage takes its parameter
    slots in order, as ``_chain_plan`` lays them out. A Householder stage
    right after an elementwise one closes a run of them, which gets the next
    store slot."""
    stages = _stages(chain)
    hh = [isinstance(s, Householder) for s in stages]
    closes = [h and i > 0 and not hh[i - 1] for i, h in enumerate(hh)]
    n_slots = sum(closes)
    G, E = lane_group(d, elements)
    ks = {i: s.vmat().shape[0] for i, s in enumerate(stages) if hh[i]}
    reflect = {i for i, k in ks.items() if 2 * k <= d}
    while _smem_bytes(len(stages), sum(ks[i] for i in reflect),
                      max(0, n_slots - _LF_NREG), G, E, 32) > _SMEM_MAX:
        reflect.remove(max(sorted(reflect), key=ks.get))
    words, pslot, row, dense = [], 0, 0, []
    for i, s in enumerate(stages):
        slot = sum(closes[:i]) if closes[i] else -1
        if i in reflect:
            words += [_HH, row, ks[i], slot]
            row += ks[i]
        elif hh[i]:
            words += [_HD, len(dense), 0, slot]
            dense.append(i)
        else:
            words += [_CODE[type(s)], pslot, 0, -1]
            pslot += len(s.fields())
    return LeapfrogPlan(tuple(words), len(stages), row, n_slots,
                        tuple(dense), tuple(sorted(reflect)))


def is_fusible_leapfrog(chain, dim: int, dtype=torch.float32) -> bool:
    """Whether B6 takes this chain: exactly when ``is_fusible_chain`` holds
    (d <= 128 with a Householder stage, d <= 2048 without, at most 32
    stages of the six kinds, float32 or bf16 storage). Every such chain has
    a launch: a Householder stage whose rows would not fit shared memory is
    applied as its dense Q."""
    return is_fusible_chain(chain, dim, dtype)


# ------------------------------------------------------------------
# Plain version.

def _stage_params(chain, dtype):
    """(kind, params) per stage in ``dtype``: an elementwise stage's fields,
    a Householder stage's Q."""
    out = []
    for s in _stages(chain):
        if isinstance(s, Householder):
            out.append((Householder, householder_matrix(s.vmat(),
                                                        dtype=dtype)))
        else:
            out.append((type(s), tuple(v.to(dtype)
                                       for v in s.fields().values())))
    return out


def _logp_and_grad(stages, q, mu, iv, lv):
    """(logp, grad logp) at q: the chain forward keeping every stage's
    input, then the adjoint sweep with cy = -(y - mu) iv and ce = 1 through
    the hand-derived stage adjoints that B6 implements
    (``_chain_fwd_bwd``, leapfrog.py:49-102)."""
    inputs, t, acc = [], q, 0.0
    for kind, params in stages:
        inputs.append(t)
        if kind is Householder:
            t = t @ params.T
        elif kind == "rows":              # reflection by reflection
            for w in params:
                t = t - 2.0 * (t @ w)[..., None] * w
        else:
            t, elem = _APPLY[kind](t, *params)
            acc = acc + elem
    dv = t - mu
    logp = (-(dv * dv * iv + _LOG_2PI + lv) * 0.5 + acc).sum(-1)
    cy, ce = -dv * iv, torch.ones_like(t)
    for (kind, params), t_in in zip(reversed(stages), reversed(inputs)):
        if kind is Householder:
            cy = cy @ params
        elif kind == "rows":
            for w in params.flip(0):
                cy = cy - 2.0 * (cy @ w)[..., None] * w
        else:
            cy = _ADJOINT[kind](t_in, *params, cy, ce)[0]
    return logp, cy


def _as(v, default, like):
    """``v`` (None for ``default``, a scalar or a (d,) vector) as a tensor
    like ``like``."""
    return torch.as_tensor(default if v is None else v, dtype=like.dtype,
                           device=like.device)


def _leapfrog_plain_bf16(chain, q, p, step_size, num_steps, inv_mass_diag,
                         base_mean, base_var):
    """B6's bf16 arithmetic: q and p widened to float32, the chain's
    parameters, reflection rows and dense Q rounded to bf16 as the
    kernel's plan holds them (``_prepare``; the rows normalized again),
    the step size, mass and base in float32, the trajectory in float32
    with each Householder stage applied as the kernel applies it, and q_L,
    p_L, logp_0 and logp_L rounded to bf16 once."""
    with torch.no_grad():
        args = _prepare(chain, q, step_size, inv_mass_diag, base_mean,
                        base_var, storage=q.dtype)
        plan = args.plan
        stages, slot, row, dense = [], 0, 0, 0
        for i, s in enumerate(_stages(chain)):
            if isinstance(s, Householder) and i in plan.reflect:
                k = plan.words[4 * i + 2]
                stages.append(("rows", args.rows[row:row + k]))
                row += k
            elif isinstance(s, Householder):
                stages.append((Householder, args.qbuf[dense]))
                dense += 1
            else:
                n = len(s.fields())
                stages.append((type(s), tuple(
                    args.pbuf[(slot + j) * q.shape[1]:(slot + j + 1)
                              * q.shape[1]] for j in range(n))))
                slot += n
        q32, p32 = q.to(torch.float32), p.to(torch.float32)
        lv = -torch.log(args.iv)
        eps = args.eps
        logp0, g = _logp_and_grad(stages, q32, args.mu, args.iv, lv)
        logp = logp0
        for _ in range(num_steps):
            p32 = p32 + 0.5 * eps * g
            q32 = q32 + eps * p32 * args.im
            logp, g = _logp_and_grad(stages, q32, args.mu, args.iv, lv)
            p32 = p32 + 0.5 * eps * g
    return (q32.to(q.dtype), p32.to(q.dtype), logp0.to(q.dtype),
            logp.to(q.dtype))


def leapfrog_plain(chain, q, p, step_size, num_steps: int,
                   inv_mass_diag=None, base_mean=None, base_var=None):
    """Plain B6: ``num_steps`` leapfrog steps in q's dtype, one stage at a
    time. Returns (q_L, p_L, logp_0, logp_L); see ``fused_leapfrog``. bf16
    q and p run B6's bf16 arithmetic (``_leapfrog_plain_bf16``)."""
    _check_kinds(chain)
    if q.dtype == torch.bfloat16:
        return _leapfrog_plain_bf16(chain, q, p, step_size, num_steps,
                                    inv_mass_diag, base_mean, base_var)
    with torch.no_grad():
        stages = _stage_params(chain, q.dtype)
        mu = _as(base_mean, 0.0, q)
        iv = 1.0 / _as(base_var, 1.0, q)
        lv = -torch.log(iv)
        im = _as(inv_mass_diag, 1.0, q)
        eps = torch.as_tensor(step_size, dtype=q.dtype, device=q.device)
        logp0, g = _logp_and_grad(stages, q, mu, iv, lv)
        logp = logp0
        for _ in range(num_steps):
            p = p + 0.5 * eps * g
            q = q + eps * p * im
            logp, g = _logp_and_grad(stages, q, mu, iv, lv)
            p = p + 0.5 * eps * g
    return q, p, logp0, logp


# ------------------------------------------------------------------
# CUDA wrapper.

def _lane_vector(v, default, d, device, dtype=torch.float32):
    """A contiguous (d,) vector on ``device`` from None, a scalar or a (d,)
    vector."""
    if v is None:
        return torch.full((d,), default, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device).expand(d) \
        .contiguous()


class LeapfrogArgs(NamedTuple):
    """B6's device arguments for one chain at one width (``_prepare``)."""
    plan: LeapfrogPlan
    pbuf: torch.Tensor     # (n_pslots * d,) elementwise parameters
    rows: torch.Tensor     # (n_rows, d) normalized reflection rows
    qbuf: torch.Tensor     # (n_dense, d, d) dense stages' Q
    qtbuf: torch.Tensor    # and their Q^T
    eps: torch.Tensor      # 0-d step size
    im: torch.Tensor       # (d,) inverse mass
    mu: torch.Tensor       # (d,) base mean
    iv: torch.Tensor       # (d,) 1 / base variance
    elements: object       # E forced, or None for lane_group's choice


def _launch(args: LeapfrogArgs, q, p, num_steps):
    """B6 on contiguous CUDA tensors q and p of one storage dtype, float32
    or bf16 (the kernel's two instantiations; the storage code passed
    is q's dtype, and p must match it)."""
    from ._build import load_library

    lib = load_library()
    n, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or p.dtype != q.dtype:
        raise ValueError(f"B6 takes q and p of one dtype, float32 or "
                         f"bfloat16, got {q.dtype} and {p.dtype}")
    bf16 = q.dtype == torch.bfloat16
    plan = args.plan
    geo = leapfrog_geometry(n, d, plan.n_stages, n_rows=plan.n_rows,
                            n_smem_slots=plan.n_smem_slots,
                            elements=args.elements)
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    lp0 = torch.empty(n, dtype=q.dtype, device=q.device)
    lpL = torch.empty_like(lp0)
    with torch.cuda.device(q.device), annotate("enflows.cuda.fused_leapfrog"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.enf_fused_leapfrog(
            int(bf16), q.data_ptr(), p.data_ptr(), q_out.data_ptr(),
            p_out.data_ptr(),
            lp0.data_ptr(), lpL.data_ptr(), args.eps.data_ptr(),
            args.im.data_ptr(), args.mu.data_ptr(), args.iv.data_ptr(),
            args.pbuf.data_ptr(), args.rows.data_ptr(), args.qbuf.data_ptr(),
            args.qtbuf.data_ptr(), _ints(plan.words), plan.n_stages, n, d,
            geo.G, geo.E, plan.nreg, plan.n_rows, num_steps, geo.grid,
            geo.block, geo.smem, stream)
    _raise_on(lib, err, "B6 (fused leapfrog)" + (" bf16" if bf16 else ""))
    (LAUNCHES_BF16 if bf16 else LAUNCHES)["leapfrog"] += 1
    return q_out, p_out, lp0, lpL


def _prepare(chain, q, step_size, inv_mass_diag=None, base_mean=None,
             base_var=None, elements=None, dtype=torch.float32,
             storage=torch.float32) -> LeapfrogArgs:
    """B6's plan and device arguments for ``chain`` at q's width (in
    ``dtype``: float32 for the kernel, float64 for the CPU tests' replay of
    it). With bf16 ``storage`` the chain's parameters and dense Q are
    rounded to bf16, as ``_chain_static_and_params(chain, dim, q.dtype,
    dp)`` casts them (leapfrog.py:249), and the reflection rows as B1-B3's
    (``rounded_rows``); step size, mass and base stay as they are."""
    d, dev = q.shape[1], q.device
    f = dict(dtype=dtype, device=dev)
    rnd = lambda t: round_to(t, storage) if dtype == torch.float32 \
        else t.to(dtype)
    with torch.no_grad():
        plan = leapfrog_plan(chain, d, elements)
        stages = _stages(chain)
        pvecs = [rnd(v).expand(d) for s in stages
                 if not isinstance(s, Householder)
                 for v in s.fields().values()]
        rows = [rounded_rows(reflection_rows(stages[i], dtype), storage)
                for i in plan.reflect]
        qs = [rnd(householder_matrix(stages[i].vmat(), dtype=dtype))
              for i in plan.dense]
        qbuf = torch.stack(qs) if qs else torch.zeros(0, d, d, **f)
        args = LeapfrogArgs(
            plan,
            torch.cat(pvecs).contiguous() if pvecs else torch.zeros(0, **f),
            torch.cat(rows).contiguous() if rows else torch.zeros(0, d, **f),
            qbuf.contiguous(), qbuf.transpose(1, 2).contiguous(),
            torch.as_tensor(step_size, **f).reshape(()),
            _lane_vector(inv_mass_diag, 1.0, d, dev, dtype),
            _lane_vector(base_mean, 0.0, d, dev, dtype),
            1.0 / _lane_vector(base_var, 1.0, d, dev, dtype), elements)
    return args


def fused_leapfrog(chain, q, p, step_size, num_steps: int,
                   inv_mass_diag=None, base_mean=None, base_var=None):
    """``num_steps`` leapfrog steps of all chains in one kernel launch.

    Counterpart of ``enflows_tpu/ops/pallas/leapfrog.py:227``. ``chain``:
    the whitened -> base bijector f (fusible). q, p: (n_chains, dim)
    positions and momenta. ``step_size``: a float or a 0-d tensor (on the
    card it is read from device memory). ``inv_mass_diag``: the diagonal
    inverse mass, (dim,) (default 1). ``base_mean``/``base_var``: scalar or
    (dim,) diagonal-Gaussian base (default N(0, I)). Returns
    (q_L, p_L, logp_0, logp_L) with logp(q) = sum N(f(q); mu, var) +
    ladj_f(q), constants included. On a CUDA tensor: B6; on a CPU tensor:
    ``leapfrog_plain``. bf16 q and p (storage only: the chain's parameters
    rounded to bf16, the trajectory in float32) give q_L, p_L and both logp
    in bf16."""
    _check_kinds(chain)
    if q.device.type == "cpu":
        return leapfrog_plain(chain, q, p, step_size, num_steps,
                              inv_mass_diag, base_mean, base_var)
    _check_cuda_input(chain, q, is_fusible_leapfrog)
    if (p.shape != q.shape or p.dtype != q.dtype or p.device != q.device
            or not p.is_contiguous()):
        raise ValueError(f"p must be a contiguous {q.dtype} tensor of shape "
                         f"{tuple(q.shape)} on {q.device}")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    return _launch(_prepare(chain, q, step_size, inv_mass_diag, base_mean,
                            base_var, storage=q.dtype), q, p, num_steps)


# ------------------------------------------------------------------
# One HMC transition over all chains.

def flow_hmc_transition(leapfrog, chain, q, noise, u, step_size,
                        num_steps: int, inv_mass_diag=None, base_mean=None,
                        base_var=None):
    """One HMC transition of all chains given its draws: momentum
    p_0 = noise * sqrt(1 / inv_mass_diag), ``num_steps`` steps of
    ``leapfrog`` (``fused_leapfrog`` or ``leapfrog_plain``), and the
    Metropolis-Hastings correction with the uniforms ``u`` (n,); a NaN
    energy change rejects. Returns (q_new, logp_new, accept_prob, accepted)
    (``leapfrog.py:282-317``)."""
    if inv_mass_diag is None:
        p0 = noise
        ke = lambda p: 0.5 * (p * p).sum(-1)
    else:
        im = torch.as_tensor(inv_mass_diag, dtype=q.dtype, device=q.device)
        p0 = noise * torch.sqrt(1.0 / im)
        ke = lambda p: 0.5 * (p * p * im).sum(-1)
    q1, p1, lp0, lp1 = leapfrog(chain, q, p0, step_size, num_steps,
                                inv_mass_diag, base_mean, base_var)
    delta = (-lp0 + ke(p0)) - (-lp1 + ke(p1))
    delta = delta.masked_fill(torch.isnan(delta), -math.inf)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accepted = u < accept_prob
    q_new = torch.where(accepted[:, None], q1, q)
    logp_new = torch.where(accepted, lp1, lp0)
    return q_new, logp_new, accept_prob, accepted


def fused_flow_hmc_step(chain, generator, q, step_size, num_steps: int,
                        inv_mass_diag=None, base_mean=None, base_var=None):
    """One vectorized HMC transition over all chains through
    ``fused_leapfrog``: momentum refresh, L leapfrog steps, MH correction,
    with the draws taken from ``generator``
    (``enflows_tpu/ops/pallas/leapfrog.py:282``). Returns
    (q_new, logp_new (n,), accept_prob (n,), accepted (n,))."""
    noise = torch.randn(q.shape, generator=generator, dtype=q.dtype,
                        device=q.device)
    u = torch.rand(q.shape[0], generator=generator, dtype=q.dtype,
                   device=q.device)
    return flow_hmc_transition(fused_leapfrog, chain, q, noise, u,
                               step_size, num_steps, inv_mass_diag,
                               base_mean, base_var)
