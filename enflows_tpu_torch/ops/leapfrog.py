"""Fused leapfrog kernel B6: wrapper, plain version, dispatch and the HMC
transition built on it.

PyTorch counterpart of ``enflows_tpu/ops/pallas/leapfrog.py``. For a
flow-preconditioned target with a fusible chain f (the chains of
``ops.elementwise``) and a diagonal-Gaussian base,

    logp(q) = sum_j N(f(q)_j; mu_j, var_j) + ladj_f(q),

``fused_leapfrog`` integrates L velocity-Verlet steps of every chain in one
launch of kernel B6 (``csrc/leapfrog.cu``, replacing ``_fused_leapfrog_impl``),
which keeps q, p and the chain's stage inputs on chip for the whole
trajectory. ``leapfrog_plain`` computes the same in plain PyTorch.

Dispatch: a CPU tensor takes ``leapfrog_plain``; a CUDA tensor launches B6,
or raises ``ValueError`` for an input it does not take and ``RuntimeError``
when the launch fails. Nothing falls back to the plain version.

The TPU layout (packed lanes, pad lanes with q = 1 and p = 0, pattern rows,
the segment matrix for per-chain sums) has no counterpart: the kernel takes
contiguous (n, d) tensors and (d,) vectors for the base and the mass.
"""
from __future__ import annotations

import math

import torch

from ..bijectors.householder import Householder, householder_matrix
from ..distributions.base import _LOG_2PI
from .elementwise import (_ADJOINT, _APPLY, _BLOCK, _check_cuda_input,
                          _check_kinds, _chain_plan, _ints, _raise_on,
                          _sm_count, _stages, _transposed,
                          is_fusible_chain)

_SMEM_MAX = 232448           # the card's opt-in shared memory per block
_TILE_MAX = 256

# Kernel launches, raised by the wrapper right after a launch succeeds and
# nowhere else.
LAUNCHES = {"leapfrog": 0}


def _chain_bytes(n_stages: int, d: int) -> int:
    """Shared memory of one chain in B6: q, p, the log-density terms and the
    n_stages + 1 stage inputs and output, d floats each."""
    return 4 * d * (n_stages + 4)


def leapfrog_tile(n: int, d: int, n_stages: int, sms: int) -> int:
    """Chains per block of B6: ceil(n / (2 sms)), so that the grid covers
    every SM twice where n allows, at most what one block's shared memory
    holds (and at most 256)."""
    fit = min(_TILE_MAX, _SMEM_MAX // _chain_bytes(n_stages, d))
    return min(fit, max(1, -(-n // (2 * sms))))


def is_fusible_leapfrog(chain, dim: int, dtype=torch.float32) -> bool:
    """Whether B6 takes this chain: ``is_fusible_chain`` holds and one
    chain's state fits a block's shared memory."""
    return (is_fusible_chain(chain, dim, dtype)
            and _chain_bytes(len(_stages(chain)), dim) <= _SMEM_MAX)


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
        else:
            t, elem = _APPLY[kind](t, *params)
            acc = acc + elem
    dv = t - mu
    logp = (-(dv * dv * iv + _LOG_2PI + lv) * 0.5 + acc).sum(-1)
    cy, ce = -dv * iv, torch.ones_like(t)
    for (kind, params), t_in in zip(reversed(stages), reversed(inputs)):
        if kind is Householder:
            cy = cy @ params
        else:
            cy = _ADJOINT[kind](t_in, *params, cy, ce)[0]
    return logp, cy


def _as(v, default, like):
    """``v`` (None for ``default``, a scalar or a (d,) vector) as a tensor
    like ``like``."""
    return torch.as_tensor(default if v is None else v, dtype=like.dtype,
                           device=like.device)


def leapfrog_plain(chain, q, p, step_size, num_steps: int,
                   inv_mass_diag=None, base_mean=None, base_var=None):
    """Plain B6: ``num_steps`` leapfrog steps in q's dtype, one stage at a
    time. Returns (q_L, p_L, logp_0, logp_L); see ``fused_leapfrog``."""
    _check_kinds(chain)
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

def _lane_vector(v, default, d, device):
    """A contiguous (d,) f32 vector on ``device`` from None, a scalar or a
    (d,) vector."""
    if v is None:
        return torch.full((d,), default, dtype=torch.float32, device=device)
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v.expand(d).contiguous()


def _launch(plan, q, p, eps, im, mu, iv, pbuf, qbuf, num_steps):
    """B6 on contiguous f32 CUDA tensors: eps a 0-d tensor, im/mu/iv (d,)."""
    from ._build import load_library

    lib = load_library()
    n, d = q.shape
    tile = leapfrog_tile(n, d, len(plan.codes), _sm_count(q.device.index))
    grid = -(-n // tile)
    block = min(_BLOCK, 32 * -(-tile * d // 32))
    smem = tile * _chain_bytes(len(plan.codes), d)
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    lp0 = torch.empty(n, dtype=torch.float32, device=q.device)
    lpL = torch.empty_like(lp0)
    qt = _transposed(qbuf)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.enf_fused_leapfrog(
            q.data_ptr(), p.data_ptr(), q_out.data_ptr(), p_out.data_ptr(),
            lp0.data_ptr(), lpL.data_ptr(), eps.data_ptr(), im.data_ptr(),
            mu.data_ptr(), iv.data_ptr(), pbuf.data_ptr(), qbuf.data_ptr(),
            qt.data_ptr(), _ints(plan.codes), _ints(plan.args),
            len(plan.codes), n, d, tile, num_steps, grid, block, smem, stream)
    _raise_on(lib, err, "B6 (fused leapfrog)")
    LAUNCHES["leapfrog"] += 1
    return q_out, p_out, lp0, lpL


def _prepare(chain, q, step_size, inv_mass_diag=None, base_mean=None,
             base_var=None):
    """B6's plan and device arguments for ``chain`` at q's width:
    (plan, pbuf, qbuf, eps, im, mu, iv)."""
    d, dev = q.shape[1], q.device
    with torch.no_grad():
        plan, pbuf, qbuf = _chain_plan(chain, d, dev)
        eps = torch.as_tensor(step_size, dtype=torch.float32,
                              device=dev).reshape(())
        im = _lane_vector(inv_mass_diag, 1.0, d, dev)
        mu = _lane_vector(base_mean, 0.0, d, dev)
        iv = 1.0 / _lane_vector(base_var, 1.0, d, dev)
    return plan, pbuf, qbuf, eps, im, mu, iv


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
    ``leapfrog_plain``."""
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
    plan, pbuf, qbuf, eps, im, mu, iv = _prepare(
        chain, q, step_size, inv_mass_diag, base_mean, base_var)
    return _launch(plan, q, p, eps, im, mu, iv, pbuf, qbuf, num_steps)


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
