"""Trainer-backed learned annealing transports for SMC.

Counterpart of ``enflows_tpu/smc/flow_transport.py``. Fits a flow T between
SMC temperatures by minimizing the weighted reverse-KL surrogate (the
Annealed Flow Transport objective):

    L(T) = - sum_i w_i [ log pi_{beta'}(T(x_i)) + ladj_T(x_i) ]

with w the normalized particle weights at beta. Each fit is an eager loop of
the trainers' (loss, grad, update, canonicalize) step, and its forward takes
the flow-VI trainer's route: on a CUDA batch a fusible elementwise chain
(the default per-dimension ``ScaleShift``) runs in kernel B1 with B2 as its
backward, a fusible coupling stack in B4 with B5; on the CPU, or for any
other flow, the flow's own autograd path.

Train/estimation split (the AFT paper's adaptation-bias control): the loss
is, term by term, the realized incremental weight up to a T-independent
constant, so fitting T on the particles that estimate log Z would maximize
the estimate itself. The fitter therefore trains on the even-index half of
the population only; ``smc_sample`` estimates the log Z increment from the
held-out odd half.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..bijectors.base import Bijector
from ..bijectors.scale_shift import ScaleShift
from ..ops.elementwise import _grads_by_name
from ..train.vi import _route
from ..train.whitening import averaged, make_train_step
from .smc import _normalized


def default_template(particles) -> Bijector:
    """Identity-initialized per-dim affine transport, on the particles'
    device (``enflows_tpu/smc/flow_transport.py:37``)."""
    like = dict(dtype=particles.dtype, device=particles.device)
    dim = particles.shape[-1]
    return ScaleShift(torch.ones(dim, **like), torch.zeros(dim, **like))


def default_optimizer(params) -> torch.optim.Optimizer:
    """The counterpart of ``optax.adam(5e-2)``."""
    return torch.optim.Adam(params, lr=5e-2)


def _fit(log_base: Callable, log_target: Callable, optimizer: Callable,
         nsteps: int, particles, log_weights, beta_next, flow: Bijector,
         forward: Optional[Callable] = None, axis=None):
    """Train ``flow`` in place for ``nsteps`` steps on the even-index half
    of the particles; returns (flow, the loss of every step)
    (``enflows_tpu/smc/flow_transport.py:54-78``). ``forward(flow, x) ->
    (y, ladj)`` is the route of every step, by default ``train.vi``'s rule
    for the batch.

    ``axis`` (a ``parallel`` mesh axis): the particles are this rank's
    block, of an even length, so its even rows are the global even rows
    (``enflows_tpu/parallel/smc_sharded.py:126-165``). The weights are
    normalized over every rank, the loss is a sum over particles, so its
    gradient is the ranks' gradients summed; every rank runs the same
    update and the flow stays replicated."""
    x = particles[0::2].contiguous()
    w = _normalized(log_weights[0::2], axis)
    forward = forward or _route(flow, x.shape[1], x.dtype, x.device, None,
                                 x.shape[0])

    def logp_next(q):
        return (1.0 - beta_next) * log_base(q) + beta_next * log_target(q)

    def value_and_grad(flow, x):
        with torch.enable_grad():
            y, ladj = forward(flow, x)
            loss = -(w * (logp_next(y) + ladj)).sum()
            grads = _grads_by_name(flow, [loss])
        return loss.detach(), grads

    if axis is not None:
        value_and_grad = averaged(value_and_grad, axis, mean=False)
    step = make_train_step(optimizer(list(flow.parameters())),
                           value_and_grad)
    losses = [step(flow, x) for _ in range(nsteps)]
    return flow, (torch.stack(losses) if losses else
                  x.new_zeros(0))


def make_transport_fitter(log_base: Callable, log_target: Callable,
                          template_fn: Callable = default_template,
                          nsteps: int = 100,
                          optimizer: Optional[Callable] = None,
                          axis=None) -> Callable:
    """Returns ``fit_transport(key, particles, log_weights, beta,
    beta_next)`` for ``smc_sample(fit_transport=...)``: a fresh template
    from ``template_fn(particles)`` trained for ``nsteps`` steps. ``key`` is
    unused, as in JAX. ``optimizer``: a factory ``params ->
    torch.optim.Optimizer``, by default Adam(5e-2), the counterpart of
    ``optax.adam(5e-2)``. ``axis``: fit data-parallel over the ranks'
    blocks (see ``_fit``)."""
    optimizer = optimizer or default_optimizer

    def fit_transport(key, particles, log_weights, beta, beta_next):
        del key, beta
        flow, _ = _fit(log_base, log_target, optimizer, nsteps, particles,
                       log_weights, beta_next, template_fn(particles),
                       axis=axis)
        return flow

    return fit_transport
