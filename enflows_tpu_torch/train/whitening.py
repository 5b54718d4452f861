"""Maximum-likelihood whitening trainer: fit a flow so f(X) ~ N(0, I).

PyTorch counterpart of ``enflows_tpu/train/whitening.py``. The loss is the
per-sample mean negative log-likelihood under the change of variables,

    negll = -( sum(std_normal_logpdf(f(X))) + sum(ladj) ) / nsamples

and each step is (loss, grad, optimizer update, canonicalize). Where the
JAX trainer runs the epoch x batch loop as a ``lax.scan`` inside ``jit``,
this one runs an eager Python loop. On a CUDA batch with a fusible
elementwise chain each step's loss and gradient come from one launch of the
fused kernel B3 (``ops.elementwise.fused_negll_value_and_grad``); with a
fusible coupling stack, from the fused coupling forward B4 and its backward
B5 (``ops.coupling.fused_coupling_forward_and_ladj``).
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Callable, NamedTuple

import torch

from ..bijectors.base import Bijector
from ..distributions.base import std_normal_logpdf, std_normal_logpdf_sum
from ..ops.coupling import (coupling_batch_held,
                            fused_coupling_forward_and_ladj,
                            is_fusible_coupling_stack)
from ..ops.elementwise import (_grads_by_name, fused_forward_and_ladj,
                               fused_negll_value_and_grad, is_fusible_chain)
from ..utils.profiling import annotate
from ..utils.resilience import run_chunked


def mvnormal_negll(flow: Bijector, X: torch.Tensor) -> torch.Tensor:
    """Per-sample mean negative log-likelihood, X (..., n, dim)
    (``enflows_tpu/train/whitening.py:35-46``)."""
    Y, ladj = flow.forward_and_ladj(X)
    n = X.numel() // X.shape[-1]
    return -(std_normal_logpdf_sum(Y).sum() + ladj.sum()) / n


def mvnormal_negll_fused(flow: Bijector, X: torch.Tensor) -> torch.Tensor:
    """negll through the fused forward (B1, with B2 as its backward) on an
    (n, dim) batch; same value as ``mvnormal_negll``. Counterpart of
    ``mvnormal_negll_packed`` (``enflows_tpu/train/whitening.py:49-60``)."""
    y, ladj = fused_forward_and_ladj(flow, X)
    return -(std_normal_logpdf(y).sum() + ladj.sum()) / X.shape[0]


def mvnormal_negll_coupling(flow: Bijector, X: torch.Tensor) -> torch.Tensor:
    """negll through the fused coupling-stack forward (B4, with B5 as its
    backward) on an (n, dim) batch; same value as ``mvnormal_negll``
    (``enflows_tpu/train/whitening.py:63-74``). ``physical_order=True`` is
    sound here: the isotropic base logpdf and the per-sample ladj do not
    depend on the kernel's lane order."""
    y, ladj = fused_coupling_forward_and_ladj(flow, X, physical_order=True)
    return -(std_normal_logpdf_sum(y).sum() + ladj.sum()) / X.shape[0]


def mvnormal_negll_grad(flow: Bijector, X: torch.Tensor,
                        loss_fn: Callable = mvnormal_negll):
    """(negll, {parameter name: gradient}) by autograd over ``loss_fn``
    (``enflows_tpu/train/whitening.py:77-79``)."""
    with torch.enable_grad():
        negll = loss_fn(flow, X)
        grads = _grads_by_name(flow, [negll])
    return negll.detach(), grads


class WhiteningResult(NamedTuple):
    """``enflows_tpu/train/whitening.py:82``. ``result`` is the trained flow
    (a copy of the module passed in); ``optimizer_state`` the optimizer's
    ``state_dict()``."""
    result: Bijector
    optimizer_state: Any
    negll_history: torch.Tensor


def default_optimizer(params) -> torch.optim.Optimizer:
    """The counterpart of ``optax.adagrad(0.1)``
    (``enflows_tpu/train/whitening.py:155``): the same learning rate and
    initial accumulator. torch adds its eps outside the square root
    (g / (sqrt(acc) + 1e-10)), optax inside (g * rsqrt(acc + 1e-7)); with
    acc >= 0.1 the two updates differ by at most 5e-7 relative per step."""
    return torch.optim.Adagrad(params, lr=0.1, initial_accumulator_value=0.1)


def make_train_step(optimizer: torch.optim.Optimizer,
                    value_and_grad: Callable = mvnormal_negll_grad):
    """One (loss, grad, update, canonicalize) step
    (``enflows_tpu/train/whitening.py:88-113``).

    ``optimizer`` runs over the flow's ``parameters()``; ``value_and_grad``
    maps (flow, X) to (negll, {parameter name: gradient}). The step updates
    the flow in place and returns the detached negll."""

    def step(flow: Bijector, X: torch.Tensor) -> torch.Tensor:
        negll, grads = value_and_grad(flow, X)
        for name, p in flow.named_parameters():
            p.grad = grads[name]
        optimizer.step()
        flow.canonicalize()
        return negll

    return step


def averaged(value_and_grad: Callable, axis, mean: bool = True) -> Callable:
    """``value_and_grad`` with the loss and every gradient averaged (summed,
    ``mean=False``) over the ranks of ``axis`` (a ``parallel`` mesh axis)
    in one all-reduce: the data-parallel step's consensus, after which
    every rank's update is the same."""
    from ..parallel.collectives import psum_flat

    def reduced(flow, X):
        value, grads = value_and_grad(flow, X)
        names = [k for k, g in grads.items() if g is not None]
        out = psum_flat([value] + [grads[k] for k in names], axis, mean=mean)
        return out[0], {**grads, **dict(zip(names, out[1:]))}

    return reduced


def _dispatch(flow: Bijector, dim: int, dtype, on_card: bool,
              batch_size: int):
    """``optimize_whitening``'s ``use_fused=None`` rule: True (B3) for a
    fusible elementwise chain on the card, "coupling" (B4 + B5) for a
    fusible coupling stack on the card where the kernels are held
    (``ops.coupling.coupling_batch_held``: at least ``COUPLING_MIN_ROWS``
    rows and ``COUPLING_MIN_DIM`` wide), else False."""
    if not on_card:
        return False
    if is_fusible_chain(flow, dim, dtype):
        return True
    if is_fusible_coupling_stack(flow, dim, dtype) and \
            coupling_batch_held(batch_size, dim):
        return "coupling"
    return False


def optimize_whitening(
    samples: torch.Tensor,
    initial_flow: Bijector,
    optimizer: Callable[..., torch.optim.Optimizer] | None = None,
    *,
    nbatches: int = 100,
    nepochs: int = 100,
    opt_state: dict | None = None,
    negll_history: torch.Tensor | None = None,
    use_fused: bool | str | None = None,
    mesh=None,
    batch_axis: str = "batch",
    metrics=None,
    checkpoint_every: int | None = None,
    ckpt_dir: str | None = None,
) -> WhiteningResult:
    """Fit ``initial_flow`` so that it whitens ``samples`` (n, dim)
    (``enflows_tpu/train/whitening.py:116-330``).

    The n samples are split into ``nbatches`` equal batches, the remainder
    dropped; the loop runs nepochs x nbatches steps. A copy of the flow
    (``copy.deepcopy``) is trained and returned as ``result``;
    ``initial_flow`` is left as given, as the JAX trainer returns a new flow
    (``enflows_tpu/train/whitening.py:326-330``). To resume, pass the
    previous ``result`` with its ``optimizer_state``.

    ``optimizer``: a factory ``params -> torch.optim.Optimizer``, by default
    ``default_optimizer`` (optax.adagrad(0.1)'s counterpart). Resumable:
    pass a previous result's ``optimizer_state`` (a ``state_dict()``) as
    ``opt_state`` and its ``negll_history``, which is spliced in front.

    ``use_fused``: None dispatches by rule (``_dispatch``): a CUDA batch
    with a fusible elementwise chain (``is_fusible_chain``) takes the fused
    kernel B3 every step, a CUDA batch with a fusible coupling stack
    (``is_fusible_coupling_stack``) where the kernels are held
    (``coupling_batch_held``) B4 and B5 every step
    (``enflows_tpu/train/whitening.py:178-206``, with the port's row rule
    in place of the TPU's batch-size thresholds, which were measured on a
    v5e); a CPU batch, a coupling batch the rule keeps from the kernels, or
    a chain neither kernel takes, the plain autograd path. False forces the
    plain path; True requires a fusible elementwise chain and "coupling" a
    fusible coupling stack (on a CPU batch either fused wrapper runs its
    plain version).

    ``metrics`` (a ``utils.MetricsLogger``): one record a step, ``{"step":
    e * nbatches + b, "negll"}``, its value read when the logger writes.

    ``checkpoint_every`` (epochs) with ``ckpt_dir``: the epochs run in
    chunks of ``checkpoint_every`` through ``utils.run_chunked``, which
    saves the flow's ``state_dict()``, the optimizer state and the history
    so far at every chunk's end; a killed run called again the same way
    resumes from the last chunk and ends bit-identical to an uninterrupted
    one (whitening draws nothing). A chunked run takes the same steps as an
    unchunked one, bit for bit.

    ``mesh`` (a ``parallel.Mesh``) with ``batch_axis``: data-parallel
    training (``enflows_tpu/train/whitening.py:160-291``). Every rank
    passes the same ``samples``; each batch must divide over the axis, and
    each rank runs the step on its contiguous block of every batch (B3, or
    B4 + B5, on the card by the rule above applied to the rank's rows),
    then the loss and the gradients are averaged over the ranks in one
    all-reduce and every rank runs the same optimizer update, so the flow,
    the optimizer state and the history stay replicated. The metrics get
    one record a step on each rank.
    """
    n, dim = samples.shape
    batch_size = n // nbatches
    batches = samples[:batch_size * nbatches].reshape(
        nbatches, batch_size, dim)
    rows = batch_size
    if mesh is not None:
        from ..parallel.mesh import block_range
        lo, hi = block_range(batch_size, mesh.axis(batch_axis))
        batches, rows = batches[:, lo:hi], hi - lo
    batches = batches.contiguous()

    if use_fused is None:
        use_fused = _dispatch(initial_flow, dim, samples.dtype,
                              samples.is_cuda, rows)
    elif use_fused == "coupling":
        if not is_fusible_coupling_stack(initial_flow, dim, samples.dtype):
            raise ValueError('use_fused="coupling" needs a fusible coupling '
                             'stack (see is_fusible_coupling_stack)')
    elif use_fused and not is_fusible_chain(initial_flow, dim,
                                            samples.dtype):
        raise ValueError("use_fused=True needs a fusible chain "
                         "(see is_fusible_chain)")

    flow = copy.deepcopy(initial_flow)
    opt = (optimizer or default_optimizer)(list(flow.parameters()))
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    value_and_grad = {False: mvnormal_negll_grad,
                      True: fused_negll_value_and_grad,
                      "coupling": functools.partial(
                          mvnormal_negll_grad,
                          loss_fn=mvnormal_negll_coupling)}[use_fused]
    if mesh is not None:
        value_and_grad = averaged(value_and_grad, mesh.axis(batch_axis))
    step = make_train_step(opt, value_and_grad)

    def epochs(e0: int, e1: int) -> list:
        neglls = []
        for e in range(e0, e1):
            for b in range(nbatches):
                negll = step(flow, batches[b])
                if metrics is not None:
                    metrics.log(e * nbatches + b, negll=negll)
                neglls.append(negll)
        return neglls

    with annotate("enflows.train.whitening"):
        # bf16 samples: a float32 history, which holds B3's bf16 negll
        # exactly and the plain path's float32 one unrounded.
        history = run_chunked(
            epochs, flow, opt, torch.zeros(nepochs * nbatches,
                                           dtype=torch.promote_types(
                                               samples.dtype, torch.float32),
                                           device=samples.device),
            nepochs, nbatches, every=checkpoint_every, ckpt_dir=ckpt_dir)
    if negll_history is not None:
        history = torch.cat([torch.as_tensor(negll_history).to(history),
                             history])
    return WhiteningResult(flow, opt.state_dict(), history)
