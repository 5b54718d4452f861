"""Flow-based variational inference: ELBO optimization.

PyTorch counterpart of ``enflows_tpu/train/vi.py``. For base draws
xi ~ N(0, I_dim) and the transport z = f(xi),

    ELBO = mean_n [ log p~(f(xi_n)) + ladj(f, xi_n) ] + dim/2 * (log 2π + 1)

with the entropy term over the *event* dimension (``vi.py:1-17``). Where
the JAX trainer runs the steps as a ``lax.scan`` inside ``jit``, this one
runs an eager Python loop: per step fresh base draws (antithetic pairs
``[xi, -xi]`` by default), the loss and its gradient, the optimizer update
and ``canonicalize``. On a CUDA batch with a fusible coupling stack the
forward runs in kernel B4 with B5 as its backward; with a fusible
elementwise chain, in B1 with B2 as its backward.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from ..bijectors.base import Bijector
from ..ops.coupling import (coupling_batch_held,
                            fused_coupling_forward_and_ladj,
                            is_fusible_coupling_stack)
from ..ops.elementwise import (_grads_by_name, fused_forward_and_ladj,
                               is_fusible_chain)
from .whitening import default_optimizer, make_train_step

_LOG_2PI = 1.8378770664093453


def _plain_forward(flow, xi):
    """The flow's own autograd path."""
    return flow.forward_and_ladj(xi)


def _fused_coupling_forward(flow, xi):
    """The fused coupling stack (B4, with B5 as its backward), z in logical
    lane order: z feeds an arbitrary user density (``vi.py:38-41``). On a
    CPU batch the wrapper runs its plain version."""
    return fused_coupling_forward_and_ladj(flow, xi, physical_order=False)


def _neg_elbo(forward: Callable, flow: Bijector, logdensity_fn: Callable,
              xi: torch.Tensor) -> torch.Tensor:
    """``neg_elbo`` with the forward route ``forward(flow, xi) -> (z,
    ladj)`` given."""
    z, ladj = forward(flow, xi)
    n, dim = xi.shape
    elbo = (logdensity_fn(z).sum() + ladj.sum()) / n \
        + 0.5 * (_LOG_2PI + 1.0) * dim
    return -elbo


def neg_elbo(flow: Bijector, logdensity_fn: Callable, xi: torch.Tensor,
             use_fused_coupling: bool = False) -> torch.Tensor:
    """Negative ELBO of the transport ``flow`` against the unnormalized
    batched log density ``logdensity_fn`` ((n, dim) -> (n,)) on base draws
    ``xi`` (n, dim), with the corrected entropy term
    (``enflows_tpu/train/vi.py:33-55``). ``use_fused_coupling=True`` routes
    the forward through the fused coupling stack (B4, with B5 as its
    backward)."""
    return _neg_elbo(_fused_coupling_forward if use_fused_coupling
                     else _plain_forward, flow, logdensity_fn, xi)


class _Apply(nn.Module):
    """``forward(x) = fn(flow, x)``, so that ``functional_call`` can run any
    forward route of ``flow`` on substituted parameters."""

    def __init__(self, fn: Callable, flow: Bijector):
        super().__init__()
        self.fn = fn
        self.flow = flow

    def forward(self, x):
        return self.fn(self.flow, x)


def _with_stopped_parameters(fn: Callable, flow: Bijector, x):
    """``fn(flow, x)`` with every parameter of ``flow`` detached: gradients
    reach ``x`` but no parameter. The counterpart of
    ``jax.lax.stop_gradient(flow)``; the modules are not copied."""
    call = _Apply(fn, flow)
    stopped = {k: p.detach() for k, p in call.named_parameters()}
    return torch.func.functional_call(call, stopped, (x,))


def _neg_elbo_stl(forward: Callable, flow: Bijector,
                  logdensity_fn: Callable, xi: torch.Tensor) -> torch.Tensor:
    """``neg_elbo_stl`` with the forward route given; the inverse pass takes
    the same route."""
    z, _ = forward(flow, xi)
    xi_bar, ladj_inv = _with_stopped_parameters(forward, flow.inverse(), z)
    n, dim = xi.shape
    log_q = (-0.5 * (xi_bar * xi_bar).sum(-1) - 0.5 * dim * _LOG_2PI
             + ladj_inv)
    elbo = (logdensity_fn(z).sum() - log_q.sum()) / n
    return -elbo


def neg_elbo_stl(flow: Bijector, logdensity_fn: Callable, xi: torch.Tensor,
                 use_fused_coupling: bool = False) -> torch.Tensor:
    """Sticking-the-landing negative ELBO (Roeder et al. 2017;
    ``enflows_tpu/train/vi.py:58-94``): the variational density is evaluated
    through the parameter-sharing inverse with its parameters stopped,

        z = f_θ(ξ),   log q(z) = log N(g_θ̄(z)) + ladj(g_θ̄, z),

    θ̄ = θ detached, so the gradient is the path derivative alone:
    unbiased, and zero per sample at q = p. Its value differs from
    ``neg_elbo``'s by the empirical-vs-analytic base entropy. Both passes
    take the same route; the fused kernels run inverted stacks and
    inverted chains."""
    return _neg_elbo_stl(_fused_coupling_forward if use_fused_coupling
                         else _plain_forward, flow, logdensity_fn, xi)


class VIResult(NamedTuple):
    """``enflows_tpu/train/vi.py:97``. ``result`` is the trained flow (a copy
    of the module passed in); ``optimizer_state`` the optimizer's
    ``state_dict()``."""
    result: Bijector
    optimizer_state: Any
    nelbo_history: torch.Tensor


def _base_draws(generator: torch.Generator, step: int, batch_size: int,
                dim: int, dtype, device) -> torch.Tensor:
    """Step ``step``'s base draws, (batch_size, dim) standard normals from
    ``generator``. The one place the trainer draws, so that a test can hand
    it another framework's draws (JAX folds the step into its key)."""
    return torch.randn(batch_size, dim, generator=generator, dtype=dtype,
                       device=device)


def _route(flow: Bijector, dim: int, dtype, device,
           use_fused_coupling: bool | None, rows: int) -> Callable:
    """The forward route of a batch of ``rows`` rows, ``(flow, xi) -> (z,
    ladj)``: see ``optimize_elbo``."""
    if use_fused_coupling is None:
        if device.type != "cuda":
            return _plain_forward
        if is_fusible_coupling_stack(flow, dim, dtype):
            return (_fused_coupling_forward
                    if coupling_batch_held(rows, dim) else _plain_forward)
        return (fused_forward_and_ladj if is_fusible_chain(flow, dim, dtype)
                else _plain_forward)
    if use_fused_coupling:
        if not is_fusible_coupling_stack(flow, dim, dtype):
            raise ValueError("use_fused_coupling=True needs a fusible "
                             "coupling stack (see is_fusible_coupling_stack)")
        return _fused_coupling_forward
    return _plain_forward


def optimize_elbo(
    logdensity_fn: Callable,
    initial_flow: Bijector,
    optimizer: Callable[..., torch.optim.Optimizer] | None = None,
    *,
    dim: int,
    batch_size: int = 100,
    nsteps: int = 1000,
    antithetic: bool = True,
    key: torch.Generator | None = None,
    opt_state: dict | None = None,
    nelbo_history: torch.Tensor | None = None,
    mesh=None,
    batch_axis: str = "batch",
    dtype=torch.float32,
    metrics=None,
    use_fused_coupling: bool | None = None,
    stl: bool = False,
    checkpoint_every: int | None = None,
    ckpt_dir: str | None = None,
) -> VIResult:
    """Fit a flow transport to an unnormalized log density by ELBO ascent
    (``enflows_tpu/train/vi.py:103-283``).

    ``logdensity_fn``: a batched density, (n, dim) -> (n,). ``key``: the
    ``torch.Generator`` of the base draws; its device is where the draws and
    the training run. Without one, a generator seeded 0 on the card. Each
    step draws ``batch_size`` base samples (with ``antithetic``, also their
    negations, so 2 * batch_size rows) in ``dtype``.

    A copy of the flow (``copy.deepcopy``) is trained and returned as
    ``result``; ``initial_flow`` is left as given. ``optimizer``: a factory
    ``params -> torch.optim.Optimizer``, by default ``default_optimizer``
    (``optax.adagrad(0.1)``'s counterpart). To resume, pass the previous
    ``result``, its ``optimizer_state`` (a ``state_dict()``) as
    ``opt_state`` and its ``nelbo_history``, which is spliced in front.

    ``stl=True`` differentiates the sticking-the-landing estimator
    (``neg_elbo_stl``, one more inverse pass per step); the history still
    records the standard nELBO, so the two estimators' histories compare
    step for step (``vi.py:213-224``).

    ``use_fused_coupling``: None dispatches by rule, in place of the TPU's
    batch-size thresholds: on a CUDA batch a fusible coupling stack
    (``is_fusible_coupling_stack``) runs every forward in B4 with B5 as
    its backward where the kernels are held
    (``ops.coupling.coupling_batch_held``: at least ``COUPLING_MIN_ROWS``
    rows a step and ``COUPLING_MIN_DIM`` wide),
    a fusible elementwise chain (``is_fusible_chain``) in B1 with B2 as its
    backward; a CPU batch, a coupling batch the kernels are not held at, or
    any other flow takes the plain autograd path. False forces the plain
    path. True requires a fusible coupling stack and raises ``ValueError``
    otherwise (JAX's True falls back to the jnp path silently,
    ``vi.py:181-182``); on a CPU batch the fused wrapper then runs its
    plain version.

    ``mesh`` (with ``batch_axis``), ``metrics``, ``checkpoint_every`` and
    ``ckpt_dir`` are not ported yet and raise ``NotImplementedError``.
    """
    for name, value, item in (("mesh", mesh, "A.10"),
                              ("metrics", metrics, "A.11"),
                              ("checkpoint_every", checkpoint_every, "A.11"),
                              ("ckpt_dir", ckpt_dir, "A.11")):
        if value is not None:
            raise NotImplementedError(
                f"optimize_elbo({name}=...) is not ported to "
                f"enflows_tpu_torch yet (ROADMAP {item})")
    if key is None:
        key = torch.Generator(device="cuda").manual_seed(0)
    return _fit(logdensity_fn, initial_flow, optimizer, _base_draws,
                dim=dim, batch_size=batch_size, nsteps=nsteps,
                antithetic=antithetic, key=key, opt_state=opt_state,
                nelbo_history=nelbo_history, dtype=dtype,
                use_fused_coupling=use_fused_coupling, stl=stl)


def _fit(logdensity_fn, initial_flow, optimizer, draws: Callable, *, dim,
         batch_size, nsteps, antithetic, key, opt_state, nelbo_history,
         dtype, use_fused_coupling, stl) -> VIResult:
    """``optimize_elbo``'s steps, each drawing its base samples as
    ``draws(key, step, batch_size, dim, dtype, device)``."""
    device = key.device
    forward = _route(initial_flow, dim, dtype, device, use_fused_coupling,
                     batch_size * (2 if antithetic else 1))
    loss_fn = _neg_elbo_stl if stl else _neg_elbo

    def value_and_grad(flow, xi):
        with torch.enable_grad():
            nelbo = loss_fn(forward, flow, logdensity_fn, xi)
            grads = _grads_by_name(flow, [nelbo])
        return nelbo.detach(), grads

    flow = copy.deepcopy(initial_flow)
    opt = (optimizer or default_optimizer)(list(flow.parameters()))
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    step = make_train_step(opt, value_and_grad)

    history = []
    for i in range(nsteps):
        xi = draws(key, i, batch_size, dim, dtype, device)
        if antithetic:
            xi = torch.cat([xi, -xi])
        nelbo = step(flow, xi)
        if stl:
            # The standard nELBO differs from the STL value by the
            # empirical-vs-analytic base entropy, computable from xi alone.
            nb, nd = xi.shape
            mean_log_n = -0.5 * (xi * xi).sum() / nb - 0.5 * nd * _LOG_2PI
            nelbo = nelbo - mean_log_n - 0.5 * (_LOG_2PI + 1.0) * nd
        history.append(nelbo)
    history = (torch.stack(history) if history else
               torch.zeros(0, dtype=dtype, device=device))
    if nelbo_history is not None:
        history = torch.cat([torch.as_tensor(nelbo_history).to(history),
                             history])
    return VIResult(flow, opt.state_dict(), history)
