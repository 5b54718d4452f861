"""Faults planted in the program's timed path, for the check's own tests
and for reading what a fault gives on the card (``calibrate.py --fault``).
Each is a context manager that patches one function of the program and
restores it: ``planted("whiten.half")``. A ``_late`` fault leaves set-up
and the window's first chunk sound and breaks every later chunk, so that
only the check of the window's later chunks can see it."""
from __future__ import annotations

import contextlib

import enflows_tpu_torch as et
import torch

W = et.train.whitening
C = et.ops.coupling
H = et.mcmc.hmc


def _whiten_unchanged():
    def make_train_step(optimizer, value_and_grad=W.mvnormal_negll_grad):
        return lambda flow, X: value_and_grad(flow, X)[0]
    return W, "make_train_step", make_train_step


def _whiten_half():
    orig = W.mvnormal_negll_grad
    return W, "mvnormal_negll_grad", \
        lambda flow, X, **kw: orig(flow, X[:len(X) // 2], **kw)


def _whiten_altered():
    orig = W.mvnormal_negll_grad

    def altered(flow, X, **kw):
        negll, grads = orig(flow, X, **kw)
        return negll * 1.001, grads
    return W, "mvnormal_negll_grad", altered


# optimize_whitening's calls left sound by a late fault: set-up's two and
# its chunk, and the window's first chunk.
SOUND_CALLS = 4


def _late(inner: str):
    orig = W.optimize_whitening
    calls = 0

    def late(*args, **kwargs):
        nonlocal calls
        calls += 1
        if calls <= SOUND_CALLS:
            return orig(*args, **kwargs)
        with planted(inner):
            return orig(*args, **kwargs)
    return W, "optimize_whitening", late


def _eval(kind):
    orig = C.fused_coupling_forward_and_ladj

    def broken(chain, x, physical_order=False):
        y, ladj = orig(chain, x, physical_order)
        if kind == "unchanged":
            return x.clone(), torch.zeros_like(ladj)
        y, ladj = y.clone(), ladj.clone()
        if kind == "half":
            y[len(x) // 2:], ladj[len(x) // 2:] = 0, 0
        else:
            y[0, 0] += 0.01
        return y, ladj
    return C, "fused_coupling_forward_and_ladj", broken


def _hmc(kind):
    orig = H.hmc_transition

    def broken(vg, state, step_size, inv_mass, num_steps, p, u, *a):
        n = state.q.shape[0]
        if kind == "unchanged":
            no = torch.zeros(n, dtype=torch.bool, device=state.q.device)
            z = torch.zeros_like(state.logp)
            return state, H.HMCInfo(z, no, no, z, z)
        if kind == "half":
            h = n // 2
            top = H.HMCState(state.q[:h], state.logp[:h], state.grad[:h])
            new, info = orig(vg, top, step_size, inv_mass, num_steps, p[:h],
                             u[:h], *a)
            keep = lambda a, b: torch.cat([a, b[h:]])
            acc = torch.cat([info.accepted,
                             torch.zeros_like(info.accepted[:n - h])])
            return (H.HMCState(keep(new.q, state.q),
                               keep(new.logp, state.logp),
                               keep(new.grad, state.grad)),
                    info._replace(accepted=acc))
        new, info = orig(vg, state, step_size, inv_mass, num_steps, p, u, *a)
        q = new.q.clone()
        q[int(info.accepted.nonzero()[0]), 0] += 0.1
        return new._replace(q=q), info
    return H, "hmc_transition", broken


FAULTS = {
    "whiten.unchanged": _whiten_unchanged,
    "whiten.half": _whiten_half,
    "whiten.altered": _whiten_altered,
    "whiten.half_late": lambda: _late("whiten.half"),
    "whiten.altered_late": lambda: _late("whiten.altered"),
    "eval.unchanged": lambda: _eval("unchanged"),
    "eval.half": lambda: _eval("half"),
    "eval.altered": lambda: _eval("altered"),
    "hmc.unchanged": lambda: _hmc("unchanged"),
    "hmc.half": lambda: _hmc("half"),
    "hmc.altered": lambda: _hmc("altered"),
}


@contextlib.contextmanager
def planted(name: str):
    module, attr, broken = FAULTS[name]()
    orig = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, orig)
