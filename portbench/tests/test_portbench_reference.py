"""The reference against the program's plain path at a small size, in
float64 on the CPU: the stack's forward, ladj and inverse, the whitening
loss and its gradients, Adam, and an HMC transition."""
import json
from pathlib import Path

import enflows_tpu_torch as et
import pytest
import torch

from portbench import inputs
from portbench.runners.stack import leaves, port_stack
from portbench.reference import stack as ref

CONF = Path(__file__).resolve().parents[1] / "configs"


def _small(name):
    cfg = json.loads((CONF / f"{name}.json").read_text())
    cfg.update(dim=8, hidden=[16, 12], last_layer_perturbation=0.3)
    return cfg


def _setup(name, seed=3):
    cfg = _small(name)
    w = inputs.initial_weights(cfg, seed, "cpu")
    w = [[(W.double(), b.double()) for W, b in layers] for layers in w]
    flow = port_stack(cfg, w).double()
    x = 1.5 * torch.randn(64, cfg["dim"], generator=torch.Generator()
                          .manual_seed(seed), dtype=torch.float64)
    return cfg, w, flow, x


@pytest.mark.parametrize("name", ["coupling_affine_d64",
                                  "coupling_spline_d64"])
def test_forward_ladj_loss_grads(name):
    cfg, w, flow, x = _setup(name)
    y, l = flow.forward_and_ladj(x)
    ry, rl = ref.forward_and_ladj(cfg, w, x)
    torch.testing.assert_close(ry, y, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rl, l, rtol=1e-12, atol=1e-12)
    loss = et.mvnormal_negll(flow, x)
    grads = torch.autograd.grad(loss, list(flow.parameters()))
    rloss, rgrads = ref.negll_and_grads(cfg, w, x, block_rows=24)
    torch.testing.assert_close(rloss, loss.detach(), rtol=1e-12, atol=1e-12)
    for g, rg in zip(grads, rgrads):
        # float64 sums in another order; the spline's bin search and
        # softmax differ in the last digits
        torch.testing.assert_close(rg, g, rtol=1e-8, atol=1e-10)


def test_inverse_and_adam():
    cfg, w, flow, x = _setup("coupling_affine_d64")
    z, l = et.invert(flow).forward_and_ladj(x)
    rz, rl = ref.inverse_and_ladj(cfg, w, x)
    torch.testing.assert_close(rz, z, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rl, l, rtol=1e-12, atol=1e-12)
    params = list(flow.parameters())
    opt = torch.optim.Adam(params, lr=1e-3)
    mine = ref.Adam(leaves(w), 1e-3, (0.9, 0.999), 1e-8)
    for _ in range(3):
        loss = et.mvnormal_negll(flow, x)
        gs = torch.autograd.grad(loss, params)
        for p, g in zip(params, gs):
            p.grad = g
        opt.step()
        _, rgs = ref.negll_and_grads(cfg, w, x)
        mine.step(rgs)
    for p, t in zip(params, leaves(w)):
        torch.testing.assert_close(t, p.detach(), rtol=1e-9, atol=1e-12)


def test_hmc_transition():
    cfg, w, flow, x = _setup("coupling_affine_d64")
    target = et.mcmc.FlowPushforwardTarget(flow)
    g = torch.Generator().manual_seed(5)
    p = torch.randn(x.shape, generator=g, dtype=torch.float64)
    u = torch.rand(x.shape[:1], generator=g, dtype=torch.float64)
    state = et.mcmc.init_state(target, x)
    vg = lambda q: et.mcmc.hmc.value_and_grad(target, q)
    new, info = et.mcmc.hmc_transition(vg, state, 0.2, torch.ones(8,
                                       dtype=torch.float64), 8, p, u)
    r = ref.hmc_transition(cfg, w, x, p, u, 0.2, 8)
    torch.testing.assert_close(r["logp"], state.logp, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r["grad"], state.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r["accept_prob"], info.accept_prob,
                               rtol=1e-10, atol=1e-12)
    assert bool((r["accepted"] == info.accepted).all())
    torch.testing.assert_close(r["q"], new.q, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("allow", [True, False])
def test_reference_leaves_the_tf32_flags_as_the_program_set_them(allow):
    """The reference turns TF32 off for its own products only: a run of a
    cell leaves the process's flags, which the program's timed path reads,
    as they were."""
    from portbench import harness
    from portbench.tests.test_portbench_faults import SEED, SMALL
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    was = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = allow
        with ref.tf32_off():
            assert not any(f.allow_tf32 for f in flags)
        assert all(f.allow_tf32 == allow for f in flags)
        r = harness.run_cell("coupling_affine_d64.hmc", SEED, 0.2, False,
                             "cpu", overrides=SMALL)
        assert r["correct"]
        assert all(f.allow_tf32 == allow for f in flags)
    finally:
        for f, w in zip(flags, was):
            f.allow_tf32 = w
