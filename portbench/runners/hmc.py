"""HMC over a flow-defined target: ``mcmc.FlowPushforwardTarget`` with the
stack as its transport, every chain moved by one ``mcmc.hmc_kernel`` call a
transition (identity mass, the cell's fixed step size, the traffic's number
of leapfrog steps).

The chains start at T(Z), Z ~ N(0, I) drawn from the seed, pushed through
the stack by the reference. Set-up runs one transition, which captures the
density's CUDA graph. The program's state after a transition is the start
of the next, so the check follows it transition by transition from the
program's own state: for the first, a drawn and the last transition of the
window it replays the same momenta and uniforms (the generator's state was
kept) through the reference in float64, and compares the log density and
its gradient at the start, the accept decisions that the reference does
not find within ``decision_margin`` of their uniform, and the positions
after the transition where those decisions agree.
"""
from __future__ import annotations

import sys

import enflows_tpu_torch as et
import numpy as np
import torch

from .. import inputs
from ..compare import rel_max
from ..reference import stack as ref
from ..yardstick import forward_flops_per_row
from .stack import port_stack


class Runner:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.cfg, run.traffic
        self.n, self.L = self.tr["chains"], self.tr["num_steps"]
        self.step_size = float(run.params["step_size"])

    def setup(self):
        run, d = self.run, self.cfg["dim"]
        self.w0 = inputs.initial_weights(self.cfg, run.seed, run.device)
        flow = port_stack(self.cfg, self.w0, run.control)
        target = et.mcmc.FlowPushforwardTarget(flow)
        self.kernel = et.mcmc.hmc_kernel(target, num_steps=self.L)
        with ref.tf32_off(), torch.no_grad():
            q0, _ = ref.forward_and_ladj(
                self.cfg, self.w0, inputs.base_draws(self.n, d, run.seed,
                                                     run.device))
        self.gen = inputs.generator(run.seed, "sampler", run.device)
        self.inv_mass = torch.ones(d, device=run.device)
        self.state = et.mcmc.init_state(target, q0)
        self.records = []
        self.unit()          # captures the density's graph
        self.records = []

    def unit(self) -> int:
        before = self.gen.get_state()
        state, info = self.kernel(self.gen, self.state, self.step_size,
                                  self.inv_mass)
        self.records.append((before, self.state, info.accepted))
        self.state = state
        return self.n * self.L

    def window_info(self, units: int) -> dict:
        # A leapfrog step evaluates the density and its gradient in x: the
        # stack's products twice over.
        steps = units * self.L
        return dict(steps=steps, rows_per_step=self.n,
                    flops=2 * forward_flops_per_row(self.cfg) * self.n
                    * steps)

    def release(self):
        k = len(self.records)
        rng = np.random.default_rng(inputs.stream_seed(self.run.seed, "pick"))
        want = sorted({0, k - 1, int(rng.integers(0, k))})
        after = [r[1].q for r in self.records[1:]] + [self.state.q]
        acc = torch.stack([r[2] for r in self.records]).float().mean()
        print(f"hmc: step size {self.step_size}, acceptance "
              f"{float(acc):.4f} over {k} transitions", file=sys.stderr)
        self.kept = [(self.records[i][0], self.records[i][1].q,
                      self.records[i][1].logp, self.records[i][1].grad,
                      self.records[i][2], after[i]) for i in want]
        self.records = self.state = self.kernel = None

    def check(self):
        with ref.tf32_off():
            return self._follow()

    def _follow(self):
        w = [[(W.double(), b.double()) for W, b in layers]
             for layers in self.w0]
        margin = self.tr["decision_margin"]
        logp_gap = grad_gap = q_gap = 0.0
        flips = 0
        g = torch.Generator(device=self.run.device)
        for gen_state, q, logp, grad, accepted, q_after in self.kept:
            g.set_state(gen_state)
            p = torch.randn(q.shape, generator=g, dtype=q.dtype,
                            device=q.device)
            u = torch.rand(q.shape[:1], generator=g, dtype=q.dtype,
                           device=q.device)
            r = ref.hmc_transition(self.cfg, w, q.double(), p.double(),
                                   u.double(), self.step_size, self.L)
            logp_gap = max(logp_gap, rel_max(logp, r["logp"]))
            grad_gap = max(grad_gap, rel_max(grad, r["grad"]))
            clear = (u.double() - r["accept_prob"]).abs() > margin
            flips += int((clear & (accepted != r["accepted"])).sum())
            same = clear & (accepted == r["accepted"])
            if bool(same.any()):
                q_gap = max(q_gap, rel_max(q_after[same], r["q"][same]))
        return [self.run.check("logp_gap", logp_gap),
                self.run.check("grad_gap", grad_gap),
                self.run.check("decision_flips", float(flips)),
                self.run.check("q_gap", q_gap)], 0
