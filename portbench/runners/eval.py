"""Evaluating a flow: forward and per-row ladj of the stack over the data
set, one ``ops.fused_coupling_forward_and_ladj`` call a batch under
``torch.no_grad()``, the batches in turn.

The check compares y and ladj of a sample of the window's calls, drawn
from the seed, and of its last call, with the reference in float64 on the
same rows.
"""
from __future__ import annotations

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
        self.B = self.tr["batch_rows"]
        self.nb = self.tr["dataset_rows"] // self.B
        # Which calls are compared: a few early ones drawn from the seed,
        # and the last (kept as the window runs).
        rng = np.random.default_rng(inputs.stream_seed(run.seed, "pick"))
        self.picked = set(int(i) for i in rng.choice(
            64, self.tr["checked_calls"] - 1, replace=False))
        self.kept = {}

    def setup(self):
        run = self.run
        self.X = inputs.dataset(self.cfg, self.tr, run.seed, run.device)
        self.w0 = inputs.initial_weights(self.cfg, run.seed, run.device)
        self.flow = port_stack(self.cfg, self.w0, run.control)
        self.calls = 0
        self._eval(0)        # warm the shape

    def _eval(self, b: int):
        with torch.no_grad():
            return et.ops.coupling.fused_coupling_forward_and_ladj(
                self.flow, self.X[b * self.B:(b + 1) * self.B])

    def unit(self) -> int:
        b = self.calls % self.nb
        out = self._eval(b)
        if self.calls in self.picked:
            self.kept[self.calls] = (b, out)
        self.last = (b, out)
        self.calls += 1
        return self.B

    def window_info(self, units: int) -> dict:
        return dict(steps=units, rows_per_step=self.B,
                    flops=forward_flops_per_row(self.cfg) * self.B * units)

    def release(self):
        self.compared = [(b, y.double().cpu(), l.double().cpu())
                         for b, (y, l) in [*self.kept.values(), self.last]]
        self.flow = self.last = self.kept = None

    def check(self):
        with ref.tf32_off():
            return self._follow()

    def _follow(self):
        w = [[(W.double(), b.double()) for W, b in layers]
             for layers in self.w0]
        y_gap = ladj_gap = 0.0
        for b, y, l in self.compared:
            with torch.no_grad():
                ry, rl = ref.forward_and_ladj(
                    self.cfg, w, self.X[b * self.B:(b + 1) * self.B].double())
            y_gap = max(y_gap, rel_max(y, ry.cpu()))
            ladj_gap = max(ladj_gap, rel_max(l, rl.cpu()))
        self.X = None
        return [self.run.check("y_gap", y_gap),
                self.run.check("ladj_gap", ladj_gap)], 0
