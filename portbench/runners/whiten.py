"""Maximum-likelihood whitening with Adam, as a user chunks a long fit:
repeated calls of ``optimize_whitening``, each over the next chunk of the
data set and resumed from the last call's flow and optimizer state.

Set-up makes the data set and the initial weights from the seed and drives
the fit through its first three steps with the window's own call (one
call of one step, one of two), then runs one chunk, which warms every
shape. The window's calls continue from that state.

The check follows those three steps with the reference in float64 from
the initial weights: each step's loss, the first gradient as Adam holds it
after one step (each leaf's norm, and the norm of each leaf's difference),
and each leaf's change after three steps. It then follows three of the
window's own chunks, the first, one drawn from the seed and the last, step
by step from the program's own state. A hook before each of Adam's steps
records the parameters and the gradients it is given, into buffers made in
set-up; at each step the reference works out the loss at the program's
parameters, at the chunk's first and last steps the gradient too, and
Adam's update from the program's moments and gradients. Over many steps a
float32 fit and a float64 one part ways (Adam's normalised steps amplify
round-off), so a chunk is not replayed from its start alone.
"""
from __future__ import annotations

import math
import statistics
import sys
import time

import enflows_tpu_torch as et
import numpy as np
import torch

from .. import inputs
from ..compare import leaf_diff_gaps, leaf_gaps, rel_max
from ..reference import stack as ref
from ..yardstick import forward_flops_per_row
from .stack import leaves, nest, port_stack

SETUP_STEPS = 3     # the first steps, followed from the initial weights


# Chunks recorded at once: the first, the drawn and the last one that the
# check follows, and the one being run.
TAPES = 4


class Tape:
    """One chunk as the program ran it: Adam's state at its start and,
    before each step, the parameters and the gradients Adam is given, copied
    into buffers made in set-up by foreach copies, so that recording adds
    no allocation and few launches to the window."""

    def __init__(self, params, steps):
        zeros = lambda: [torch.zeros_like(p) for p in params]
        self.m, self.v = zeros(), zeros()
        self.params = [zeros() for _ in range(steps)]
        self.grads = [zeros() for _ in range(steps)]

    @torch.no_grad()
    def start(self, opt_state) -> "Tape":
        state = opt_state["state"]
        if len(state) < len(self.m):    # a leaf that Adam has not stepped
            torch._foreach_zero_(self.m)
            torch._foreach_zero_(self.v)
        self.step = self.steps = 0
        if state:
            keys = sorted(state)
            torch._foreach_copy_([self.m[i] for i in keys],
                                 [state[i]["exp_avg"] for i in keys])
            torch._foreach_copy_([self.v[i] for i in keys],
                                 [state[i]["exp_avg_sq"] for i in keys])
            self.step = int(state[keys[0]]["step"])   # one count for all
        return self

    @torch.no_grad()
    def record(self, params):
        if self.steps < len(self.params):
            torch._foreach_copy_(self.params[self.steps], params)
            torch._foreach_copy_(self.grads[self.steps],
                                 [p.grad if p.grad is not None
                                  else torch.zeros_like(p) for p in params])
        self.steps += 1


class Runner:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.cfg, run.traffic
        self.B = self.tr["batch_rows"]
        self.nb = self.tr["dataset_rows"] // self.B
        self.tape = None    # the tape Adam's steps are recorded on

        def adam(params):
            opt = torch.optim.Adam(params, lr=self.tr["optimizer"]["lr"],
                                   betas=tuple(self.tr["optimizer"]["betas"]),
                                   eps=self.tr["optimizer"]["eps"])
            opt.register_step_pre_hook(self._before_step)
            return opt
        self.adam = adam
        # Draws which of the window's chunks after its first is followed.
        self.rng = np.random.default_rng(inputs.stream_seed(run.seed,
                                                            "pick"))

    def _before_step(self, opt, args, kwargs):
        if self.tape is not None:
            self.tape.record(opt.param_groups[0]["params"])

    def _call(self, b0: int, nbatches: int, flow, opt_state):
        X = self.X[b0 * self.B:(b0 + nbatches) * self.B]
        return et.train.whitening.optimize_whitening(
            X, flow, self.adam, nbatches=nbatches, nepochs=1,
            opt_state=opt_state)

    def setup(self):
        run = self.run
        marks = [time.perf_counter()]

        def mark():
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            marks.append(time.perf_counter())
        self.X = inputs.dataset(self.cfg, self.tr, run.seed, run.device)
        self.w0 = inputs.initial_weights(self.cfg, run.seed, run.device)
        flow = port_stack(self.cfg, self.w0, run.control)
        mark()
        dynamo = "torch._dynamo" in sys.modules
        r1 = self._call(0, 1, flow, None)
        mark()
        beta1 = self.tr["optimizer"]["betas"][0]
        state = r1.optimizer_state["state"]
        # A step that left Adam's state empty reads as a zero gradient.
        g1 = [state[i]["exp_avg"] / (1.0 - beta1) if i in state
              else torch.zeros_like(w) for i, w in enumerate(leaves(self.w0))]
        r2 = self._call(1, SETUP_STEPS - 1, r1.result, r1.optimizer_state)
        change = [(p.detach() - w).norm() for p, w in
                  zip(r2.result.parameters(), leaves(self.w0))]
        self.seen = dict(
            loss=torch.cat([r1.negll_history, r2.negll_history]),
            grad=torch.stack([g.norm() for g in g1]),
            change=torch.stack(change))
        self.g1 = [g.clone() for g in g1]
        self.flow, self.opt_state = r2.result, r2.optimizer_state
        self.cursor = SETUP_STEPS
        mark()
        self._chunk()       # the window's chunk, once
        mark()
        d = [b - a for a, b in zip(marks, marks[1:])]
        print(f"whiten set-up: data and weights {d[0]:.3f} s, the first "
              f"step {d[1]:.3f} s (torch._dynamo "
              f"{'already loaded' if dynamo else 'loaded by it'}), the next "
              f"two {d[2]:.3f} s, a chunk {d[3]:.3f} s", file=sys.stderr)
        self.chunks = 0     # the window's chunks so far
        self.history = []
        self.first = self.drawn = self.last = None
        params = list(self.flow.parameters())
        self.tapes = [Tape(params, self.tr["chunk_batches"])
                      for _ in range(TAPES)]

    def _chunk(self):
        c = self.tr["chunk_batches"]
        if self.cursor + c > self.nb:
            self.cursor = 0
        b0 = self.cursor
        res = self._call(b0, c, self.flow, self.opt_state)
        self.flow, self.opt_state = res.result, res.optimizer_state
        self.cursor += c
        return b0, res.negll_history

    def unit(self) -> int:
        held = {id(r["tape"]) for r in (self.first, self.drawn, self.last)
                if r is not None}
        self.tape = next(t for t in self.tapes
                         if id(t) not in held).start(self.opt_state)
        b0, loss = self._chunk()
        rec = dict(b0=b0, tape=self.tape, loss=loss, after=self.flow)
        self.tape = None
        self.chunks += 1
        if self.chunks == 1:
            self.first = rec
        elif self.rng.random() * (self.chunks - 1) < 1.0:
            self.drawn = rec    # each later chunk alike likely to stay
        self.last = rec
        self.history.append(loss)
        return self.tr["chunk_batches"] * self.B

    def window_info(self, units: int) -> dict:
        steps = units * self.tr["chunk_batches"]
        return dict(steps=steps, rows_per_step=self.B,
                    flops=3 * forward_flops_per_row(self.cfg) * self.B
                    * steps)

    def release(self):
        hist = torch.cat(self.history) if self.history else torch.zeros(0)
        self.nonfinite = int((~torch.isfinite(hist)).sum())
        self.followed = list({id(r): r for r in
                              (self.first, self.drawn, self.last)
                              if r is not None}.values())
        self.seen = {k: v.double().cpu() for k, v in self.seen.items()}
        self.g1 = [g.double().cpu() for g in self.g1]
        self.flow = self.opt_state = self.history = self.tapes = None
        self.first = self.drawn = self.last = None

    def check(self):
        with ref.tf32_off():
            steps = self._follow_setup()
            window = [self._follow_chunk(rec) for rec in self.followed]
        self.X = self.followed = None
        loss, grad, diff, moved = steps
        print(f"whiten: worst leaf (coupling.layer.W|b) of the first "
              f"gradient {self._leaf(grad)}, of its difference "
              f"{self._leaf(diff)}, of the change {self._leaf(moved)}; "
              f"median leaf {float(grad.median()):.3e} / "
              f"{float(diff.median()):.3e} / {float(moved.median()):.3e}",
              file=sys.stderr)
        worst = lambda i: max(r[i] for r in window)
        # The median of all the checked steps: a fault that lasts from the
        # drawn chunk on moves it to 1, round-off alone does not.
        grad_noise = statistics.median(m for r in window for m in r[2])
        return [
            self.run.check("loss_gap", loss),
            self.run.check("grad_gap", float(grad.max())),
            self.run.check("grad_diff", float(diff.max())),
            self.run.check("change_gap", float(moved.max())),
            self.run.check("window_loss_gap", worst(1)),
            self.run.check("window_grad_noise", grad_noise),
            self.run.check("window_update_diff", worst(3)),
        ], self.nonfinite

    def _follow_setup(self):
        """The first three steps from the initial weights."""
        w = [[(W.double(), b.double()) for W, b in layers]
             for layers in self.w0]
        flat = leaves(w)
        start = [t.clone() for t in flat]
        opt = self.tr["optimizer"]
        adam = ref.Adam(flat, opt["lr"], opt["betas"], opt["eps"])
        losses = []
        for k in range(SETUP_STEPS):
            x = self.X[k * self.B:(k + 1) * self.B].double()
            loss, grads = ref.negll_and_grads(self.cfg, w, x)
            losses.append(loss)
            if k == 0:
                ref_g1 = [g.cpu() for g in grads]
                g1 = torch.stack([g.norm() for g in ref_g1])
            adam.step(grads)
        change = torch.stack([(t - s).norm() for t, s in
                              zip(flat, start)]).cpu()
        losses = torch.stack(losses).cpu()
        seen = self.seen
        for k, gap in enumerate(((seen["loss"] - losses).abs()
                                 / losses.abs()).tolist()):
            print(f"whiten: set-up step {k + 1} loss gap {gap:.3e}",
                  file=sys.stderr)
        return (rel_max(seen["loss"], losses),
                leaf_gaps(seen["grad"], g1, g1),
                leaf_diff_gaps(self.g1, ref_g1, g1),
                leaf_gaps(seen["change"], change, g1))

    def _follow_chunk(self, rec):
        """One of the window's chunks, step by step from the program's own
        parameters. Each step's loss gap over the size of the terms the
        loss sums (``ref.negll_and_scale``), the chunk's median step; at
        the chunk's first and last steps, the median leaf's gradient gap
        over the batch's sampling noise in that leaf (a half batch reads
        1); and the worst leaf's gap of any step's update by Adam from the
        program's moments and gradients. Medians and the noise scale, since
        late in the fit the gradient is small beside its round-off and the
        worst leaf or step swings from seed to seed (PERF.md)."""
        tape, c = rec["tape"], self.tr["chunk_batches"]
        if tape.steps != c:     # Adam stepped other than once a batch
            return rec["b0"], math.inf, [math.inf], math.inf
        opt = self.tr["optimizer"]
        f64 = lambda ts: [t.double() for t in ts]
        adam = ref.Adam(None, opt["lr"], opt["betas"], opt["eps"],
                        state=(tape.step, f64(tape.m), f64(tape.v)))
        seen = rec["loss"].double().cpu()
        after = [p.detach() for p in rec["after"].parameters()]
        losses, grads_at, updates = [], [], []
        for k in range(c):
            p = f64(tape.params[k])
            w = nest(p, self.cfg)
            x = self.X[(rec["b0"] + k) * self.B:
                       (rec["b0"] + k + 1) * self.B].double()
            loss, scale = ref.negll_and_scale(self.cfg, w, x)
            losses.append(abs(float(seen[k]) - float(loss)) / float(scale))
            if k in (0, c - 1):
                _, grads, noise = ref.negll_and_grads(self.cfg, w, x,
                                                      spread=True)
                gaps = torch.stack([(g.double() - r).norm() / e for g, r, e
                                    in zip(tape.grads[k], grads, noise)])
                grads_at.append((float(gaps.median()), float(gaps.max())))
            adam.leaves = [t.clone() for t in p]
            adam.step(f64(tape.grads[k]))
            want = [a - b for a, b in zip(adam.leaves, p)]
            got = [a.double() - b for a, b in
                   zip(tape.params[k + 1] if k + 1 < c else after, p)]
            norms = torch.stack([u.norm() for u in want]).cpu()
            updates.append(float(leaf_diff_gaps(got, want, norms).max()))
        if not bool(torch.isfinite(seen).all()):
            losses = [math.inf]
        print(f"whiten: chunk from batch {rec['b0']}: loss gap over its "
              f"terms by step {['%.2e' % v for v in losses]}; gradient gap "
              f"median / worst leaf {['%.2e / %.2e' % g for g in grads_at]};"
              f" update gap worst leaf {max(updates):.2e}", file=sys.stderr)
        return (rec["b0"], statistics.median(losses),
                [m for m, _ in grads_at], max(updates))

    def _leaf(self, gaps) -> str:
        i = int(gaps.argmax())
        per = 2 * (len(self.cfg["hidden"]) + 1)
        return (f"{i // per}.{i % per // 2}.{'Wb'[i % 2]} "
                f"{float(gaps[i]):.3e}")
