"""Drive the PyTorch port's main paths once on one CUDA card: the
whitening slice (kernels B1-B3), the coupling-flow slice (B4, B5),
flow-VI (B1/B2 and B4/B5), flow-preconditioned HMC (B6), NUTS and ChEES
(no kernel), tempered SMC (no kernel; B1/B2 in its learned transports)
and infer's default path (the auto ladder through B1/B2 and B4/B5,
data= through B3).

Run from the repository root:  python3 chip_smoke.py

Phases, one printed line each (more for the slice); any mismatch or
exception exits non-zero and prints no result:

1. the card's ``nvidia-smi`` name and power limit, and the kernels' build
   from every source under ``enflows_tpu_torch/ops/csrc/`` (timed), with
   ptxas's registers and spills of every B1-B3 instantiation (a spill
   fails the run);
2. B1 (fused forward+ladj) against the plain version: the flagship flow at
   d=2, n=2^24 and at d=50, n=2^17;
3. B2 (its backward) against plain autograd: loss sum(sin y) + sum(ladj^2)
   at d=2, n=2^22, every gradient;
4. B3 (single-pass negll + gradient) against the plain version at d=2,
   n=2^22 and 2^20 (the slice's batch) and at d=50, n=2^17, then all three
   on a sweep of other chains and shapes (``SWEEP``) against the plain
   version in float32 and float64, and at the float32 stability corners
   (|b x| >> 88; finite values and gradients). Each B1-B3 line gives the
   launch (lanes per sample, elements per lane, blocks per SM, registers)
   and the flagship's special functions at the MUFU rate beside the byte
   bound;
5. the slice, with the launch counters set to 0 just before it: whitening
   data X = f_true(z) (n=2^22, f_true as in examples/nf_example_2d.py) with
   the 2D example's model and with the flagship flow; optimize_whitening for
   3 epochs of 4 batches (12 steps of 2^20 samples, each one B3 launch),
   then the fitted flow's full-data negll and its gradient through B1 and
   B2, and cov(f(X)). Each history is finite, falls, and matches a
   plain-path run of the same trainer on the card to 1e-4 relative (f32
   sums taken in another order). Then ``torch.profiler`` over 4 fused
   steps of each model (device time by kernel, device ops a step, the idle
   share), and Householder's plain routes timed against each other on the
   card (``phase_householder_auto``: the scan and the dense product,
   forward and backward, d in {2, 8, 50, 128}, batch 2^10-2^20, k from 1
   to d), which set ``Householder(mode="auto")``;
6. B4 (fused coupling-stack forward+ladj,
   ``enflows_tpu_torch/ops/csrc/coupling.cu``, TF32 tensor-core products)
   against a float64 plain run at the BASELINE config (d=64, 4 couplings,
   (512, 512) conditioners, n=2^17; affine, and RQ-spline with K=8 bins on
   [-5, 5]) under the TF32 gate below, inputs 2.2 N(0, 1) so that ~2% fall
   outside the spline's bound, and the round trip through B4 on
   ``stack.inverse()``; the kernel's time (and with B5's rows written, as
   in training) beside the plain version's, the TF32 and f32 FLOP bounds,
   the reckoned L2 weight reads and, as yardsticks, the same conditioner
   products alone in ``torch.matmul`` in TF32 (``library_ms``) and f32;
7. B5 (its backward) against plain autograd at the same config: loss
   sum(sin y) + sum(ladj^2), gx and every weight and bias gradient against
   a float64 plain run under the TF32 gate, on the rows that pass no spline
   knot closer than 1e-4 (``drop_near_knot_rows``), both ways B5 runs: on
   the rows B4 stored (the trainer's path) and recomputing the forward;
   both timed beside plain autograd and the TF32 bound;
8. the coupling sweep (``COUPLING_SWEEP``): B4 and B5 (both ways) on small
   chains at a few thousand rows (every activation, inverted couplings,
   interleaved ScaleShift/JohnsonInv stages, a non-involutive
   half-preserving Permute with the output in logical order, mixed
   affine+spline, (1024, 1024) conditioners, n below one tile, n not a
   multiple of 64, K and N not multiples of 8, a spline whose last slab is
   partial) against the plain version in float64 under the TF32 gate;
9. the coupling slice, for the identity-initialized BASELINE affine stack
   and then the spline stack, each with the launch counters set to 0 just
   before it: correlated non-Gaussian data at d=64, n=2^19, made on the
   card; ``optimize_whitening(X, stack, adam(1e-3), nbatches=4,
   nepochs=3)``, 12 steps of 2^17 samples, each one B4 and one B5 launch.
   The history is finite, falls, and matches a plain-path run of the same
   trainer on the card with its products in TF32, as the kernels compute
   them: every step before the first loss spike (a rise of more than 10%)
   to 1e-4 relative or 2x the plain path's own rounding noise, and all 12
   to 1e-3 or 8x that noise, whichever is larger. Each step's loss and
   gradients are sums over 2^17 samples and 512-wide products taken in
   another order, and Adam's first steps move every weight by about the
   learning rate whatever the gradient's size. At this width that throws
   the spline stack into a loss spike, after which the histories of two
   runs that differ only in rounding drift apart, the plain path against
   itself too. That noise is measured in every run: how far the plain
   path in f32, on the same batches and on their rows in two other orders,
   sits from the TF32 run. Then
   ``torch.profiler`` over 4 fused steps of each stack: device time by
   kernel and the idle share;
10. B6 (L leapfrog steps with logp_0 and logp_L in one launch,
   ``enflows_tpu_torch/ops/csrc/leapfrog.cu``) against ``leapfrog_plain`` at
   the BASELINE leapfrog config (8192 chains, d=50, L=64, the chain of
   benchmarks/bench_mcmc.py:333-338): q_L, p_L, logp_0 and logp_L each
   within 2e-4 * max|f64| + 2e-4 of the plain version run in float64, or no
   further from it than twice the float32 plain version, in the wrapper's
   geometry (G=16 lanes a chain, E=4 elements a lane) and in G=32, E=2;
   the two timed in turns, and against the plain version, with
   leapfrog-steps/s, the bound, the first version's time for reference, the
   special functions' time at 16 per clock per SM, each geometry's blocks
   per SM and registers, and ptxas's registers and spills for every B6
   instantiation (a spill fails the run);
11. the B6 sweep (``LF_SWEEP``): d in {2, 3, 5, 6, 7} with Householder
   stages (dense and by reflections), d=128 with four Householder stages
   after elementwise runs (two runs held in lane-private shared memory),
   d=300 elementwise only (column tiles), a diagonal inverse mass, a
   diagonal-Gaussian base, fewer chains than SMs, JohnsonInv at |v| up to
   88 (e^{|v|} finite in f32, e^{-|v|} flushed), under the same
   tolerance, with a check that every path of B6 ran; and the refusal of a
   Householder chain at d=129;
12. the HMC slice, with the launch counters set to 0 just before each run:
   ``infer(FlowPushforwardTarget(transport), method="hmc")`` with
   8192 chains x d=50, 200 warmup + 100 samples of L=64 on the BASELINE
   chain (exactly one B6 launch per transition), then the d=8 example of
   examples/fused_pushforward_hmc.py (256 chains, its mean/var base,
   200 + 500 transitions of L=16). Each run's draws are finite, its
   acceptance within 0.6-1.0, and its mean and sd within 0.1 (absolute /
   relative) of Monte-Carlo truth from the generative definition (200,000
   draws); min bulk ESS and max rhat are printed. After the BASELINE run,
   B6 is held to the float64 plain version as in 10 where the sampler runs
   it: from the slice's last draws, at the adapted step size and at 2/3 of
   it (the ends of the jitter range);
13. ms per transition of the fused sampler against the same sampler over
   ``leapfrog_plain`` (20 warm transitions each, host clock), and
   ``torch.profiler`` over 5 fused transitions: the card's busy time per
   transition, and its idle share against the unprofiled transition.

Flow-VI runs after 9 and before 10, every phase from generators of its
own (``phase_vi_*``), each main-path run with the launch counters set to 0
just before it and read just after:

14. B2 at d=50, n=2^17 as in 3, the shape of the VI slice;
15. ``[vi elementwise]``: ``default_flow_template(50)`` fitted by
   ``optimize_elbo`` (the default optimizer, 12 steps of 2^16 antithetic
   pairs) to a normalized d=50 target, the pushforward of N(0, I) through
   a fixed JohnsonInv -> 4-reflection Householder -> ScaleShift chain
   (``vi_target``), once with each estimator: exactly 12 B1 and 12 B2
   launches (24 each under STL); each history finite, falling, and within
   1e-4 relative of the plain path's on the same draws, or, where the
   plain path on rows reordered within each step differs from it by more,
   within the coupling slice's noise rule (``NoiseGate``);
16. ``[vi coupling affine]`` and ``[vi coupling spline]``: the coupling
   template at the BASELINE widths (ScaleShift, JohnsonInv, 4 couplings
   with (512, 512) conditioners, ScaleShift; K=8 on [-5, 5]) fitted at
   d=64 with adam(1e-3), 12 steps of 2^17 rows (the affine one also with
   STL): exactly 12 (24) B4 and 12 (24) B5 launches, the history held to
   the plain path run with TF32 products by the noise rule; then B4's and
   B5's row tiles and times (CUDA events, on B4's stored rows) on the
   template beside the bare BASELINE stack (``[vi B5 tile]``);
17. ``[vi example]``: enflows_tpu_torch/examples/nf_variational_1d.py,
   800 steps at d=1, exactly 800 B1 and 800 B2 launches, under the JAX
   test's gates (pushforward mean within 0.3 of 2.9, variance within 1.2,
   the nELBO falling by more than 1 to a last-50 mean under 0.5);

and ``[vi timing]`` / ``[vi profile]`` for each of these fits: warm
ms/step fused against plain (timed plain, fused, fused, plain on the host
clock), then ``torch.profiler`` over 4 fused steps.

NUTS and ChEES run after 13. No kernel is on their path (the JAX tree
samplers reach none either); each run sets the launch counters to 0 just
before it, reads them just after and fails if any kernel launched:

18. ``[nuts slice]`` / ``[chees slice]``: ``sample(target,
   algorithm='nuts'/'chees')`` on the HMC slice's BASELINE pushforward,
   8192 chains x d=50, 200 warmup + 100 samples: draws finite, acceptance
   within 0.6-1.0 (ChEES 0.45-0.95, tests/test_chees.py:51), mean and sd
   within 0.1 of Monte-Carlo truth; the tree depths, leaves a transition
   (the most and the mean over chains, and the lockstep's own count) and
   host reads printed, for ChEES the adapted step size, trajectory length
   and leapfrog steps an iteration;
19. ``[nuts infer]``: ``infer(logp, method='nuts'/'chees')`` on the 2-D
   example target of benchmarks/bench_mcmc.py:35-44, raw
   (``precondition=None``, 128 chains, 250 + 500: finite draws and the
   acceptance range; its moments, min bulk ESS and max rhat are printed
   but not gated, since raw chains do not cross the target's modes) and
   through its exact transport (``flow=``, 128 chains, 200 + 300: mean
   within 0.1 sd, sd within 10% of Monte-Carlo truth); then
   ``infer(target, method='nuts', precondition=None)`` on the BASELINE
   pushforward at 1024 chains, 100 + 100, through ``mcmc.sample``, with no
   B6 launch;
20. ``[nuts timing]`` / ``[chees timing]``: 20 warm transitions from the
   slice's final states at its adapted settings (host clock): ms a
   transition, a leaf (NUTS) or a leapfrog step (ChEES), gradient
   evaluations a second and host reads a transition; ``torch.profiler``
   over 5: the card's busy time, its idle share and device ops a leaf or
   step; the fused HMC transition of 13 beside them as context.

Tempered SMC runs after 20 (``smc_phases``), each main-path run with the
launch counters set to 0 just before it and read just after:

21. ``[smc slice]``: ``smc.smc_sample`` on the BASELINE 100-D bimodal
   mixture 1/2 N(1.5 1, I) + 1/2 N(-1.5 1, I) (benchmarks/bench_smc.py:
   108-117), 32,768 particles, mutation_steps=8, 10 leapfrog steps, f32,
   no transport: no kernel launch, beta reaches 1, draws finite,
   |log Z - 50 log 2 pi| < 0.5, the weighted mass with x_0 > 0 within
   [0.4, 0.6]; then the same run in float64 under the same gates;
22. ``[smc transport]``: the f32 run with the default fitter
   (``make_transport_fitter``: a ScaleShift, 100 Adam steps a temperature
   on the even half): exactly T (100 + 1) B1 and T 100 B2 launches for T
   temperatures, and the same gates;
23. ``[smc transport 2d]``: bench_smc.py:150-169's 2-D transport
   configuration (N((3, -2), 0.25 I), 65,536 particles, nsteps=60) beside
   the run without a transport: fewer temperatures with it, the launch
   counts, log Z within 0.1 and the weighted mean within 0.05
   (tests/test_smc.py:84-105);
24. ``[smc B1/B2 hold]``: the last fitted 100-D transport on the particles
   it was fitted on (the 16,384 even rows and all 32,768): B1's y and
   ladj against the plain version run in float64 within the B1
   tolerances, B2 on the fitter's own loss cotangents (gx, and the
   parameter gradients by ``grads_ok``); the kernels' and the plain
   versions' device times (profiler) beside the byte bound;
25. ``[smc infer]``: ``infer(method='smc')`` on tests/test_infer.py's 2-D
   Gaussian at 65,536 particles, raw and through its exact ``flow=``: no
   kernel launch, log Z within 0.1, the mean within 0.15, weight ESS
   above 1000;
26. ``[smc timing]``: the first 3 temperatures of the slice's
   configuration, without and with the transport: ms a temperature, host
   reads a temperature (``torch.cuda.set_sync_debug_mode``), then
   ``torch.profiler``'s busy ms, device ops and idle share; the fitter's
   ms a step through B1/B2 against the plain route (100 steps each, in
   turns, the histories within 1e-4 relative).

infer's default path runs after 26 (``infer_phases``), each call with the
launch counters set to 0 just before it and read just after, every phase
from generators of its own:

27. ``[infer auto 50d]``: BASELINE.json configs[3], the equicorrelated
   Gaussian of bench_mcmc.py:174-181 (rho 0.9, d=50) through
   ``et.infer(logp, dim=50)``: the default ladder (vi_steps=500,
   vi_batch=512), NUTS over 128 chains x 20 + 20 at max_depth=4.
   Exactly the launches the dispatch rule gives its fits
   (``expected_launches``): 500 B1 and 500 B2 for the elementwise rung;
   the spline rung's 1,024 rows and the rescue's 40 take the plain path
   (``coupling_batch_held``, ROADMAP C-3); draws finite; the family, the
   draws' moments and rhat printed, not gated: which transport the ladder
   keeps turns on the seed, and NUTS does not mix through the spline one,
   in JAX as in the port (ROADMAP C-12);
28. ``[infer spline 50d]``: the same with ``precondition_kind='spline'``:
   the family and the launches gated, the moments printed;
   ``[infer elementwise 50d]``: the same with
   ``precondition_kind='elementwise'`` and the configuration's NUTS, 300
   + 500 at max_depth 10, over 32 chains: 500 B1 and 500 B2, the mean
   within 0.1 and the sd within 10% of 1 in every dimension, rhat < 1.05;
   divergences printed (C-12);
29. ``[infer escalation 2d]``: tests/test_infer.py's bimodal target
   (:303, its settings but NUTS at 100 + 200: 0.12-0.40 of the draws right
   of 0, the x0 mean within 0.35 of -1.125) and its hard target (:353,
   whiten_batches=16): the ladder ends on the SMC rescue and escalates to
   SMC on the raw target, with exactly the rule's launches (5 B1 and 5
   B2; the spline rung and the whitening on the plain path), the
   unweighted share right of 0 printed, not gated (ROADMAP C-10);
30. ``[infer data 2d]``: examples/one_call_infer.py's case [2] with
   100,000 draws as ``data=``, whiten_batches=200, whiten_epochs=8, NUTS
   at 8 chains x 100 + 200:
   exactly 1,600 B3 launches, rhat < 1.05, the mean within
   test_infer.py:92-94's bound;
31. ``[infer refine]``: test_infer.py:101's target and gates, one
   refinement round;
32. ``[infer B4/B5 hold]`` (ROADMAP C-3): B4 and B5 on every coupling flow
   a rung or the rescue trained above and on the affine template's fits
   (``c3_fits``), at its own row count and at 2^17 rows: y, ladj, gx and
   every parameter gradient against the [B4]/[B5] TF32 gate, held where
   the dispatch sends such batches to the kernels (d=50 at 2^17 rows) and
   read elsewhere, beside the same gate against the plain version on the
   kernels' own TF32-rounded operands and the rows that set gx's max
   error with their distance to a knot. ``python3 chip_smoke.py
   --infer-probe`` runs this sweep alone at 2^10-2^17 rows on standalone
   fits, every reading printed, then ``[infer elementwise 50d]``;
33. ``[infer timing]``: ms a step fused against plain (host clock) for a VI
   step at each rung's shape and a whitening step at the rescue's 40 and
   256 rows and the data fit's 500 (the coupling steps forced through
   B4/B5, to read what the kernels would give at the sizes the rule keeps
   from them); each kernel's time at these shapes (B1-B3 device time by
   ``queued_ms``, B4/B5 by CUDA events) against its plain version, the
   bound and, for B4/B5, TF32 torch.matmul. Each infer phase's line splits
   its call's seconds into the VI fit, the probes, the rescue, the
   sampling and the diagnostics.

The script ends with its total time, the kernels line (each kernel's
launches summed over every main-path run, by path) and the ``{"ok": true,
...}`` line.

Tolerances: y 2e-5 and ladj 2e-4 (rtol = atol), input cotangents rtol 2e-4
/ atol 2e-5 elementwise, negll 1e-5 relative. Every parameter gradient is
a sum over millions of samples, accumulated in another order; it is held
against the plain version run in float64 on the same rows, within
2e-4 * max|g64| + 2e-5 or no further from it than twice the float32 plain
version is (``grads_ok``). The gradient
phases drop the few rows whose plain path meets an exact zero at a sign or
clamp point, where autograd of the plain stage bodies and the kernels'
analytic adjoints differ (``drop_exact_zero_rows``). B4 and B5 compute
the conditioner products in TF32, the counterpart of the reference
kernel's DEFAULT-precision (one bf16 pass) matmuls, so the coupling phases
follow tests_tpu/test_tpu_kernels.py:59-69: the kernel's max error against
the plain version run in float64 on the same rows is held within slack x
the error of the plain version run with TF32 products (``allow_tf32`` on for
that run only), or within floor x (max|f64| + 1): y and ladj 2x / 1e-3
(its :280-281), gx and every gradient 2x / 2e-4 (its :477-478). The
slack is 2x where the reference allows 6x / 8x, because here the kernel
and its yardstick round the same operands to TF32 (see ``C_FWD_GATE``).
The round trip stays at 1e-5 / 1e-4, or 4x the plain TF32 round trip:
an f32 ulp in a reconstructed conditioner input can flip its TF32
rounding. The plain references otherwise run in full f32.

Weights are random, made from seeded ``torch.Generator`` s. The script needs
one card and no network; it imports nothing of JAX.
"""
import copy
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
Y_TOL, LADJ_TOL, G_RTOL, G_ATOL, NEGLL_RTOL = 2e-5, 2e-4, 2e-4, 2e-5, 1e-5
SLICE_RTOL = 1e-4


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def reset_launches(*counters):
    """Set every launch count to 0, once the card has finished its work."""
    torch.cuda.synchronize()
    for counts in counters:
        for k in counts:
            counts[k] = 0


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds per call of ``fn`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(plain, kernel, iters=10):
    """(plain ms, kernel ms), timed plain, kernel, kernel, plain; the smaller
    of each pair."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return min(p1, p2), min(k1, k2)


def flagship_flow(et, dim, gen, device):
    """The flagship flow of __graft_entry__._flagship_flow: Johnson ->
    inverted CenterStretch -> 4-reflection Householder -> Johnson ->
    inverted CenterStretch, with its reflections drawn from ``gen``."""
    vec = lambda v: torch.full((dim,), v, device=device)
    V = torch.randn(4, dim, generator=gen, device=device)

    def johnson():
        return et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0))

    def stretch_inv():
        return et.invert(et.CenterStretch(vec(0.0), vec(1.0), vec(0.0)))

    return et.compose(johnson(), stretch_inv(),
                      et.Householder(V).canonicalize(), johnson(),
                      stretch_inv())


def example_2d_flow(et, device):
    """f_true of examples/nf_example_2d.py, the transport of the 2-D example
    target of benchmarks/bench_mcmc.py:35-44."""
    vec = lambda *a: torch.tensor(a, device=device)
    return et.compose(
        et.ScaleShift(vec(1.3, 0.4), vec(2.5, -1.2)),
        et.Householder(vec(1.0, 0.3)),
        et.CenterStretch(vec(4.0, 4.1), vec(2.0, 2.1), vec(3.0, 3.1)))


def example_2d(et, gen, device):
    """(f_true, model) of examples/nf_example_2d.py."""
    vec = lambda *a: torch.tensor(a, device=device)
    f_true = example_2d_flow(et, device)
    model = et.compose(
        et.invert(et.CenterStretch(vec(0.0, 0.0), vec(1.0, 1.0),
                                   vec(0.0, 0.0))),
        et.invert(et.Householder(torch.randn(2, generator=gen,
                                             device=device))),
        et.ScaleShift(vec(1.0, 1.0), vec(0.0, 0.0)))
    return f_true, model


def max_abs(a, b):
    return float((a - b).abs().max())


HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense


def bound_of(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their rate: f32 outside the tensor
    cores, or ``TF32_FLOP_PER_S`` for products on the tensor cores
    (NVIDIA's data sheet, at the 700 W limit)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def hh_flops(d, k):
    """FLOP per sample of one product with a Householder stage of k
    reflections, at what the function needs: the least of the dense (d, d)
    product (2 d^2) and the reflections one by one (a dot product and an
    update, 4 d each)."""
    return min(2 * d * d, 4 * k * d)


def grads_ok(got, plain, plain64):
    """Every parameter gradient of the kernel against the plain version run
    in float64 on the same inputs: within G_RTOL * max|g64| + G_ATOL, or no
    further from it than twice the float32 plain version is. (A gradient
    that is 0 in exact arithmetic, such as CenterContract's b at a = 0, is
    a sum of millions of rounding errors in f32.) Returns the worst
    max|kernel - plain f32|."""
    worst = 0.0
    for k, r64 in plain64.items():
        err_k = max_abs(got[k].double(), r64)
        err_p = max_abs(plain[k].double(), r64)
        scale = float(r64.abs().max())
        check(err_k <= max(G_RTOL * scale + G_ATOL, 2.0 * err_p),
              f"gradient {k}: |kernel - f64| {err_k:.3e}, |plain f32 - f64| "
              f"{err_p:.3e}, max|f64| {scale:.3e}")
        worst = max(worst, max_abs(got[k], plain[k]))
    return worst


# The first versions of B1-B3 (shared-memory tiles) at the same shapes
# (PERF.md), for reference.
EW_FIRST_MS = {("fwd", 2, 1 << 24): "1.111 ms",
               ("fwd", 50, 1 << 17): "0.312 ms",
               ("bwd", 2, 1 << 22): "0.943 ms",
               ("negll", 2, 1 << 22): "0.914 ms",
               ("negll", 50, 1 << 17): "1.187 ms"}
# Special functions per element of the flagship chain (two Johnson, two
# CenterContract stages; csrc/elementwise.cu f_jf, f_cc, b_jf, b_cc),
# counting exp, log, log1p, sqrt and each reciprocal: B1's forward with
# its ladj 2 x 3 + 2 x 6; B2's forward without it 2 x 2 + 2 x 4 and the
# adjoints 2 x 2 + 2 x 5 (given each stage's output); B3 the forward with
# its ladj and the adjoints.
EW_SPECIAL = {"fwd": 18, "bwd": 26, "negll": 32}


def special_ms(count, elements):
    """Milliseconds for ``count`` special functions per element at the
    MUFU rate, 16 per clock per SM at the card's maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return count * elements / (16 * sms * mhz * 1e6) * 1e3


def chain_geometry_text(EW, plan, n, mode):
    """B1-B3's launch for ``plan``: lanes per sample, elements per lane,
    block, grid, blocks per SM, registers and spilled bytes (the card's
    occupancy query), and the flagship's special functions at the MUFU
    rate."""
    geo = EW.chain_geometry(
        plan, n, mode, lambda b, sm: EW.occupancy(mode, plan.E, b, sm)[0],
        torch.cuda.get_device_properties(0).multi_processor_count)
    bps, regs, local = EW.occupancy(mode, plan.E, geo.block, geo.smem)
    where = " (words in a device scratch)" if geo.scratch else ""
    return (f"G={plan.G} E={plan.E} block {geo.block} grid {geo.grid} smem "
            f"{geo.smem} B{where}: {bps} blocks/SM, {regs} registers, "
            f"{local} local bytes; "
            f"{EW_SPECIAL[mode]} special functions per element = "
            f"{special_ms(EW_SPECIAL[mode], n * plan.d):.4f} ms at "
            f"16/clock/SM")


def phase_b1(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x = torch.randn(n, dim, generator=gen, device=device)
    with torch.no_grad():
        y, ladj = EW.fused_forward_and_ladj(chain, x)
        y0, l0 = EW.forward_and_ladj_plain(chain, x)
        torch.cuda.synchronize()
        check(torch.allclose(y, y0, rtol=Y_TOL, atol=Y_TOL),
              f"B1 y at d={dim}: max|dy| {max_abs(y, y0):.3e}")
        check(torch.allclose(ladj, l0, rtol=LADJ_TOL, atol=LADJ_TOL),
              f"B1 ladj at d={dim}: max|dladj| {max_abs(ladj, l0):.3e}")
        plan, bufs = EW._chain_plan(chain, dim, device)
        plain_ms, ms = interleaved_ms(
            lambda: EW.forward_and_ladj_plain(chain, x),
            lambda: EW._launch("fwd", plan, x, bufs))
        wrapper_ms = cuda_ms(lambda: EW.fused_forward_and_ladj(chain, x))
    err = max(max_abs(y, y0), max_abs(ladj, l0))
    # x read, y and ladj written; the Householder product's multiply-adds.
    bound = bound_of(4 * n * (2 * dim + 1), n * hh_flops(dim, 4))
    first = EW_FIRST_MS.get(("fwd", dim, n), "not measured")
    print(f"[B1] flagship d={dim} n={n}: max|dy| {max_abs(y, y0):.3e} "
          f"max|dladj| {max_abs(ladj, l0):.3e}; kernel {ms:.4f} ms "
          f"(wrapper {wrapper_ms:.4f} ms, the tile version {first}), "
          f"plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
          f"{chain_geometry_text(EW, plan, x.shape[0], 'fwd')} [{card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def drop_exact_zero_rows(et, EW, chain, x):
    """``x`` without the rows whose plain path meets a point where autograd
    of the stage bodies differs from the analytic derivative: an input of
    exactly 0 to Johnson's sign(u) * log(|u| + s) or JohnsonInv's sign(v),
    of exactly 0 to a CenterContract softplus argument (AD of exp(-|u|)),
    or |b t| <= 1e-6 in CenterStretch's clamp. torch.randn does return
    exact zeros in f32; the kernels' analytic adjoints are right there."""
    bad = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    t = x
    with torch.no_grad():
        for s in chain.stages:
            f = s.fields()
            if isinstance(s, et.Johnson):
                bad |= (t == f["xi"]).any(1)
            elif isinstance(s, et.JohnsonInv):
                bad |= (t == f["gamma"]).any(1)
            elif isinstance(s, et.CenterContract):
                u = t - f["c"]
                bad |= ((u == f["a"]) | (u == -f["a"])).any(1)
            elif isinstance(s, et.CenterStretch):
                bad |= ((f["b"] * t).abs() <= 1e-6).any(1)
            t, _ = EW.forward_and_ladj_plain(et.Chain.of(s), t)
    return x[~bad].contiguous(), int(bad.sum())


def phase_b2(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x, dropped = drop_exact_zero_rows(
        et, EW, chain, torch.randn(n, dim, generator=gen, device=device))
    params = dict(chain.named_parameters())

    def grads(forward):
        xr = x.clone().requires_grad_(True)
        y, ladj = forward(chain, xr)
        loss = torch.sin(y).sum() + (ladj * ladj).sum()
        gs = torch.autograd.grad(loss, [xr, *params.values()])
        return gs[0], dict(zip(params, gs[1:]))

    gx, g = grads(EW.fused_forward_and_ladj)
    gx0, g0 = grads(EW.forward_and_ladj_plain)
    chain64, x64 = copy.deepcopy(chain).double(), x.double()
    xr = x64.clone().requires_grad_(True)
    y, ladj = EW.forward_and_ladj_plain(chain64, xr)
    p64 = dict(chain64.named_parameters())
    g64 = dict(zip(p64, torch.autograd.grad(
        torch.sin(y).sum() + (ladj * ladj).sum(), list(p64.values()))))
    torch.cuda.synchronize()
    check(torch.allclose(gx, gx0, rtol=G_RTOL, atol=G_ATOL),
          f"B2 gx: max|diff| {max_abs(gx, gx0):.3e}")
    worst = grads_ok(g, g0, g64)

    # Time the backward alone: the kernel on saved forward outputs, the
    # plain version by autograd over a retained graph.
    with torch.no_grad():
        plan, bufs = EW._chain_plan(chain, dim, device)
        bufs = tuple(b.detach() for b in bufs)
        y, ladj = EW._launch("fwd", plan, x, bufs)
    gy, gl = torch.cos(y), 2.0 * ladj
    xr = x.clone().requires_grad_(True)
    y0, l0 = EW.forward_and_ladj_plain(chain, xr)
    plain_ms, ms = interleaved_ms(
        lambda: torch.autograd.grad([y0, l0], [xr, *params.values()],
                                    [gy, gl], retain_graph=True),
        lambda: EW._launch("bwd", plan, x, bufs, gy, gl))
    err = max(max_abs(gx, gx0), worst)
    # x and gy read, gx written, gladj read; the Householder products of the
    # recompute, of dQ and of the input cotangent.
    bound = bound_of(4 * x.shape[0] * (3 * dim + 1),
                     3 * x.shape[0] * hh_flops(dim, 4))
    print(f"[B2] flagship d={dim} n={n} ({dropped} exact-zero rows "
          f"dropped): max|dgx| {max_abs(gx, gx0):.3e} "
          f"max|dgrad| {worst:.3e}; kernel {ms:.4f} ms (the tile version "
          f"{EW_FIRST_MS.get(('bwd', dim, n), 'not measured')}"
          f"), plain autograd backward "
          f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); "
          f"{chain_geometry_text(EW, plan, x.shape[0], 'bwd')} [{card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def phase_b3(et, EW, dim, n, gen, device, card):
    chain = flagship_flow(et, dim, gen, device)
    x, dropped = drop_exact_zero_rows(
        et, EW, chain, torch.randn(n, dim, generator=gen, device=device))
    v, g = EW.fused_negll_value_and_grad(chain, x)
    v0, g0 = EW.negll_value_and_grad_plain(chain, x)
    _, g64 = EW.negll_value_and_grad_plain(copy.deepcopy(chain).double(),
                                           x.double())
    torch.cuda.synchronize()
    check(abs(float(v) - float(v0)) <= NEGLL_RTOL * abs(float(v0)),
          f"B3 negll at d={dim}: {float(v)} vs {float(v0)}")
    worst = grads_ok(g, g0, g64)
    plan, bufs = EW._chain_plan(chain, dim, device)
    bufs = tuple(b.detach() for b in bufs)
    plain_ms, ms = interleaved_ms(
        lambda: EW.negll_value_and_grad_plain(chain, x),
        lambda: EW._launch("negll", plan, x, bufs))
    wrapper_ms = cuda_ms(lambda: EW.fused_negll_value_and_grad(chain, x))
    err = max(abs(float(v) - float(v0)), worst)
    # x read once; the Householder products of the forward, dQ and the
    # input cotangent.
    bound = bound_of(4 * x.shape[0] * dim, 3 * x.shape[0] * hh_flops(dim, 4))
    print(f"[B3] flagship d={dim} n={n} ({dropped} exact-zero rows "
          f"dropped): negll {float(v):.7f} vs plain "
          f"{float(v0):.7f}, max|dgrad| {worst:.3e}; kernel {ms:.4f} ms "
          f"(wrapper {wrapper_ms:.4f} ms, the tile version "
          f"{EW_FIRST_MS.get(('negll', dim, n), 'not measured')}"
          f"), plain value+grad "
          f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); "
          f"{chain_geometry_text(EW, plan, x.shape[0], 'negll')} [{card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


SWEEP = [  # (d, n, stages); "~" marks an inverted stage
    (1, 1, ["j", "cs", "~ss"]),
    (2, 37, ["ss", "hh", "cc", "ji", "cs", "j"]),
    (3, 1001, ["~hh", "j", "cs", "hh", "ss"]),
    (4, 500, ["ss0", "cs0", "j"]),         # "0": scalar (0-d) parameters
    (50, 777, ["j", "cc", "hh", "ji", "~ss", "cs"]),
    (128, 300, ["cs", "hh", "hh", "j"]),
    (128, 5, ["hh"]),
    (5, 10, []),
    (300, 64, ["ss", "ji", "cc"]),
    (2048, 9, ["ss", "j", "cs"]),          # one block per SM
]


def sweep_chain(et, d, kinds, gen, device):
    def u(lo, hi, scalar=False):
        shape = () if scalar else (d,)
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    stages = []
    for kind in kinds:
        inv, scalar = kind.startswith("~"), kind.endswith("0")
        k = kind.strip("~0")
        if k == "ss":
            s = et.ScaleShift(u(0.5, 2.0, scalar), u(-1.0, 1.0, scalar))
        elif k in ("cs", "cc"):
            cls = et.CenterStretch if k == "cs" else et.CenterContract
            s = cls(u(0.1, 1.0, scalar), u(0.5, 2.5, scalar),
                    u(-0.5, 0.5, scalar))
        elif k in ("j", "ji"):
            cls = et.Johnson if k == "j" else et.JohnsonInv
            s = cls(u(-0.5, 0.5, scalar), u(2.0, 6.0, scalar),
                    u(-0.5, 0.5, scalar), u(2.0, 6.0, scalar))
        else:                  # "hh": 3 reflections, "HH": d of them
            s = et.Householder(torch.randn(3 if k == "hh" else d, d,
                                           generator=gen,
                                           device=device)).canonicalize()
        stages.append(s.inverse() if inv else s)
    return et.Chain.of(*stages)


def close_to_f64(got, plain, plain64, tol, what):
    """``got`` within tol * max|f64| + tol of the float64 plain result, or
    no further from it than twice the float32 plain result is."""
    err_k = max_abs(got.double(), plain64)
    err_p = max_abs(plain.double(), plain64)
    scale = float(plain64.abs().max()) if plain64.numel() else 0.0
    check(err_k <= max(tol * scale + tol, 2.0 * err_p),
          f"{what}: |kernel - f64| {err_k:.3e}, |plain f32 - f64| "
          f"{err_p:.3e}, max|f64| {scale:.3e}")
    return err_k


# Chains whose lane words do not fit a 256-thread block: dense Householder
# stages at d=128 take E d = 512 words a lane each, so one stage runs at 64
# threads a block and four spill to a device scratch. Drawn from their own
# generator (``phase_sweep``).
SWEEP_WORDS = [
    (128, 200, ["HH", "j"]),
    (128, 100, ["j", "HH", "HH", "cs", "HH", "HH"]),
]


def phase_sweep(et, EW, gen, device):
    """B1, B2 and B3 against the plain version (float32 and float64) on
    chains and shapes beyond the flagship: ragged tiles, every stage kind,
    inverted stages, scalar parameters, Householder-only and empty chains,
    d up to 2048, lane words in smaller blocks and in a device scratch
    (``SWEEP_WORDS``, with a check that both ran); and the refusal of a
    chain the kernels do not take."""
    worst = 0.0
    words_gen = torch.Generator(device=device).manual_seed(8)
    layouts = set()
    rows = [(r, gen) for r in SWEEP] + [(r, words_gen) for r in SWEEP_WORDS]
    for (d, n, kinds), rng in rows:
        chain = sweep_chain(et, d, kinds, rng, device)
        for mode in ("bwd", "negll"):
            geo = EW.chain_geometry(EW.chain_plan(chain, d), n, mode)
            layouts.add("device scratch" if geo.scratch else
                        f"{geo.block}-thread blocks")
        check(EW.is_fusible_chain(chain, d), f"sweep d={d} {kinds} fusible")
        chain64 = copy.deepcopy(chain).double()
        x, _ = drop_exact_zero_rows(
            et, EW, chain, torch.randn(n, d, generator=rng, device=device))
        gy = torch.randn(x.shape, generator=rng, device=device)
        gl = torch.randn(x.shape[0], generator=rng, device=device)

        def b1_b2(c, forward, xx):
            xr = xx.clone().requires_grad_(True)
            y, ladj = forward(c, xr)
            ps = dict(c.named_parameters())
            outs = [(o, g) for o, g in ((y, gy), (ladj, gl))
                    if o.requires_grad]
            gs = torch.autograd.grad(
                [o for o, _ in outs], [xr, *ps.values()],
                [g.to(o.dtype) for o, g in outs], allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(ps.items(), gs[1:])}
            return y.detach(), ladj.detach(), gs[0], grads

        got = b1_b2(chain, EW.fused_forward_and_ladj, x)
        ref = b1_b2(chain, EW.forward_and_ladj_plain, x)
        ref64 = b1_b2(chain64, EW.forward_and_ladj_plain, x.double())
        what = f"sweep d={d} n={n} {kinds}"
        errs = [close_to_f64(got[0], ref[0], ref64[0], Y_TOL, what + " y"),
                close_to_f64(got[1], ref[1], ref64[1], LADJ_TOL,
                             what + " ladj"),
                close_to_f64(got[2], ref[2], ref64[2], G_RTOL,
                             what + " gx")]
        for k in ref64[3]:
            errs.append(close_to_f64(got[3][k], ref[3][k], ref64[3][k],
                                     G_RTOL, f"{what} B2 grad {k}"))
        v, g = EW.fused_negll_value_and_grad(chain, x)
        v0, g0 = EW.negll_value_and_grad_plain(chain, x)
        v64, g64 = EW.negll_value_and_grad_plain(chain64, x.double())
        errs.append(close_to_f64(v, v0, v64, NEGLL_RTOL, what + " negll"))
        for k in g64:
            errs.append(close_to_f64(g[k], g0[k], g64[k], G_RTOL,
                                     f"{what} B3 grad {k}"))
        worst = max(worst, *errs)
    wide = sweep_chain(et, 129, ["ss", "hh"], gen, device)
    try:
        EW.fused_forward_and_ladj(wide, torch.zeros(4, 129, device=device))
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused, "a Householder chain at d=129 was not refused")
    check({"device scratch", "64-thread blocks"} <= layouts,
          f"sweep lane-word layouts {sorted(layouts)}")
    print(f"[sweep] {len(rows)} chains, d in "
          f"{sorted({d for (d, _, _), _ in rows})}: B1, B2, B3 within "
          f"tolerance of the float64 plain version (worst |kernel - f64| "
          f"{worst:.3e}); B2/B3 lane words in {', '.join(sorted(layouts))}; "
          f"d=129 with a Householder refused", flush=True)


def corner_cases(et, device):
    """The bijectors of tests/test_bijector_elementwise.py:28-40 in f32, each
    with its corner rows: |b x| >> 88 (:105-112), and for JohnsonInv |v| =
    88, its last decade that f32 holds (tests/test_torch_elementwise_ops.py
    CORNER_X, JI_EDGE_X)."""
    t = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    corner = t([-200.0, 0.0, 200.0], [-5.0, 1e-3, 5.0])
    edge = t([88.5 * 3.5 + 0.3, -88.5 * 2.0 - 1.0, 88.0], [0.0, 1.0, -2.0])
    return [
        (et.ScaleShift(t(1.3, 0.4, -2.0), t(2.5, -1.2, 0.3)), corner),
        (et.CenterStretch(t(4.0, 4.1, 0.5), t(2.0, 2.1, 1.0),
                          t(3.0, 3.1, -0.2)), corner),
        (et.CenterContract(t(4.0, 4.1, 0.5), t(2.0, 2.1, 1.0),
                           t(3.0, 3.1, -0.2)), corner),
        (et.Johnson(t(10.0, -1.0, 0.0), t(3.5, 2.0, 1.0), t(10.0, 0.0, -1.0),
                    t(1.0, 2.0, 0.5)), corner),
        (et.JohnsonInv(t(0.3, -1.0, 0.0), t(3.5, 2.0, 1.0), t(1.0, 0.0, -1.0),
                       t(1.0, 2.0, 0.5)), edge),
    ]


def phase_corners(et, EW, device):
    """B1, B2 and B3 at the f32 stability corners: finite y and ladj, and
    (but for JohnsonInv, whose derivatives ~ v cosh v overflow there) finite
    input cotangents and parameter gradients, as the plain path gives
    (tests/test_torch_elementwise_ops.py test_float32_corners_stay_finite).
    Prints B1's largest relative distance from the plain f32 path."""
    worst = 0.0
    names = []
    for f, x in corner_cases(et, device):
        chain = et.Chain.of(f)
        kind = type(f).__name__
        names.append(kind)
        with torch.no_grad():
            y, ladj = EW.fused_forward_and_ladj(chain, x)
            y0, l0 = EW.forward_and_ladj_plain(chain, x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(ladj).all()),
              f"[B1-B3 corners] {kind}: B1 y {y.tolist()} ladj "
              f"{ladj.tolist()}")
        for a, b in ((y, y0), (ladj, l0)):
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(
                min=1.0)).max()))
        if isinstance(f, et.JohnsonInv):
            continue
        _, g3 = EW.fused_negll_value_and_grad(chain, x)
        xr = x.clone().requires_grad_(True)
        yy, ll = EW.fused_forward_and_ladj(chain, xr)
        ps = dict(chain.named_parameters())
        gs = torch.autograd.grad([yy, ll], [xr, *ps.values()],
                                 [torch.ones_like(yy), torch.ones_like(ll)])
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all())
                  for g in (*g3.values(), *gs)),
              f"[B1-B3 corners] {kind}: a gradient is not finite: B3 "
              f"{ {k: v.tolist() for k, v in g3.items()} }, B2 "
              f"{[g.tolist() for g in gs]}")
    print(f"[B1-B3 corners] {', '.join(names)} at |b x| >> 88 (JohnsonInv "
          f"at |v| = 88): B1 y and ladj finite, B2 gx and gradients and B3 "
          f"gradients finite; max relative distance of B1 from the plain "
          f"f32 path {worst:.3e}", flush=True)


def ew_ptxas(report):
    """ptxas's registers and spills of every B1-B3 instantiation; a spill
    fails the run."""
    ents = [e for needle in ("ew_fwd_kernel", "ew_grad_kernel")
            for e in ptxas_entries(report, needle)]
    check(len(ents) == 9 and all(st == 0 and ld == 0
                                 for _, _, st, ld in ents),
          f"B1-B3 ptxas entries or spills: {ents}")
    print("[B1-B3 ptxas] " + " | ".join(
        f"{name} {regs} registers, {st}/{ld} spill bytes"
        for name, regs, st, ld in ents), flush=True)


HH_AUTO_DIMS = (2, 8, 50, 128)
HH_AUTO_BATCH_LOG2 = (10, 14, 17, 20)


def phase_householder_auto(et, gen, device, card):
    """Householder's two plain routes on the card: the scan (one reflection
    at a time, memory-free backward) against the dense product x Q^T, each
    forward and backward (y.sum() to V and x), at d in HH_AUTO_DIMS, batch
    2^10 .. 2^20 and k from 1 to d, timed scan, dense, dense, scan. Prints
    which route was faster where and how often ``Householder(mode="auto")``
    picks the faster one, and writes every time to
    chiprun_out/householder_auto.json. Returns the rows."""
    from enflows_tpu_torch.bijectors.householder import (
        householder_chain, householder_chain_dense)

    rows = []
    for d in HH_AUTO_DIMS:
        for k in sorted({1, 2, 4, max(1, d // 2), d}):
            V = torch.randn(k, d, generator=gen, device=device)
            for lb in HH_AUTO_BATCH_LOG2:
                x = torch.randn(1 << lb, d, generator=gen, device=device)
                Vr = V.clone().requires_grad_(True)
                xr = x.clone().requires_grad_(True)

                def run(fn):
                    return torch.autograd.grad(fn(Vr, xr).sum(), [Vr, xr])

                scan = lambda: run(householder_chain)
                dense = lambda: run(householder_chain_dense)
                t = [cuda_ms(f, iters=3, warmup=1)
                     for f in (scan, dense, dense, scan)]
                rows.append(dict(d=d, k=k, batch=1 << lb,
                                 scan_ms=min(t[0], t[3]),
                                 dense_ms=min(t[1], t[2]),
                                 auto_dense=bool(
                                     et.Householder(V)._use_dense(x))))
    agree = sum((r["dense_ms"] < r["scan_ms"]) == r["auto_dense"]
                for r in rows)
    lost = sum(abs(r["dense_ms"] - r["scan_ms"]) for r in rows
               if (r["dense_ms"] < r["scan_ms"]) != r["auto_dense"])
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "householder_auto.json"),
              "w") as fh:
        json.dump(dict(card=card, rows=rows), fh)
    faster = "; ".join(
        f"d={d}: " + ", ".join(
            f"k={r['k']} 2^{r['batch'].bit_length() - 1} "
            f"{'D' if r['dense_ms'] < r['scan_ms'] else 'S'}"
            f"{r['scan_ms'] / r['dense_ms']:.2f}"
            for r in rows if r["d"] == d)
        for d in HH_AUTO_DIMS)
    print(f"[householder auto] forward + backward, D: dense faster, S: scan, "
          f"then scan ms / dense ms: {faster}; mode='auto' picks the faster "
          f"route in {agree} of {len(rows)} cases (loses {lost:.3f} ms "
          f"summed over the others) [{card}]", flush=True)
    return rows


def device_kernel_us(prof):
    """({kernel name: device microseconds}, device ops) from a
    ``torch.profiler`` run: the device-side events, without the user
    annotations (such as Optimizer.step#...), whose device time is that of
    the kernels inside them and would count it twice."""
    from torch.autograd import DeviceType

    by_name, ops = {}, 0
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA and evt.device_time_total > 0
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith("Optimizer.")):
            by_name[evt.key] = by_name.get(evt.key, 0) + \
                evt.device_time_total
            ops += evt.count
    return by_name, ops


def profile_whitening_steps(name, initial, X, step_ms, card):
    """Where a fused whitening train step's time goes: ``torch.profiler``
    over one epoch of 4 steps of the trainer (after the slice warmed it
    up), device time by kernel name, device ops per step, and the device's
    idle share against the unprofiled step ``step_ms``."""
    from torch.profiler import ProfilerActivity, profile

    from enflows_tpu_torch.train import optimize_whitening

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize_whitening(X, initial, nbatches=4, nepochs=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 4
    by_name, ops = device_kernel_us(prof)
    busy = sum(by_name.values()) / 4e3
    if not busy:
        print(f"[whitening profile] {name}: no device time in the trace "
              f"(not measured) [{card}]", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[whitening profile] {name}, 4 fused steps of 2^20 samples: "
          f"device busy {busy:.4f} ms/step in {ops / 4:.0f} device ops a "
          f"step, idle {100 * (1 - busy / step_ms):.1f}% of the unprofiled "
          f"{step_ms:.3f} ms/step ({100 * (1 - busy / wall_ms):.1f}% of the "
          f"profiled {wall_ms:.3f}); by kernel, ms/step: "
          + ", ".join(f"{k[:40]} {us / 4e3:.4f} ({100 * us / 4e3 / busy:.1f}%)"
                      for k, us in top) + f" [{card}]", flush=True)


def train_and_evaluate(et, EW, name, model, X):
    """The user's path: fit, then evaluate the fitted flow's full-data negll
    and its gradient (B1 + B2) and cov(f(X))."""
    from enflows_tpu_torch.train import (mvnormal_negll_fused,
                                         optimize_whitening)

    before = EW.LAUNCHES["negll"]
    res = optimize_whitening(X, model, nbatches=4, nepochs=3)
    hist = res.negll_history.cpu()
    check(EW.LAUNCHES["negll"] - before == 12,
          f"{name}: {EW.LAUNCHES['negll'] - before} B3 launches, not 12")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (12,),
          f"{name}: history {hist.tolist()}")
    check(float(hist[-1]) < float(hist[0]),
          f"{name}: negll did not fall: {hist.tolist()}")
    flow = res.result
    for p in flow.parameters():
        p.grad = None
    negll = mvnormal_negll_fused(flow, X)
    negll.backward()
    gnorm = torch.sqrt(sum((p.grad * p.grad).sum()
                           for p in flow.parameters()))
    with torch.no_grad():
        y, ladj = EW.fused_forward_and_ladj(flow, X)
    check(y.shape == X.shape and bool(torch.isfinite(y).all())
          and bool(torch.isfinite(ladj).all()),
          f"{name}: fitted flow gives non-finite values")
    cov = torch.cov(y.T).cpu()
    print(f"[slice] {name}: negll history {[round(float(h), 5) for h in hist]}"
          f"; fitted full-data negll {float(negll.detach()):.5f}, |grad| "
          f"{float(gnorm):.4e}; cov(f(X)) = "
          f"{[[round(float(c), 4) for c in row] for row in cov]}",
          flush=True)
    return hist


# ----------------------------------------------------------------------
# The coupling-flow path: kernels B4 (forward + ladj of a whole coupling
# stack) and B5 (its backward), enflows_tpu_torch/ops/csrc/coupling.cu.

# The gates, after tests_tpu/test_tpu_kernels.py:59-69 (its _gate): B4 and
# B5 run the conditioner in TF32, the counterpart of the reference kernel's
# DEFAULT-precision (one bf16 pass) matmuls, so the kernel's error against
# a float64 plain run is held to that of the plain version run with TF32
# products, times a slack, or to a floor relative to max|f64| + 1: y and
# ladj 1e-3 (test_tpu_kernels.py:280-281), gx and every gradient 2e-4
# (:477-478). The slack is 2x, not the reference's 6x / 8x: there the
# kernel and its yardstick round differently (bf16 passes against XLA's
# DEFAULT), here both round the same operands to TF32, and the kernel's
# errors measured 1.0-1.2x the yardstick's on the card. A kernel whose
# products ran in bf16 (8x TF32's unit roundoff) fails it.
C_FWD_GATE, C_BWD_GATE = (2.0, 1e-3), (2.0, 2e-4)
RT_X_TOL, RT_LADJ_TOL = 1e-5, 1e-4
COUPLING_SLICE_RTOL, COUPLING_CALM_RTOL = 1e-3, 1e-4
BASELINE = dict(dim=64, n_layers=4, hidden=(512, 512))   # BASELINE.md:150


def tf32_round(x):
    """x rounded to TF32 as the kernels round an operand
    (``cvt.rna.tf32.f32``: the 13 low mantissa bits, half away from
    zero)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Product(torch.autograd.Function):
    """h @ W on TF32-rounded operands with f32 products, the backward's
    products on the rounded cotangent as well: the kernels' own rounding,
    for C-3's diagnosis."""

    @staticmethod
    def forward(ctx, h, W):
        hr, Wr = tf32_round(h), tf32_round(W)
        ctx.save_for_backward(hr, Wr)
        return _MATMUL(hr, Wr)

    @staticmethod
    def backward(ctx, g):
        hr, Wr = ctx.saved_tensors
        gr = tf32_round(g)
        return _MATMUL(gr, Wr.t()), _MATMUL(hr.t(), gr)


_MATMUL = torch.matmul


class tf32_emulated:
    """torch.matmul of f32 operands as ``_Tf32Product`` inside the block,
    in full f32 otherwise."""

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.matmul = lambda a, b: (
            _Tf32Product.apply(a, b) if a.dtype == torch.float32
            else _MATMUL(a, b))

    def __exit__(self, *exc):
        torch.matmul = _MATMUL
        torch.backends.cuda.matmul.allow_tf32 = self.was


class matmul_tf32:
    """torch.matmul in TF32 (``flag`` True) or in full f32 inside the block,
    the setting outside restored after it. TF32 is the plain version's
    yardstick run for the gates above; full f32 keeps the VI targets'
    density the same function in every run, the TF32 yardstick's
    included."""

    def __init__(self, flag=True):
        self.flag = flag

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.flag

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


class Held(NamedTuple):
    """One gate's reading: |kernel - f64|, |plain TF32 - f64|, max|f64| and
    the limit the kernel's error was held to."""
    err: float
    tf32: float
    scale: float
    limit: float

    @property
    def share(self):
        """The kernel's error as a share of its limit."""
        return self.err / self.limit if self.limit else 0.0

    def __str__(self):
        return (f"{self.err:.3e} (plain TF32 {self.tf32:.3e}, max|f64| "
                f"{self.scale:.3e}, limit {self.limit:.3e})")


def tf32_gate(got, plain_tf32, ref64, gate, what, enforce=True):
    """The kernel's max error against the float64 run within slack x the
    TF32 plain run's, or floor x (max|f64| + 1). Returns a ``Held``;
    ``enforce=False`` only reads it."""
    slack, floor = gate
    if not ref64.numel():
        return Held(0.0, 0.0, 0.0, 0.0)
    err_k = max_abs(got.double(), ref64)
    err_t = max_abs(plain_tf32.double(), ref64)
    scale = float(ref64.abs().max())
    held = Held(err_k, err_t, scale, max(slack * err_t, floor * (scale + 1)))
    check(err_k <= held.limit or not enforce,
          f"{what}: |kernel - f64| {held}")
    return held


def baseline_stack(et, kind, gen, device, last=0.005):
    """The BASELINE coupling stack (d=64, 4 couplings with reversal
    Permutes, (512, 512) gelu conditioners; the spline one with K=8 bins on
    [-5, 5]), He-initialized from ``gen`` with its zeroed last layers
    perturbed by ``last`` * N(0, 1), so the map is not the identity but
    stays well conditioned."""
    make = et.coupling_stack if kind == "affine" else \
        et.spline_coupling_stack
    kw = {} if kind == "affine" else dict(n_bins=8, bound=5.0)
    stack = make(gen, BASELINE["dim"], BASELINE["n_layers"],
                 BASELINE["hidden"], device=device, **kw)
    if last:
        with torch.no_grad():
            for name, p in stack.named_parameters():
                if ".layers.2." in name:
                    p.add_(last * torch.randn(p.shape, generator=gen,
                                              device=device))
    return stack


def conditioner_flops(st):
    """Multiply-add FLOPs per sample of a plan's conditioner products."""
    return 2 * sum(K * N for K, N in st.layers)


def matmul_only_ms(st, n, device, backward, tf32=False):
    """The same conditioner products alone, in torch.matmul f32 (or TF32):
    the forward's h @ W per layer, or the backward's g @ W^T and h^T @ g. A
    yardstick; the port never calls it."""
    gen = torch.Generator(device=device).manual_seed(1)
    mats = [(torch.randn(n, K, generator=gen, device=device),
             torch.randn(K, N, generator=gen, device=device),
             torch.randn(n, N, generator=gen, device=device))
            for K, N in st.layers]

    def run():
        for h, W, g in mats:
            if backward:
                torch.matmul(g, W.t())
                torch.matmul(h.t(), g)
            else:
                torch.matmul(h, W)
    if not tf32:
        return cuda_ms(run, iters=5)
    with matmul_tf32(True):
        return cuda_ms(run, iters=5)


def l2_weight_bytes(C, st, n):
    """The weight bytes B4 reads from L2: every tile of rows reads every
    layer's packed W and bias once."""
    pp = C._padded(st)
    tm = C._pick_tile(st, backward=False)
    return -(-n // tm) * 4 * sum((Kp + 1) * Np for Kp, Np in pp.kn)


def phase_b4(et, C, kind, n, gen, device, card):
    """B4 against its plain version at the BASELINE config (the TF32 gate
    against a float64 run), and the round trip through B4 on
    stack.inverse()."""
    stack = baseline_stack(et, kind, gen, device)
    d = BASELINE["dim"]
    # Scaled so that some spline inputs fall outside [-5, 5].
    x = 2.2 * torch.randn(n, d, generator=gen, device=device)
    out = float(((x.abs() >= 5.0).float().mean()))
    st = C._stack_structure(stack, d)
    with torch.no_grad():
        y, ladj = C.fused_coupling_forward_and_ladj(stack, x)
        wbuf, pbuf = C._stack_plan(stack, st, torch.float32, device)
        y0, l0 = C.coupling_forward_plain(st, wbuf, pbuf, x)
        y0 = y0[:, list(st.out_map)]
        with matmul_tf32(True):
            yt, lt = plain_coupling(C)(stack, x)
        y64, l64 = plain_coupling(C)(copy.deepcopy(stack).double(),
                                     x.double())
        xb, lb = C.fused_coupling_forward_and_ladj(stack.inverse(), y)
        with matmul_tf32(True):
            xbt, lbt = plain_coupling(C)(stack.inverse(), yt)
        torch.cuda.synchronize()
        held_y = tf32_gate(y, yt, y64, C_FWD_GATE, f"B4 {kind} y")
        held_l = tf32_gate(ladj, lt, l64, C_FWD_GATE, f"B4 {kind} ladj")
        del y64, l64
        # The round trip: within 1e-5 / 1e-4 (rtol = atol), as
        # tests/test_coupling.py:167-181 holds the affine stack, or no
        # further off than 4x the plain version's own round trip with TF32
        # products, as tests_tpu/test_tpu_kernels.py:282-292 holds the
        # reference kernel against its jnp path at the same precision. The
        # inverse recomputes each conditioner from its stage's input as the
        # inverse reconstructs it, which differs from the forward's by f32
        # rounding; TF32 rounds those inputs to 10 bits, so an ulp there can
        # move a product by 2^-11, amplified like any error by e^{|s|} per
        # affine layer and by the inverse slope where a spline compresses
        # (tests/test_spline.py:140-145).
        for got, ref, plain, tol, what in (
                (xb, x, xbt - x, RT_X_TOL, "x"),
                (lb, -ladj, lbt + lt, RT_LADJ_TOL, "ladj")):
            err = (got - ref).abs()
            err_p = float(plain.abs().max())
            check(bool((err <= tol * (1 + ref.abs())).all())
                  or float(err.max()) <= 4.0 * err_p,
                  f"B4 {kind} round trip {what}: max|d| {float(err.max()):.3e}"
                  f", plain TF32 round trip {err_p:.3e}")
        rt_plain = (max_abs(xbt, x), max_abs(lbt, -lt))
        del yt, lt, xbt, lbt
        # The trainer's B4 writes B5's rows too: that launch is the kernel's
        # time; the launch without them stands beside it.
        plain_ms, ms = interleaved_ms(
            lambda: C.coupling_forward_plain(st, wbuf, pbuf, x),
            lambda: C._launch_fwd(st, x, wbuf, pbuf, True), iters=5)
        bare_ms = cuda_ms(lambda: C._launch_fwd(st, x, wbuf, pbuf), iters=5)
        wrapper_ms = cuda_ms(lambda: C.fused_coupling_forward_and_ladj(
            stack, x, physical_order=True), iters=5)
    mm_ms = matmul_only_ms(st, n, device, backward=False)
    tf32_ms = matmul_only_ms(st, n, device, backward=False, tf32=True)
    flops = conditioner_flops(st) * n
    nbytes = 4 * (n * (2 * d + 1) + st.w_len)
    bound = bound_of(nbytes, flops, TF32_FLOP_PER_S)
    f32_bound = bound_of(nbytes, flops)["bound_ms"]
    l2 = l2_weight_bytes(C, st, n)
    print(f"[B4] {kind} d={d} 4x{BASELINE['hidden']} n={n} "
          f"({100 * out:.2f}% of inputs outside +-5): |kernel - f64| y "
          f"{held_y}, ladj {held_l}; plain f32 - kernel y "
          f"{max_abs(y, y0):.3e}; round trip max|dx| {max_abs(xb, x):.3e} "
          f"(plain TF32 {rt_plain[0]:.3e}), max|ladj + ladj_inv| "
          f"{max_abs(lb, -ladj):.3e} (plain TF32 {rt_plain[1]:.3e}); "
          f"kernel {ms:.3f} ms writing B5's rows as training does "
          f"({bare_ms:.3f} ms without them; wrapper without them "
          f"{wrapper_ms:.3f} ms), plain "
          f"{plain_ms:.3f} ms, TF32 FLOP bound {bound['bound_ms']:.3f} ms "
          f"(f32 {f32_bound:.3f} ms; {flops / 1e9:.1f} GFLOP), "
          f"{flops / ms / 1e9:.2f} TFLOP/s; L2 weight reads "
          f"{l2 / 1e9:.2f} GB (tiles x weights) [{card}]", flush=True)
    print(f"[B4] {kind} yardstick: the same conditioner products alone in "
          f"torch.matmul, TF32 {tf32_ms:.3f} ms, f32 {mm_ms:.3f} ms "
          f"[{card}]", flush=True)
    return dict(max_abs_err=max(max_abs(y, y0), max_abs(ladj, l0)), ms=ms,
                plain_ms=plain_ms, **{**bound, "library_ms": tf32_ms},
                ms_without_b5_rows=bare_ms)


def grads_of(C, chain, x, forward):
    """(gx, {parameter: gradient}) of sum(sin y) + sum(ladj^2)."""
    params = dict(chain.named_parameters())
    xr = x.clone().requires_grad_(True)
    y, ladj = forward(chain, xr)
    gs = torch.autograd.grad(torch.sin(y).sum() + (ladj * ladj).sum(),
                             [xr, *params.values()], allow_unused=True)
    return gs[0], {k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(params.items(), gs[1:])}


def plain_coupling(C, physical_order=False):
    """The plain version through the plan, as a forward function."""
    def forward(chain, x):
        st = C._stack_structure(chain, x.shape[1])
        wbuf, pbuf = C._stack_plan(chain, st, x.dtype, x.device)
        y, ladj = C.coupling_forward_plain(st, wbuf, pbuf, x)
        if not physical_order and not st.identity_out:
            y = y[:, list(st.out_map)]
        return y, ladj
    return forward


def fused_recomputing(C):
    """B4 with B5 as its backward, as fused_coupling_forward_and_ladj, but
    with B4 told not to write B5's rows, so B5 recomputes the forward."""
    def forward(chain, x):
        st = C._stack_structure(chain, x.shape[1])
        wbuf, pbuf = C._stack_plan(chain, st, torch.float32, x.device)
        return C._FusedCoupling.apply(x, wbuf, pbuf, st, False, False)
    return forward


KNOT_EPS = 1e-4


def knot_distance(et, chain, x):
    """Per row of ``x``, the least distance, in a float64 pass, from a
    spline coupling's input to one of its interior knots (inf for a chain
    without a spline coupling)."""
    from enflows_tpu_torch.bijectors.spline import _knots

    chain64 = copy.deepcopy(chain).double()
    dist = torch.full((x.shape[0],), math.inf, dtype=torch.float64,
                      device=x.device)
    t = x.double()
    with torch.no_grad():
        for s in chain64.stages:
            if isinstance(s, et.RQSplineCoupling):
                xb = t[:, s.split:]
                K = s.n_bins
                p = s.conditioner(t[:, :s.split]).reshape(*xb.shape,
                                                          3 * K - 1)
                raw = p[..., K:2 * K] if s.inverted else p[..., :K]
                _, knots = _knots(raw, s.bound, 1e-3)
                near = (xb[..., None] - knots[..., 1:-1]).abs()
                dist = torch.minimum(dist, near.amin(-1).amin(-1))
            t = s(t)
    return dist


def drop_near_knot_rows(et, chain, x):
    """``x`` without the rows where some spline coupling's input passes
    within KNOT_EPS of an interior knot, found by a float64 pass. There f32
    rounding may put the element in either bin: y and ladj are continuous
    across a knot, but ladj's derivative jumps, so a kernel and a plain
    version that pick different bins give gradients that differ by that
    jump times the ladj cotangent, on either side of the float64 answer."""
    bad = knot_distance(et, chain, x) < KNOT_EPS
    return x[~bad].contiguous(), int(bad.sum())


def stored_b5_ms(C, st, x, wbuf, pbuf, gy, gl, iters=3):
    """Milliseconds of B5 on the rows B4 stored, by CUDA events around B5
    alone, the least of ``iters`` after a warm-up. Each call gets a fresh
    store: the sweep overwrites the pre-activations with their
    cotangents."""
    times = []
    for _ in range(iters + 1):
        with torch.no_grad():
            _, _, saved = C._launch_fwd(st, x, wbuf, pbuf, True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        C._launch_bwd(st, x, wbuf, pbuf, gy, gl, saved)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del saved
    return min(times[1:])


def phase_b5(et, C, kind, n, gen, device, card):
    """B5 against plain autograd at the BASELINE config: gx and every
    weight and bias gradient against a float64 plain run under the TF32
    gate, both ways B5 runs: on the rows B4 stored (the trainer's path)
    and recomputing the forward. Both timed."""
    stack = baseline_stack(et, kind, gen, device)
    d = BASELINE["dim"]
    x, dropped = drop_near_knot_rows(
        et, stack, 2.2 * torch.randn(n, d, generator=gen, device=device))
    got = {"stored": grads_of(C, stack, x, C.fused_coupling_forward_and_ladj),
           "recompute": grads_of(C, stack, x, fused_recomputing(C))}
    gx0, g0 = grads_of(C, stack, x, plain_coupling(C))
    with matmul_tf32(True):
        gxt, gt = grads_of(C, stack, x, plain_coupling(C))
    gx64, g64 = grads_of(C, copy.deepcopy(stack).double(), x.double(),
                         plain_coupling(C))
    torch.cuda.synchronize()
    # Per mode: gx's reading, and the gradient nearest its limit.
    held = {}
    for mode, (gx, g) in got.items():
        grads = {k: tf32_gate(g[k], gt[k], g64[k], C_BWD_GATE,
                              f"B5 {kind} ({mode}) grad {k}") for k in g64}
        k = max(grads, key=lambda k: grads[k].share)
        held[mode] = (tf32_gate(gx, gxt, gx64, C_BWD_GATE,
                                f"B5 {kind} ({mode}) gx"), k, grads[k])
    gx, g = got["stored"]
    worst = max([max_abs(gx, gx0)] + [max_abs(g[k], g0[k]) for k in g0])
    del got, g64, gx64, gxt, gt
    # The backward alone: the kernel on a saved forward, the plain version
    # by autograd over a retained graph.
    st = C._stack_structure(stack, d)
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(stack, st, torch.float32, device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
    gy, gl = torch.cos(y), 2.0 * ladj
    params = list(stack.parameters())
    xr = x.clone().requires_grad_(True)
    y0, l0 = plain_coupling(C, physical_order=True)(stack, xr)

    def plain():
        return cuda_ms(lambda: torch.autograd.grad(
            [y0, l0], [xr, *params], [gy, gl], retain_graph=True), iters=3)
    # The trainer's B5 runs on B4's stored rows: that is the kernel's time;
    # B5 recomputing the forward stands beside it. Timed plain, stored,
    # recompute, plain.
    plain_ms = plain()
    ms = stored_b5_ms(C, st, x, wbuf, pbuf, gy, gl)
    recompute_ms = cuda_ms(lambda: C._launch_bwd(st, x, wbuf, pbuf, gy, gl),
                           iters=3)
    plain_ms = min(plain_ms, plain())
    del y0, l0, xr
    n = x.shape[0]
    mm_ms = matmul_only_ms(st, n, device, backward=True)
    tf32_ms = matmul_only_ms(st, n, device, backward=True, tf32=True)
    flops = 2 * conditioner_flops(st) * n
    # x, gy, gl read and gx written; the weights read and their gradient
    # written.
    nbytes = 4 * (n * (3 * d + 1) + 2 * st.w_len)
    bound = bound_of(nbytes, flops, TF32_FLOP_PER_S)
    f32_bound = bound_of(nbytes, flops)["bound_ms"]
    readings = "; ".join(
        f"{mode}: gx {hx}, nearest its limit grad {k} {hk} "
        f"({100 * hk.share:.0f}% of it)"
        for mode, (hx, k, hk) in held.items())
    print(f"[B5] {kind} d={d} 4x{BASELINE['hidden']} n={n} ({dropped} "
          f"rows within {KNOT_EPS} of a spline knot dropped): |kernel - "
          f"f64| on B4's stored rows / recomputing: {readings}; max|kernel "
          f"- plain f32| {worst:.3e}; kernel {ms:.3f} ms on B4's stored "
          f"rows as training runs it ({recompute_ms:.3f} ms recomputing the "
          f"forward); plain autograd backward {plain_ms:.3f} ms, TF32 "
          f"FLOP bound {bound['bound_ms']:.3f} ms (f32 {f32_bound:.3f} ms; "
          f"{flops / 1e9:.1f} GFLOP of dh and dW, the recompute not "
          f"counted) [{card}]", flush=True)
    print(f"[B5] {kind} yardstick: the dh and dW products alone in "
          f"torch.matmul, TF32 {tf32_ms:.3f} ms, f32 {mm_ms:.3f} ms "
          f"[{card}]", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                **{**bound, "library_ms": tf32_ms},
                ms_recomputing=recompute_ms)


# (name, n, make_chain) of the coupling sweep; make_chain(et, gen, device)
# returns the chain.
HALF_CYCLE_8 = (1, 2, 3, 0, 6, 7, 4, 5)   # half-preserving, not involutive


def _vec(d, v, device):
    return torch.full((d,), v, device=device)


def _sweep_affine(act):
    return lambda et, gen, dev: et.coupling_stack(
        gen, 8, 3, (16, 16), activation=act, device=dev)


def _sweep_spline_inverted(et, gen, dev):
    return et.spline_coupling_stack(gen, 16, 3, (32,), n_bins=6, bound=3.0,
                                    activation="silu",
                                    device=dev).inverse()


def _sweep_template(et, gen, dev):
    d = 12
    stack = et.coupling_stack(gen, d, 3, (24, 24), device=dev)
    return et.Chain.of(et.ScaleShift(_vec(d, 1.1, dev), _vec(d, 0.1, dev)),
                       et.JohnsonInv(_vec(d, 0.0, dev), _vec(d, 5.0, dev),
                                     _vec(d, 0.0, dev), _vec(d, 5.0, dev)),
                       *stack.stages,
                       et.ScaleShift(_vec(d, 0.9, dev), _vec(d, -0.1, dev)))


def _sweep_cycle(et, gen, dev):
    a = et.coupling_stack(gen, 8, 2, (16,), activation="tanh", device=dev)
    cyc = et.Permute(HALF_CYCLE_8)
    return et.Chain.of(cyc, a.stages[0], cyc, *a.stages[1:])


def _sweep_mixed(et, gen, dev):
    a = et.coupling_stack(gen, 8, 2, (16, 16), device=dev)
    s = et.spline_coupling_stack(gen, 8, 2, (16,), n_bins=5, bound=3.0,
                                 activation="relu", device=dev)
    return et.Chain.of(*a.stages, et.Permute(HALF_CYCLE_8), *s.stages)


def _sweep_wide(et, gen, dev):
    return et.coupling_stack(gen, 64, 2, (1024, 1024), device=dev)


def _sweep_baseline_widths(et, gen, dev):
    return et.coupling_stack(gen, 64, 2, (512, 512), device=dev)


def _sweep_unpadded(et, gen, dev):
    """d/2 = 5 and hidden widths 20, 12: K and N padded to multiples of 8."""
    return et.coupling_stack(gen, 10, 3, (20, 12), activation="silu",
                             device=dev)


def _sweep_vi_template(kind):
    """coupling_flow_template's tails (ScaleShift, JohnsonInv, ScaleShift)
    around 2 x (512, 512) couplings at d=64: B5's shared memory puts it in
    16-row tiles, as at the VI slice's 4 couplings."""
    return lambda et, gen, dev: et.coupling_flow_template(
        2, (512, 512), kind=kind)(64, gen)


def _sweep_slabs(et, gen, dev):
    """d=40, K=8: the last layer in slabs of 8, 8 and 4 half-lanes."""
    return et.spline_coupling_stack(gen, 40, 2, (24,), n_bins=8, bound=3.0,
                                    device=dev)


COUPLING_SWEEP = [
    ("affine tanh", 3001, _sweep_affine("tanh")),
    ("affine gelu", 3001, _sweep_affine("gelu")),
    ("affine relu", 3001, _sweep_affine("relu")),
    ("affine silu", 3001, _sweep_affine("silu")),
    ("inverted spline", 2007, _sweep_spline_inverted),
    ("ScaleShift/JohnsonInv template", 1234, _sweep_template),
    ("non-involutive Permute", 999, _sweep_cycle),
    ("mixed affine+spline", 4097, _sweep_mixed),
    ("hidden (1024, 1024)", 777, _sweep_wide),
    ("n=5, below one tile", 5, _sweep_affine("gelu")),
    ("(512, 512) at n=1000, not a multiple of 64 rows", 1000,
     _sweep_baseline_widths),
    ("d/2=5, hidden (20, 12): K and N not multiples of 8", 1500,
     _sweep_unpadded),
    ("spline d=40 K=8: a last slab of 4 of 8 half-lanes", 2001,
     _sweep_slabs),
]
# The VI templates' tails at widths that put B5 in 16-row tiles; swept with
# a generator of their own, after the VI slice.
VI_TEMPLATE_SWEEP = [
    ("template tails, affine 2x(512, 512), B5 in 16-row tiles", 3001,
     _sweep_vi_template("affine")),
    ("template tails, spline 2x(512, 512), B5 in 16-row tiles", 2001,
     _sweep_vi_template("spline")),
]


def vjp_run(c, forward, xx, gy, gl, stopped=False):
    """(y, ladj, gx, {parameter: gradient}) of ``forward(c, x)`` for the
    cotangents (gy, gl). ``stopped``: the parameters detached, as STL's
    inverse pass runs them, so only gx is computed."""
    from enflows_tpu_torch.train.vi import _with_stopped_parameters

    xr = xx.clone().requires_grad_(True)
    if stopped:
        y, ladj = _with_stopped_parameters(forward, c, xr)
        ps = {}
    else:
        y, ladj = forward(c, xr)
        ps = dict(c.named_parameters())
    gs = torch.autograd.grad([y, ladj], [xr, *ps.values()],
                             [gy.to(y.dtype), gl.to(y.dtype)])
    return y.detach(), ladj.detach(), gs[0], dict(zip(ps, gs[1:]))


def stopped_gx_equal(C, chain, forward, x, gy, gl, gx, what):
    """B5 with the parameters stopped (no weight-gradient reduction) gives
    the gx it gives with them live, bit for bit."""
    gx_s = vjp_run(chain, forward, x, gy, gl, stopped=True)[2]
    check(torch.equal(gx_s, gx), f"{what}: gx with the parameters stopped "
          f"differs from gx with them live by {max_abs(gx_s, gx):.3e}")


def phase_coupling_sweep(et, C, gen, device, sweep=COUPLING_SWEEP,
                         tag="coupling sweep", b5_tile=None):
    """B4 and B5 (on B4's stored rows and recomputing) against the plain
    version in float64 on small chains at a few thousand rows, with random
    cotangents, under the TF32 gate; and B5 with the parameters stopped
    giving the same gx, both ways. ``b5_tile``: the B5 tile every chain
    must take."""
    nearest = None   # (Held, label) of the reading nearest its limit
    for name, n, build_chain in sweep:
        chain = build_chain(et, gen, device)
        with torch.no_grad():
            for p in chain.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=device))
        d = next(s for s in chain.stages if hasattr(s, "split")).split * 2
        check(C.is_fusible_coupling_stack(chain, d), f"sweep {name} fusible")
        if b5_tile is not None:
            tile = C._pick_tile(C._stack_structure(chain, d), backward=True)
            check(tile == b5_tile, f"sweep {name}: B5 tile {tile}, not "
                  f"{b5_tile}")
        chain64 = copy.deepcopy(chain).double()
        x, _ = drop_near_knot_rows(
            et, chain, 1.5 * torch.randn(n, d, generator=gen, device=device))
        n = x.shape[0]
        gy = torch.randn(n, d, generator=gen, device=device)
        gl = torch.randn(n, generator=gen, device=device)

        def run(c, forward, xx):
            return vjp_run(c, forward, xx, gy, gl)

        got = run(chain, C.fused_coupling_forward_and_ladj, x)
        got_r = run(chain, fused_recomputing(C), x)
        with matmul_tf32(True):
            ref = run(chain, plain_coupling(C), x)
        ref64 = run(chain64, plain_coupling(C), x.double())
        what = f"{name} d={d} n={n}"
        stopped_gx_equal(C, chain, C.fused_coupling_forward_and_ladj, x, gy,
                         gl, got[2], f"{tag} {what} (stored)")
        stopped_gx_equal(C, chain, fused_recomputing(C), x, gy, gl,
                         got_r[2], f"{tag} {what} (recompute)")
        pairs = [(got[0], ref[0], ref64[0], C_FWD_GATE, f"{what} y"),
                 (got[1], ref[1], ref64[1], C_FWD_GATE, f"{what} ladj")]
        for mode, out in (("stored", got), ("recompute", got_r)):
            pairs.append((out[2], ref[2], ref64[2], C_BWD_GATE,
                          f"{what} ({mode}) gx"))
            pairs += [(out[3][k], ref[3][k], ref64[3][k], C_BWD_GATE,
                       f"{what} ({mode}) grad {k}") for k in ref64[3]]
        for *args, label in pairs:
            held = tf32_gate(*args, f"{tag} {label}")
            if nearest is None or held.share > nearest[0].share:
                nearest = (held, label)
    print(f"[{tag}] {len(sweep)} chains "
          f"({', '.join(name for name, _, _ in sweep)}): B4 and B5 "
          f"(on B4's stored rows and recomputing) within the TF32 gate of "
          f"the float64 plain version; nearest its limit: {nearest[1]}, "
          f"|kernel - f64| {nearest[0]} ({100 * nearest[0].share:.0f}% of "
          f"it); B5 with the parameters stopped gives the same gx bit for "
          f"bit in every chain, both ways", flush=True)


def coupling_data(et, n, gen, device):
    """Correlated non-Gaussian data at d=64: z A^T with A = I + 0.3 randn /
    sqrt(64), through a JohnsonInv warp 0.1 sinh(u / 1.5). The small scale
    keeps Adam's first steps, which move every last-layer weight by about
    the learning rate, from throwing the identity-initialized affine stack
    off: at scale 1 its loss ends the 12 steps above where it started."""
    d = BASELINE["dim"]
    A = torch.eye(d, device=device) + 0.3 * torch.randn(
        d, d, generator=gen, device=device) / d ** 0.5
    warp = et.JohnsonInv(_vec(d, 0.0, device), _vec(d, 1.5, device),
                         _vec(d, 0.0, device), _vec(d, 0.1, device))
    with torch.no_grad():
        return warp(torch.randn(n, d, generator=gen, device=device) @ A.T)


def adam(params):
    return torch.optim.Adam(params, lr=1e-3)


def coupling_slice(C, EW, kind, stack, X):
    """The user's path: optimize_whitening of an identity-initialized
    BASELINE stack for 3 epochs of 4 batches, with the launch counters set
    to 0 just before and read just after. Returns (history, launches)."""
    from enflows_tpu_torch.train import optimize_whitening

    reset_launches(C.LAUNCHES, EW.LAUNCHES)
    res = optimize_whitening(X, stack, adam, nbatches=4, nepochs=3)
    hist = res.negll_history.cpu()
    torch.cuda.synchronize()
    launches = {**C.LAUNCHES, **EW.LAUNCHES}
    check(launches["coupling_fwd"] == 12 and launches["coupling_bwd"] == 12,
          f"coupling slice {kind}: launches {launches}, not 12 B4 and 12 B5")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (12,),
          f"coupling slice {kind}: history {hist.tolist()}")
    check(float(hist[-1]) < float(hist[0]),
          f"coupling slice {kind}: negll did not fall: {hist.tolist()}")
    return hist, launches


def rows_permuted_within_batches(X, nbatches, gen):
    """X with the rows of each of its ``nbatches`` batches in another
    order: every step sees the same samples, summed in another order."""
    bs = X.shape[0] // nbatches
    perm = torch.randperm(bs, generator=gen, device=X.device)
    return torch.cat([X[b * bs:(b + 1) * bs][perm] for b in range(nbatches)])


def rel_diff(a, b):
    return float(((a - b).abs() / b.abs()).max())


class NoiseGate(NamedTuple):
    """The coupling slice's history rule: on the steps before the first
    loss spike (a rise of more than 10%) within max(1e-4, 2x the noise),
    all steps within max(1e-3, 8x the noise), the noise being how far runs
    that differ from the reference in rounding alone sit from it."""
    rel: float
    rel_calm: float
    calm: int
    noise: float
    noise_calm: float

    @classmethod
    def of(cls, hist, ref, others):
        rises = [i for i in range(1, len(ref)) if ref[i] > 1.1 * ref[i - 1]]
        calm = rises[0] if rises else len(ref)
        return cls(rel_diff(hist, ref), rel_diff(hist[:calm], ref[:calm]),
                   calm, max(rel_diff(h, ref) for h in others),
                   max(rel_diff(h[:calm], ref[:calm]) for h in others))

    @property
    def limit_calm(self):
        return max(COUPLING_CALM_RTOL, 2 * self.noise_calm)

    @property
    def limit(self):
        return max(COUPLING_SLICE_RTOL, 8 * self.noise)

    def check(self, what):
        check(self.rel_calm <= self.limit_calm,
              f"{what}: first {self.calm} steps fused vs plain TF32 "
              f"{self.rel_calm:.3e}, the plain path's own rounding noise "
              f"{self.noise_calm:.3e}")
        check(self.rel <= self.limit,
              f"{what}: fused vs plain TF32 history {self.rel:.3e}, the "
              f"plain path's own rounding noise {self.noise:.3e}")

    def __str__(self):
        return (f"max rel diff {self.rel:.3e} (limit {self.limit:.3e}; "
                f"first {self.calm} steps {self.rel_calm:.3e}, limit "
                f"{self.limit_calm:.3e}); noise {self.noise:.3e}, first "
                f"{self.calm} steps {self.noise_calm:.3e}")


def coupling_slice_timing(kind, initial, X, hist, gen, card):
    """The same trainer from the same start on the plain path (the chain's
    own autograd), and warm ms/step of both, timed plain, fused, fused,
    plain on the host clock with a synchronize. Then the plain path with
    its products in TF32, as the kernels compute them: the fused history
    is held to that run. The noise yardstick is how far the plain f32 runs
    (on X, and on X with the rows of each batch in another order) sit from
    it, which is how far the training dynamics amplify rounding alone.

    Gates, on the steps before the first loss spike (a rise of more than
    10%): within max(1e-4, 2x the noise), the kernels' 2x slack, so that a
    conditioner in bf16 (8x TF32's unit roundoff) fails. On the whole
    history: within max(1e-3, 8x the noise), as before, since after a
    spike two runs that differ in rounding alone drift apart."""
    from enflows_tpu_torch.train import optimize_whitening

    def train(path, data):
        return optimize_whitening(
            data, copy.deepcopy(initial), adam, nbatches=4, nepochs=3,
            use_fused="coupling" if path == "fused" else False)

    runs = {"plain": [], "fused": []}
    for path in ("plain", "fused", "fused", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = train(path, X).negll_history.cpu()
        runs[path].append(((time.perf_counter() - t0) * 1e3 / 12, h))
    plain = runs["plain"][0][1]
    with matmul_tf32(True):
        ref = train("plain", X).negll_history.cpu()
    others = [plain] + [train("plain", rows_permuted_within_batches(
        X, 4, gen)).negll_history.cpu() for _ in range(2)]
    gate = NoiseGate.of(hist, ref, others)
    rel, rel_calm, calm, noise, noise_calm = gate
    fused_ms = min(t for t, _ in runs["fused"])
    plain_ms = min(t for t, _ in runs["plain"])
    print(f"[coupling slice] {kind}: negll history "
          f"{[round(float(v), 5) for v in hist]}; plain-path history in "
          f"TF32 {[round(float(v), 5) for v in ref]}, in f32 "
          f"{[round(float(v), 5) for v in plain]}; fused vs plain TF32 max "
          f"rel diff {rel:.3e} (first {calm} steps, before any loss spike, "
          f"{rel_calm:.3e}, limit {gate.limit_calm:.3e}); the plain f32 "
          f"path, on X and on rows in another order, vs plain TF32: "
          f"{noise:.3e}, first {calm} steps {noise_calm:.3e}; fused vs "
          f"plain f32 {rel_diff(hist, plain):.3e}; warm ms/step (host "
          f"clock, 2^17 samples): fused {fused_ms:.2f}, plain f32 "
          f"{plain_ms:.2f} [{card}]", flush=True)
    gate.check(f"coupling slice {kind}")
    return dict(fused_ms_per_step=fused_ms, plain_ms_per_step=plain_ms)


def profile_coupling_steps(kind, initial, X, card):
    """Where a fused coupling train step's time goes: ``torch.profiler``
    over one epoch of 4 steps of the trainer (after the runs above warmed
    it up), device time summed by kernel name, and the device's idle share
    of the host-clock wall time."""
    from torch.profiler import ProfilerActivity, profile

    from enflows_tpu_torch.train import optimize_whitening

    flow = copy.deepcopy(initial)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize_whitening(X, flow, adam, nbatches=4, nepochs=1,
                           use_fused="coupling")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, _ = device_kernel_us(prof)
    busy = sum(by_name.values())
    if not busy:
        print(f"[profile] coupling {kind}: no device time in the trace "
              f"(not measured) [{card}]", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] coupling {kind}, 4 fused steps of 2^17 samples: "
          f"wall {wall_us / 4e3:.2f} ms/step, device busy "
          f"{busy / 4e3:.2f} ms/step (idle {100 * (1 - busy / wall_us):.1f}%)"
          f"; by kernel, ms/step: "
          + ", ".join(f"{name[:40]} {us / 4e3:.2f} ({100 * us / busy:.1f}%)"
                      for name, us in top)
          + f" [{card}]", flush=True)


# ----------------------------------------------------------------------
# Flow-VI: optimize_elbo through B1/B2 (the default transport template, an
# elementwise chain with a Householder stage, d=50) and through B4/B5 (the
# coupling template at the BASELINE widths, d=64), with the standard and the
# sticking-the-landing estimator, and the 1-D example.

VI_STEPS, VI_BATCH = 12, 1 << 16     # 2^17 rows a step: antithetic pairs


def vi_target(et, d, gen, device):
    """The batched log density, (n, d) -> (n,), of the pushforward of
    N(0, I_d) through a fixed chain drawn from ``gen``: a JohnsonInv with
    gamma ~ 0.3 N(0, 1), delta in [1.5, 3], xi = 0, lam = 1 (heavy, skewed
    tails), a 4-reflection Householder (correlation), a ScaleShift with a
    in [0.5, 2] and b ~ 0.5 N(0, 1). Normalized, so the nELBO's floor is
    0; plain torch in full f32, not a kernel path."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(d, generator=gen,
                                                   device=device)
    n = lambda s: s * torch.randn(d, generator=gen, device=device)
    truth = et.Chain.of(
        et.JohnsonInv(n(0.3), u(1.5, 3.0), torch.zeros(d, device=device),
                      torch.ones(d, device=device)),
        et.Householder(torch.randn(4, d, generator=gen,
                                   device=device)).canonicalize(),
        et.ScaleShift(u(0.5, 2.0), n(0.5)))
    dist = et.FlowDistribution(truth).requires_grad_(False)

    def logp(z):
        with matmul_tf32(False):
            return dist.logpdf(z)
    return logp


def vi_run(VI, logp, flow, dim, seed, device, nsteps=VI_STEPS, reorder=None,
           **kw):
    """``optimize_elbo`` of ``flow``: ``nsteps`` of 2^16 antithetic pairs
    drawn from a generator seeded ``seed``, so runs with one seed see the
    same draws. With ``reorder`` (a generator), the trainer's steps with
    each step's draws in another row order: the same samples, summed in
    another order."""
    from enflows_tpu_torch.train import optimize_elbo

    key = torch.Generator(device=device).manual_seed(seed)
    if reorder is None:
        return optimize_elbo(logp, flow, dim=dim, batch_size=VI_BATCH,
                             nsteps=nsteps, key=key, **kw)

    def draws(generator, step, batch_size, d, dtype, dev):
        xi = VI._base_draws(generator, step, batch_size, d, dtype, dev)
        return xi[torch.randperm(batch_size, generator=reorder, device=dev)]
    return VI._fit(logp, flow, kw.get("optimizer"), draws, dim=dim,
                   batch_size=VI_BATCH, nsteps=nsteps, antithetic=True,
                   key=key, opt_state=None, nelbo_history=None,
                   dtype=torch.float32,
                   use_fused_coupling=kw["use_fused_coupling"],
                   stl=kw.get("stl", False))


def vi_main_run(VI, counters, what, logp, flow, dim, seed, device, want,
                **kw):
    """The user's path once, with the launch counters set to 0 just before
    and read just after: every history finite, its last value below its
    first, and exactly ``want`` launches. Returns (history, launches, the
    trained flow)."""
    reset_launches(*counters)
    res = vi_run(VI, logp, flow, dim, seed, device, **kw)
    hist = res.nelbo_history.cpu()
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    check(launches == want, f"{what}: launches {launches}, not {want}")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (VI_STEPS,),
          f"{what}: history {hist.tolist()}")
    check(float(hist[-1]) < float(hist[0]),
          f"{what}: nELBO did not fall: {hist.tolist()}")
    return hist, launches, res.result


def vi_timing(VI, what, logp, flow, dim, seed, device, card, **kw):
    """Warm ms/step of the fused and the plain path from the same start on
    the same draws, timed plain, fused, fused, plain on the host clock
    ending in a synchronize; then ``torch.profiler`` over 4 fused steps:
    the card's busy ms/step, device ops a step, device time by kernel and
    the idle share against the unprofiled step. Returns (fused ms, plain
    ms, the first plain history)."""
    from torch.profiler import ProfilerActivity, profile

    runs = {"plain": [], "fused": []}
    for path in ("plain", "fused", "fused", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = vi_run(VI, logp, flow, dim, seed, device,
                   use_fused_coupling=None if path == "fused" else False,
                   **kw).nelbo_history.cpu()
        runs[path].append(((time.perf_counter() - t0) * 1e3 / VI_STEPS, h))
    fused_ms = min(t for t, _ in runs["fused"])
    plain_ms = min(t for t, _ in runs["plain"])
    print(f"[vi timing] {what}: warm ms/step (host clock, 2^17 rows): fused "
          f"{fused_ms:.3f}, plain {plain_ms:.3f} [{card}]", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vi_run(VI, logp, flow, dim, seed, device, nsteps=4, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 4
    by_name, ops = device_kernel_us(prof)
    busy = sum(by_name.values()) / 4e3
    if not busy:
        print(f"[vi profile] {what}: no device time in the trace (not "
              f"measured) [{card}]", flush=True)
    else:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"[vi profile] {what}, 4 fused steps of 2^17 rows: device "
              f"busy {busy:.3f} ms/step in {ops / 4:.0f} device ops a step, "
              f"idle {100 * (1 - busy / fused_ms):.1f}% of the unprofiled "
              f"{fused_ms:.3f} ms/step ({100 * (1 - busy / wall_ms):.1f}% of "
              f"the profiled {wall_ms:.3f}); by kernel, ms/step: "
              + ", ".join(f"{k[:40]} {us / 4e3:.3f} "
                          f"({100 * us / 4e3 / busy:.1f}%)" for k, us in top)
              + f" [{card}]", flush=True)
    return fused_ms, plain_ms, runs["plain"][0][1]


def phase_vi_elementwise(et, EW, C, VI, device, card):
    """``default_flow_template(50)`` fitted by ``optimize_elbo`` with the
    default optimizer, 12 steps of 2^17 rows, once with each estimator:
    every step one B1 and one B2 launch (two of each under STL). Each
    history is held to the plain path's on the same draws within 1e-4
    relative, the whitening slice's gate, unless the plain path on rows
    reordered within each step already differs from it by more; then by
    the coupling slice's noise rule. Returns the launches of each run."""
    gen = torch.Generator(device=device).manual_seed(20)
    logp = vi_target(et, 50, gen, device)
    flow = et.default_flow_template(50, gen)
    out = {}
    for stl in (False, True):
        what = f"vi elementwise d=50 ({'stl' if stl else 'standard'})"
        n = VI_STEPS * (2 if stl else 1)
        hist, out[stl], _ = vi_main_run(
            VI, (EW.LAUNCHES, C.LAUNCHES), what, logp, flow, 50, 21, device,
            dict(fwd=n, bwd=n, negll=0, coupling_fwd=0, coupling_bwd=0),
            stl=stl)
        _, _, plain = vi_timing(VI, what[3:], logp, flow, 50, 21, device,
                                card, stl=stl)
        other = vi_run(VI, logp, flow, 50, 21, device, stl=stl,
                       use_fused_coupling=False,
                       reorder=torch.Generator(device=device).manual_seed(22)
                       ).nelbo_history.cpu()
        rel, noise = rel_diff(hist, plain), rel_diff(other, plain)
        if noise <= SLICE_RTOL:
            check(rel <= SLICE_RTOL, f"{what}: fused vs plain {rel:.3e}")
            rule = f"limit {SLICE_RTOL:.0e}"
        else:
            gate = NoiseGate.of(hist, plain, [other])
            gate.check(what)
            rule = f"the noise rule: {gate}"
        print(f"[{what}] nELBO history {[round(float(v), 4) for v in hist]}"
              f"; plain path {[round(float(v), 4) for v in plain]}; fused vs "
              f"plain max rel diff {rel:.3e}, the plain path on reordered "
              f"rows vs plain {noise:.3e} ({rule}); launches {out[stl]} "
              f"[{card}]", flush=True)
    return out


def b5_stored_at(C, flow, x):
    """(B4 ms writing B5's rows, B5 ms on them, B4's tile, B5's tile) of a
    fusible stack on ``x``, by CUDA events."""
    st = C._stack_structure(flow, x.shape[1])
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(flow, st, torch.float32, x.device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
    b4 = cuda_ms(lambda: C._launch_fwd(st, x, wbuf, pbuf, True), iters=3)
    b5 = stored_b5_ms(C, st, x, wbuf, pbuf, torch.cos(y), 2.0 * ladj)
    return b4, b5, C._pick_tile(st, False), C._pick_tile(st, True)


def template_yardsticks(C, flow, x):
    """A VI template's plain B4 and B5 (autograd over a retained plain
    forward, for the cotangents of ``b5_stored_at``) by CUDA events, and,
    as for the bare stack, its conditioner products alone in TF32
    torch.matmul and the TF32 bounds: {"b4": ..., "b5": ...}, each with
    plain_ms, library_ms, bound_ms and bound_by."""
    n, d = x.shape
    st = C._stack_structure(flow, d)
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(flow, st, torch.float32, x.device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
        plain4 = cuda_ms(lambda: C.coupling_forward_plain(st, wbuf, pbuf, x),
                         iters=3)
    xr = x.clone().requires_grad_(True)
    y0, l0 = plain_coupling(C, physical_order=True)(flow, xr)
    params = list(flow.parameters())
    gy, gl = torch.cos(y), 2.0 * ladj
    plain5 = cuda_ms(lambda: torch.autograd.grad(
        [y0, l0], [xr, *params], [gy, gl], retain_graph=True), iters=3)
    del y0, l0, xr
    flops = conditioner_flops(st) * n
    return {"b4": {**bound_of(4 * (n * (2 * d + 1) + st.w_len), flops,
                              TF32_FLOP_PER_S),
                   "plain_ms": plain4, "library_ms": matmul_only_ms(
                       st, n, x.device, backward=False, tf32=True)},
            "b5": {**bound_of(4 * (n * (3 * d + 1) + 2 * st.w_len),
                              2 * flops, TF32_FLOP_PER_S),
                   "plain_ms": plain5, "library_ms": matmul_only_ms(
                       st, n, x.device, backward=True, tf32=True)}}


def hold_vi_template(et, C, kind, flow, gen, device, card):
    """B4 and B5 on a template that VI trained, at the slice's 2^17 rows and
    tiles, for random cotangents: y, ladj, gx and every parameter gradient
    under the TF32 gate against the plain version run in TF32 and in
    float64; and gx with the parameters stopped (B5 without its
    weight-gradient reduction) equal to gx with them live. For the affine
    template, which VI also runs under STL, the inverse pass as STL runs
    it: the inverted template on the forward's outputs, parameters
    stopped, y, ladj and gx under the gate."""
    d = BASELINE["dim"]
    x, dropped = drop_near_knot_rows(
        et, flow, torch.randn(2 * VI_BATCH, d, generator=gen, device=device))
    cases = [("forward", flow, x, False)]
    if kind == "affine":
        with torch.no_grad():
            z, _ = flow.forward_and_ladj(x)
        cases.append(("inverse, parameters stopped", flow.inverse(), z,
                      True))
    fused = C.fused_coupling_forward_and_ladj
    nearest = None   # (Held, label) of the reading nearest its limit
    for direction, chain, xx, stopped in cases:
        n = xx.shape[0]
        gy = torch.randn(n, d, generator=gen, device=device)
        gl = torch.randn(n, generator=gen, device=device)
        got = vjp_run(chain, fused, xx, gy, gl, stopped)
        with matmul_tf32(True):
            ref = vjp_run(chain, plain_coupling(C), xx, gy, gl, stopped)
        ref64 = vjp_run(copy.deepcopy(chain).double(), plain_coupling(C),
                        xx.double(), gy, gl, stopped)
        what = f"vi template {kind} {direction} n={n}"
        pairs = [(got[0], ref[0], ref64[0], C_FWD_GATE, f"{what} y"),
                 (got[1], ref[1], ref64[1], C_FWD_GATE, f"{what} ladj"),
                 (got[2], ref[2], ref64[2], C_BWD_GATE, f"{what} gx")]
        pairs += [(got[3][k], ref[3][k], ref64[3][k], C_BWD_GATE,
                   f"{what} grad {k}") for k in ref64[3]]
        for *args, label in pairs:
            held = tf32_gate(*args, label)
            if nearest is None or held.share > nearest[0].share:
                nearest = (held, label)
        if not stopped:
            stopped_gx_equal(C, chain, fused, xx, gy, gl, got[2], what)
        del got, ref, ref64
    st = C._stack_structure(flow, d)
    print(f"[vi B5 hold] {kind} template, the trained flow, n={x.shape[0]} "
          f"({dropped} rows within {KNOT_EPS} of a spline knot dropped), B4 "
          f"tile {C._pick_tile(st, False)}, B5 tile {C._pick_tile(st, True)}:"
          f" {' and '.join(c[0] for c in cases)}: y, ladj, gx and every "
          f"parameter gradient within the TF32 gate of the float64 plain "
          f"version; nearest its limit: {nearest[1]}, |kernel - f64| "
          f"{nearest[0]} ({100 * nearest[0].share:.0f}% of it); gx with the "
          f"parameters stopped equal to gx with them live [{card}]",
          flush=True)


def phase_vi_coupling(et, EW, C, VI, device, card):
    """``coupling_flow_template(4, (512, 512), kind)(64)`` with its default
    tails, affine and K=8 spline on [-5, 5], fitted by ``optimize_elbo``
    with adam(1e-3), 12 steps of 2^17 rows (the affine one also with STL):
    every step one B4 and one B5 launch (two of each under STL). Each
    history is held to the plain path run with TF32 products by the
    coupling slice's noise rule. Then each trained template held against
    the plain version at the slice's shapes (``hold_vi_template``), and B4
    and B5 timed at the templates' tiles beside the bare BASELINE stacks'.
    Returns ({kind: {stl: launches}},
    {kind: timing})."""
    gen = torch.Generator(device=device).manual_seed(30)
    logp = vi_target(et, BASELINE["dim"], gen, device)
    d = BASELINE["dim"]
    launches, tiles = {}, {}
    for kind in ("affine", "spline"):
        flow = et.coupling_flow_template(
            BASELINE["n_layers"], BASELINE["hidden"], kind=kind)(d, gen)
        launches[kind] = {}
        for stl in ((False, True) if kind == "affine" else (False,)):
            what = f"vi coupling {kind} ({'stl' if stl else 'standard'})"
            n = VI_STEPS * (2 if stl else 1)
            kw = dict(optimizer=adam, stl=stl)
            hist, launches[kind][stl], trained = vi_main_run(
                VI, (EW.LAUNCHES, C.LAUNCHES), what, logp, flow, d, 31,
                device, dict(fwd=0, bwd=0, negll=0, coupling_fwd=n,
                             coupling_bwd=n), **kw)
            _, _, plain = vi_timing(VI, what[3:], logp, flow, d, 31, device,
                                    card, **kw)
            with matmul_tf32(True):
                ref = vi_run(VI, logp, flow, d, 31, device,
                             use_fused_coupling=False,
                             **kw).nelbo_history.cpu()
            others = [plain] + [vi_run(
                VI, logp, flow, d, 31, device, use_fused_coupling=False,
                reorder=torch.Generator(device=device).manual_seed(32 + i),
                **kw).nelbo_history.cpu()
                for i in range(1 if kind == "spline" else 2)]
            gate = NoiseGate.of(hist, ref, others)
            print(f"[{what}] nELBO history "
                  f"{[round(float(v), 4) for v in hist]}; plain path in TF32 "
                  f"{[round(float(v), 4) for v in ref]}; fused vs plain TF32 "
                  f"{gate} ({len(others)} plain f32 runs); launches "
                  f"{launches[kind][stl]} [{card}]", flush=True)
            gate.check(what)
            if not stl:
                fitted = trained
        # A generator of its own: ``gen`` goes on to make the spline
        # template from the same draws whether or not the hold runs.
        hold_vi_template(et, C, kind, fitted, torch.Generator(
            device=device).manual_seed(34), device, card)
        x = torch.randn(2 * VI_BATCH, d, generator=gen, device=device)
        b4_t, b5_t, t4, t5 = b5_stored_at(C, flow, x)
        b4_0, b5_0, s4, s5 = b5_stored_at(
            C, baseline_stack(et, kind, gen, device), x)
        yard = template_yardsticks(C, flow, x)
        tiles[kind] = dict(ms_vi_template=b5_t, tile_vi_template=t5,
                           b4_ms_vi_template=b4_t, b4_tile_vi_template=t4,
                           yardsticks=yard)
        print(f"[vi B5 tile] {kind} template (ScaleShift, JohnsonInv, "
              f"4x{BASELINE['hidden']}, ScaleShift) n={x.shape[0]}: B4 tile "
              f"{t4} rows, B5 tile {t5} rows; B5 on B4's stored rows "
              f"{b5_t:.3f} ms at the template's {t5}-row tile against "
              f"{b5_0:.3f} ms for the bare BASELINE stack at its {s5}-row "
              f"tile; B4 writing B5's rows {b4_t:.3f} ms ({t4}-row tile) "
              f"against {b4_0:.3f} ms ({s4}-row tile); on the template, "
              + "; ".join(f"{k.upper()} plain {v['plain_ms']:.3f} ms, the "
                          f"products alone in TF32 torch.matmul "
                          f"{v['library_ms']:.3f} ms, TF32 bound "
                          f"{v['bound_ms']:.3f} ms ({v['bound_by']})"
                          for k, v in yard.items()) + f" [{card}]",
              flush=True)
    return launches, tiles


def phase_vi_example(EW, C, device, card):
    """enflows_tpu_torch/examples/nf_variational_1d.py on the card: the JAX
    test's fit (Adagrad(0.2), 800 steps of 100 antithetic pairs, d=1),
    exactly 800 B1 and 800 B2 launches, under the JAX test's gates
    (tests/test_training.py:131-147)."""
    from enflows_tpu_torch.examples import nf_variational_1d as ex

    reset_launches(EW.LAUNCHES, C.LAUNCHES)
    t0 = time.perf_counter()
    res = ex.fit(torch.Generator(device=device).manual_seed(40), nsteps=800,
                 lr=0.2)
    hist = res.nelbo_history.cpu()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 800
    launches = {**EW.LAUNCHES, **C.LAUNCHES}
    check(launches == dict(fwd=800, bwd=800, negll=0, coupling_fwd=0,
                           coupling_bwd=0),
          f"vi example: launches {launches}, not 800 B1 and 800 B2")
    mean, var = ex.pushforward_moments(
        res.result, torch.Generator(device=device).manual_seed(41), n=50000)
    print(f"[vi example] nf_variational_1d: nELBO {float(hist[0]):.4f} -> "
          f"last {float(hist[-1]):.4f}, mean of the last 50 "
          f"{float(hist[-50:].mean()):.4f}; pushforward mean {mean:.4f} "
          f"(true {ex.MEAN_TRUE}), var {var:.4f} (true {ex.VAR_TRUE:.4f}); "
          f"{ms:.3f} ms/step (host clock); launches {launches} [{card}]",
          flush=True)
    check(abs(mean - ex.MEAN_TRUE) < 0.3, f"vi example: mean {mean}")
    check(abs(var - ex.VAR_TRUE) < 1.2, f"vi example: var {var}")
    check(bool(torch.isfinite(hist).all())
          and float(hist[-1]) < float(hist[0]) - 1.0
          and float(hist[-50:].mean()) < 0.5,
          f"vi example: history {hist[:3].tolist()} ... "
          f"{hist[-3:].tolist()}")
    return launches


# ----------------------------------------------------------------------
# Flow-preconditioned HMC: kernel B6 (L leapfrog steps of every chain with
# logp_0 and logp_L, enflows_tpu_torch/ops/csrc/leapfrog.cu), the fused
# sampler and infer's declared-pushforward route.

LF = dict(chains=8192, dim=50, steps=64)   # BASELINE.md:99, bench_mcmc.py:327
LF_TOL = 2e-4
HMC_WARMUP, HMC_SAMPLES = 200, 100


def leapfrog_chain(et, d, gen, device):
    """The BASELINE leapfrog chain (benchmarks/bench_mcmc.py:333-338):
    Johnson(0, 5, 0, 5) o invert(CenterStretch(0, 1, 0)) o a 4-reflection
    Householder, with its reflections drawn from ``gen``."""
    vec = lambda v: torch.full((d,), v, device=device)
    return et.compose(
        et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0)),
        et.invert(et.CenterStretch(vec(0.0), vec(1.0), vec(0.0))),
        et.Householder(torch.randn(4, d, generator=gen,
                                   device=device)).canonicalize())


def leapfrog_bound(n, d, steps, k):
    """q and p read and written, logp_0 and logp_L written; the L + 1
    gradients' products, forward and cotangent, with one Householder stage
    of k reflections (``hh_flops``). The elementwise stages' arithmetic and
    transcendentals are not counted."""
    return bound_of(4 * (4 * n * d + 2 * n),
                    (steps + 1) * 2 * n * hh_flops(d, k))


def hold_leapfrog(TL, chain, q, p, eps, steps, what, elements=None, **kw):
    """B6 against leapfrog_plain on the same inputs: q_L, p_L, logp_0 and
    logp_L each within LF_TOL * max|f64| + LF_TOL of the plain version run
    in float64, or no further from it than twice the float32 plain version
    is. ``elements`` forces B6's elements per lane (default: the wrapper's
    geometry, as ``fused_leapfrog`` runs it). Returns the worst
    |B6 - f64|."""
    if elements is None:
        got = TL.fused_leapfrog(chain, q, p, eps, steps, **kw)
    else:
        got = TL._launch(TL._prepare(chain, q, eps, elements=elements, **kw),
                         q, p, steps)
    ref = TL.leapfrog_plain(chain, q, p, eps, steps, **kw)
    ref64 = TL.leapfrog_plain(copy.deepcopy(chain).double(), q.double(),
                              p.double(), eps, steps,
                              **{k: v.double() for k, v in kw.items()})
    torch.cuda.synchronize()
    return max(close_to_f64(g, r, r64, LF_TOL, f"{what} {name}")
               for g, r, r64, name in zip(got, ref, ref64,
                                          ("q_L", "p_L", "logp_0", "logp_L")))


# B6's special-function evaluations per element and gradient of the
# BASELINE chain between the ends (csrc/leapfrog.cu lf_cc, lf_jf):
# CenterContract 2 exp, 1 log1p, 3 reciprocals; Johnson 1 reciprocal
# square root, 1 log. The two end gradients add log S and log s.
LF_SPECIAL = 8
B6_FIRST_MS = 2.007   # B6's first version at BASELINE (PERF.md), for reference


def ptxas_entries(report, needle):
    """(function, registers, spill store bytes, spill load bytes) of every
    function in nvcc's ``-Xptxas -v`` report whose mangled name holds
    ``needle``."""
    out, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif name and needle in name:
            ent = out.setdefault(name, [None, None, None])
            if "spill stores" in ln:
                words = ln.replace(",", "").split()
                ent[1] = int(words[words.index("spill") - 2])
                ent[2] = int(words[words.index("loads") - 3])
            elif "Used" in ln and "registers" in ln:
                words = ln.replace(",", "").split()
                ent[0] = int(words[words.index("registers") - 1])
    return [(k, *v) for k, v in out.items()]


def b6_geometry(TL, args, n, d):
    """(G, E, block, grid, blocks per SM, registers, local bytes) of B6's
    launch for ``args`` (the card's occupancy query)."""
    import ctypes

    from enflows_tpu_torch.ops._build import load_library

    plan = args.plan
    geo = TL.leapfrog_geometry(n, d, plan.n_stages, n_rows=plan.n_rows,
                               n_smem_slots=plan.n_smem_slots,
                               elements=args.elements)
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = load_library().enf_leapfrog_occupancy(
        geo.E, plan.nreg, geo.block, geo.smem, *map(ctypes.byref, vals))
    check(err == 0, f"B6 occupancy query failed: CUDA error {err}")
    return (geo.G, geo.E, geo.block, geo.grid, *(v.value for v in vals))


def phase_b6(et, TL, gen, device, card, report):
    """B6 against its plain version at the BASELINE leapfrog config, in two
    geometries (the wrapper's, and one chain per warp at E = 2) timed in
    turns against each other and against the plain version; the ptxas
    report of every B6 instantiation (no spills)."""
    n, d, steps = LF["chains"], LF["dim"], LF["steps"]
    chain = leapfrog_chain(et, d, gen, device)
    q = 0.3 * torch.randn(n, d, generator=gen, device=device)
    p = torch.randn(n, d, generator=gen, device=device)
    eps = torch.tensor(0.05, device=device)
    err = hold_leapfrog(TL, chain, q, p, eps, steps, "B6 BASELINE")
    err_alt = hold_leapfrog(TL, chain, q, p, eps, steps, "B6 BASELINE E=2",
                            elements=2)
    args = TL._prepare(chain, q, eps)
    alt = TL._prepare(chain, q, eps, elements=2)
    kernel = lambda: TL._launch(args, q, p, steps)
    kernel_alt = lambda: TL._launch(alt, q, p, steps)
    plain_ms, ms = interleaved_ms(
        lambda: TL.leapfrog_plain(chain, q, p, eps, steps), kernel, iters=5)
    # The two geometries in turns: default, alternative, alternative,
    # default, 20 launches each.
    t = [cuda_ms(f, iters=20) for f in (kernel, kernel_alt, kernel_alt,
                                        kernel)]
    ms_default, ms_alt = min(t[0], t[3]), min(t[1], t[2])
    wrapper_ms = cuda_ms(lambda: TL.fused_leapfrog(chain, q, p, eps, steps),
                         iters=5)
    bound = leapfrog_bound(n, d, steps, 4)   # the chain's 4 reflections
    geos = [b6_geometry(TL, a, n, d) for a in (args, alt)]
    spills = ptxas_entries(report, "leapfrog_kernel")
    check(spills and all(st == 0 and ld == 0 for _, _, st, ld in spills),
          f"B6 spills registers: {spills}")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    special_ms = (LF_SPECIAL * n * d * (steps + 1)
                  / (16 * sms * mhz * 1e6) * 1e3)
    geo_txt = "; ".join(
        f"G={G} E={E} block {blk} grid {grid}: {bps} blocks/SM, {regs} "
        f"registers, {local} local bytes, {t_ms:.4f} ms"
        for (G, E, blk, grid, bps, regs, local), t_ms in
        zip(geos, (ms_default, ms_alt)))
    print(f"[B6] BASELINE chain {n} chains x d={d} x L={steps}: worst "
          f"|B6 - f64| {err:.3e} (q_L, p_L, logp_0, logp_L; E=2 "
          f"{err_alt:.3e}); kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} "
          f"ms) = {n * steps / ms / 1e3:.1f} M leapfrog-steps/s, the first "
          f"version {B6_FIRST_MS} ms (PERF.md), plain {plain_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
          f"geometries in "
          f"turns: {geo_txt}; {LF_SPECIAL} special functions per "
          f"element-gradient = {special_ms:.4f} ms at 16/clock/SM and "
          f"{mhz:.0f} MHz; ptxas: "
          + " | ".join(f"{name} {regs} registers, {st}/{ld} spill bytes"
                       for name, regs, st, ld in spills)
          + f" [{card}]", flush=True)
    return dict(max_abs_err=max(err, err_alt), ms=ms, plain_ms=plain_ms,
                **bound)


LF_SWEEP = [  # (d, n, stages, options); stage codes as in SWEEP
    (2, 1001, ["j", "hh", "cs"], ()),
    (5, 777, ["ss", "hh", "ji", "cc"], ()),
    (128, 600, ["cs", "hh", "j"], ()),
    (300, 500, ["ss", "ji", "cc"], ()),               # elementwise only
    (7, 333, ["j", "hh", "~cs"], ("mass",)),          # diagonal inverse mass
    (6, 444, ["hh", "j", "cc"], ("base",)),           # diagonal-Gaussian base
    (3, 5, ["~hh", "ss", "hh"], ("mass", "base")),    # fewer chains than SMs
    # More runs before Householder stages than B6 holds in registers: the
    # third and fourth in lane-private shared memory.
    (128, 300, ["j", "hh", "cc", "hh", "ji", "hh", "cs", "hh", "ss"], ()),
]


def phase_b6_sweep(et, TL, gen, device):
    """B6 against its plain version (float32 and float64) on other chains,
    widths, a diagonal inverse mass and a diagonal-Gaussian base
    (tests/test_fused_leapfrog.py:138-176); and the refusal of a chain it
    cannot take."""
    worst, paths = 0.0, set()
    for d, n, kinds, opts in LF_SWEEP:
        chain = sweep_chain(et, d, kinds, gen, device)
        check(TL.is_fusible_leapfrog(chain, d), f"B6 sweep d={d} fusible")
        plan = TL.leapfrog_plan(chain, d)
        G, E = TL.lane_group(d)
        paths |= {name for name, hit in (
            ("dense Householder", plan.dense), ("reflections", plan.reflect),
            ("runs in registers", plan.nreg),
            ("runs in shared memory", plan.n_smem_slots),
            ("column tiles", d > G * E), (f"E={E}", True)) if hit}
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(d, generator=gen,
                                                       device=device)
        kw = {}
        if "mass" in opts:
            kw["inv_mass_diag"] = u(0.5, 2.0)
        if "base" in opts:
            kw.update(base_mean=u(-0.5, 0.5), base_var=u(0.5, 1.5))
        q = 0.3 * torch.randn(n, d, generator=gen, device=device)
        p = torch.randn(n, d, generator=gen, device=device)
        worst = max(worst, hold_leapfrog(TL, chain, q, p, 0.02, 8,
                                         f"B6 sweep d={d} {kinds} {opts}",
                                         **kw))
    # JohnsonInv at |v| in (87, 88], where ex2.approx.ftz flushes e^{-|v|}
    # to 0 but e^{|v|} is finite, its output brought back to O(10) so that
    # logp and its gradient stay finite in f32
    # (tests/test_torch_leapfrog.py _johnson_inv_edge).
    v = lambda *a: torch.tensor(a, device=device)
    edge = et.compose(et.JohnsonInv(v(0.0, 0.0), v(1.0, 1.0), v(0.0, 0.0),
                                    v(1.0, 1.0)),
                      et.ScaleShift(v(1e-37, 1e-37), v(0.0, 0.0)))
    q = (v(88.0, -88.0)[None]
         - torch.linspace(0.0, 1.0, 64, device=device)[:, None]).contiguous()
    p = torch.zeros_like(q)
    got = TL.fused_leapfrog(edge, q, p, 1e-3, 2)
    check(all(bool(torch.isfinite(t).all()) for t in got),
          "B6 at the JohnsonInv edge is not finite")
    worst = max(worst, hold_leapfrog(TL, edge, q, p, 1e-3, 2,
                                     "B6 sweep JohnsonInv edge |v| <= 88"))
    wide = sweep_chain(et, 129, ["ss", "hh"], gen, device)
    z = torch.zeros(4, 129, device=device)
    try:
        TL.fused_leapfrog(wide, z, z, 0.1, 2)
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused and not TL.is_fusible_leapfrog(wide, 129),
          "B6 took a Householder chain at d=129")
    want = {"dense Householder", "reflections", "runs in registers",
            "runs in shared memory", "column tiles", "E=1", "E=4"}
    check(want <= paths, f"B6 sweep missed {sorted(want - paths)}")
    print(f"[B6 sweep] {len(LF_SWEEP)} chains, d in "
          f"{sorted({d for d, _, _, _ in LF_SWEEP})}, with a diagonal mass "
          f"and a diagonal-Gaussian base: q_L, p_L, logp_0, logp_L within "
          f"tolerance of the float64 plain version (worst |B6 - f64| "
          f"{worst:.3e}, the JohnsonInv edge at |v| <= 88 included); paths: "
          f"{', '.join(sorted(paths))}; d=129 with a Householder refused",
          flush=True)


def phase_b6_adapted(TL, chain, q, step_size, gen, device, card):
    """B6 against its plain version where the sampler runs it: 8192 chains
    x d=50 x L=64 from the slice's last draws, at the adapted step size and
    at 2/3 of it (the ends of the jitter range). Returns the worst
    |B6 - f64|."""
    worst, lines = 0.0, []
    for scale in (1.0, 2.0 / 3.0):
        eps = step_size * scale
        p = torch.randn(q.shape, generator=gen, device=device)
        err = hold_leapfrog(TL, chain, q, p, eps, LF["steps"],
                            f"B6 at step size {float(eps):.4f}")
        worst = max(worst, err)
        lines.append(f"step size {float(eps):.4f}: worst |B6 - f64| "
                     f"{err:.3e}")
    print(f"[B6 adapted] {len(q)} chains x d={q.shape[1]} x L={LF['steps']} "
          f"from the slice's last draws: {'; '.join(lines)} [{card}]",
          flush=True)
    return worst


def moment_gate(name, draws, transport, base_mean, base_var, gen):
    """Draws against Monte-Carlo truth from the generative definition
    X = T(Z), Z ~ N(mu, diag(var)), 200,000 draws (as
    examples/fused_pushforward_hmc.py:53-64): mean error and sd relative
    error each below 0.1. Returns (mean error, sd relative error)."""
    d = draws.shape[-1]
    with torch.no_grad():
        z = torch.randn(200_000, d, generator=gen, device=draws.device)
        xs = transport(base_mean + torch.sqrt(base_var) * z)
    got = draws.reshape(-1, d)
    mean_err = float((got.mean(0) - xs.mean(0)).abs().max())
    sd_rel = float((got.std(0) / xs.std(0) - 1).abs().max())
    check(mean_err < 0.1 and sd_rel < 0.1,
          f"{name}: mean err {mean_err:.4f}, sd rel err {sd_rel:.4f}")
    return mean_err, sd_rel


def base_of(target, dim, device):
    """(mean, var) of a FlowPushforwardTarget's diagonal-Gaussian base."""
    mu = torch.zeros(dim, device=device) if target.base_mean is None else \
        torch.as_tensor(target.base_mean, device=device)
    var = torch.ones(dim, device=device) if target.base_var is None else \
        torch.as_tensor(target.base_var, device=device)
    return mu, var


def hmc_route(et, TL, name, target, dim, num_chains, num_warmup,
              num_samples, gen, card, **kw):
    """The user's path: infer(target, method='hmc') on a declared
    pushforward, with the launch counters set to 0 just before and read just
    after. One B6 launch per transition. Returns (result, launches)."""
    from enflows_tpu_torch.ops import coupling as C
    from enflows_tpu_torch.ops import elementwise as EW

    check(target.fused_kernel_available(dim), f"{name}: not fusible")
    reset_launches(TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES)
    t0 = time.perf_counter()
    res = et.infer(target, dim=dim, key=gen, method="hmc",
                   num_chains=num_chains, num_warmup=num_warmup,
                   num_samples=num_samples, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**TL.LAUNCHES, **EW.LAUNCHES, **C.LAUNCHES}
    check(launches["leapfrog"] == num_warmup + num_samples,
          f"{name}: launches {launches}, not {num_warmup + num_samples} B6")
    check(res.draws.shape == (num_chains, num_samples, dim)
          and bool(torch.isfinite(res.draws).all()),
          f"{name}: draws {tuple(res.draws.shape)}, finite "
          f"{bool(torch.isfinite(res.draws).all())}")
    acc = res.diagnostics["accept_prob"]
    check(0.6 <= acc <= 1.0, f"{name}: acceptance {acc:.3f}")
    mean_err, sd_rel = moment_gate(name, res.draws, target.transport,
                                   *base_of(target, dim, res.draws.device),
                                   gen)
    print(f"[hmc slice] {name}: infer(method='hmc') {num_chains} chains x "
          f"d={dim}, {num_warmup} warmup + {num_samples} samples: B6 "
          f"launches {launches['leapfrog']} (other kernels "
          f"{ {k: v for k, v in launches.items() if k != 'leapfrog'} }); "
          f"accept {acc:.3f}, step size {float(res.stats.step_size):.4f}, "
          f"mean err {mean_err:.4f}, sd rel err {sd_rel:.4f}, min bulk ESS "
          f"{res.diagnostics['min_bulk_ess']:.0f}, max rhat "
          f"{float(res.diagnostics['rhat'].max()):.4f}; wall {wall:.2f} s "
          f"with the host-side diagnostics [{card}]", flush=True)
    return res, launches


def example_d8(et, gen, device):
    """examples/fused_pushforward_hmc.py:29-46: a rotate, stretch and
    shift/scale transport at d=8 over a N(0.3, diag(linspace(0.8, 1.4)))
    base."""
    dim = 8
    v = lambda val: torch.full((dim,), val, device=device)
    lin = lambda a, b: torch.linspace(a, b, dim, device=device)
    transport = et.compose(
        et.ScaleShift(lin(0.5, 2.0), lin(-1.0, 1.0)),
        et.invert(et.Johnson(v(0.0), v(4.0), v(0.0), v(4.0))),
        et.Householder(torch.randn(4, dim, generator=gen,
                                   device=device)).canonicalize())
    return et.mcmc.FlowPushforwardTarget(transport, base_mean=v(0.3),
                                         base_var=lin(0.8, 1.4))


def hmc_timing(TL, chain, step_size, gen, device, card, transitions=20):
    """ms per transition of the fused sampler against the same sampler over
    leapfrog_plain at the BASELINE config and the slice's adapted step size:
    ``transitions`` warm transitions each, timed plain, fused, fused, plain
    on the host clock ending in a synchronize; then torch.profiler over 5
    fused transitions for the card's busy time, whose idle share is taken
    against the unprofiled ms per transition."""
    from torch.profiler import ProfilerActivity, profile

    from enflows_tpu_torch.mcmc.fused_hmc import _sample

    n, d, steps = LF["chains"], LF["dim"], LF["steps"]
    q0 = 0.1 * torch.randn(n, d, generator=gen, device=device)

    def run(leapfrog, count):
        g = torch.Generator(device=device).manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _sample(leapfrog, chain, g, q0, None, None, num_warmup=0,
                num_samples=count, num_steps=steps, jitter_steps=True,
                initial_step_size=step_size, target_accept=0.8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / count

    sides = {"plain": TL.leapfrog_plain, "fused": TL.fused_leapfrog}
    for lf in sides.values():
        run(lf, 2)
    times = {k: [] for k in sides}
    for k in ("plain", "fused", "fused", "plain"):
        times[k].append(run(sides[k], transitions))
    fused_ms, plain_ms = min(times["fused"]), min(times["plain"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(TL.fused_leapfrog, 5)
    by_name, _ = device_kernel_us(prof)
    busy_ms = sum(by_name.values()) / 1e3 / 5
    b6_ms = sum(us for k, us in by_name.items() if "leapfrog" in k) / 1e3 / 5
    # The idle share is the busy time against the unprofiled transition:
    # the profiler's own host overhead lengthens its wall clock.
    profile_line = (
        f"profiler over 5 fused transitions: device busy {busy_ms:.3f} "
        f"ms/transition (B6 {b6_ms:.3f} ms), idle "
        f"{100 * (1 - busy_ms / fused_ms):.1f}% of the unprofiled "
        f"{fused_ms:.3f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% of the "
        f"profiled wall {wall_ms:.3f} ms)" if busy_ms else
        "profiler: no device time in the trace (not measured)")
    print(f"[hmc timing] {n} chains x d={d} x L={steps}, {transitions} warm "
          f"transitions each (host clock): fused {fused_ms:.3f} ms/transition "
          f"= {n * steps / fused_ms / 1e3:.1f} M leapfrog-steps/s, plain "
          f"{plain_ms:.3f} ms/transition; {profile_line} [{card}]",
          flush=True)
    return dict(fused_ms_per_transition=fused_ms,
                plain_ms_per_transition=plain_ms)


# ----------------------------------------------------------------------
# NUTS and ChEES through sample and infer. No kernel: the JAX tree samplers
# reach no Pallas kernel either (enflows_tpu/mcmc/sample.py:163-169,
# chees.py:318). The card runs the batched density gradients (autograd of
# the plain whitening chain) and the tree bookkeeping.

TREE = dict(chains=8192, warmup=200, samples=100)
# The raw target at 250 + 500 (BASELINE.md:34's row runs 500 + 1000; cut to
# keep the script near 400 s with the SMC phases).
INFER_2D = dict(chains=128, warmup=250, samples=500)        # raw target
INFER_2D_FLOW = dict(chains=128, warmup=200, samples=300)   # flow= route
INFER_PUSHFORWARD = dict(chains=1024, warmup=100, samples=100)
TREE_ACCEPT = {"nuts": (0.6, 1.0), "chees": (0.45, 0.95)}  # test_chees.py:51


def kernel_launches(counters):
    return {k: v for counts in counters for k, v in counts.items()}


def tree_slice(et, NU, algorithm, target, dim, counters, gen, card):
    """``[nuts slice]`` / ``[chees slice]``: ``sample(target,
    algorithm=...)`` at 8192 chains x d=50, 200 warmup + 100 samples, on
    the HMC slice's BASELINE pushforward, with the launch counters set to 0
    just before and read just after: no kernel may launch. Draws finite,
    acceptance within ``TREE_ACCEPT``, mean and sd within 0.1 of
    Monte-Carlo truth (``moment_gate``). Returns (stats, final states)."""
    n, nw, ns = TREE["chains"], TREE["warmup"], TREE["samples"]
    tag = f"[{algorithm} slice]"
    reset_launches(*counters)
    lock0 = dict(NU.LOCKSTEP)
    t0 = time.perf_counter()
    draws, final, stats = et.mcmc.sample(
        target, gen, dim=dim, num_chains=n, num_warmup=nw, num_samples=ns,
        algorithm=algorithm, device=gen.device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(counters)
    check(not any(launches.values()), f"{tag} launched a kernel: {launches}")
    check(draws.shape == (n, ns, dim) and bool(torch.isfinite(draws).all()),
          f"{tag} draws {tuple(draws.shape)}, finite "
          f"{bool(torch.isfinite(draws).all())}")
    acc = float(stats.accept_prob.mean())
    lo, hi = TREE_ACCEPT[algorithm]
    check(lo <= acc <= hi, f"{tag} acceptance {acc:.3f}")
    mean_err, sd_rel = moment_gate(tag, draws, target.transport,
                                   *base_of(target, dim, draws.device), gen)
    if algorithm == "nuts":
        steps = stats.num_steps.double()               # (samples, chains)
        depth = (steps + 1).log2().ceil()
        lock = {k: NU.LOCKSTEP[k] - lock0[k] for k in lock0}
        per = lambda k: lock[k] / lock["transitions"]
        detail = (f"tree depth mean {float(depth.mean()):.3f}, max "
                  f"{float(depth.max()):.0f}; leaves a sampling transition: "
                  f"max over chains {float(steps.max(1).values.mean()):.2f} "
                  f"(largest {float(steps.max()):.0f}), mean "
                  f"{float(steps.mean()):.2f}; over all "
                  f"{lock['transitions']} transitions the lockstep ran "
                  f"{per('leaves'):.2f} leaves in {per('doublings'):.2f} "
                  f"doublings with {per('host_reads'):.2f} host reads a "
                  f"transition")
    else:
        steps = stats.num_steps.double()
        detail = (f"step size {float(stats.step_size):.4f}, trajectory "
                  f"length {float(stats.trajectory_length):.4f}, leapfrog "
                  f"steps a sampling iteration mean {float(steps.mean()):.2f}"
                  f" ({float(steps.min()):.0f}-{float(steps.max()):.0f})")
    print(f"{tag} sample(algorithm={algorithm!r}) {n} chains x d={dim}, "
          f"{nw} warmup + {ns} samples: kernel launches "
          f"{sum(launches.values())}; accept {acc:.3f}, divergences "
          f"{int(stats.divergent.sum())}, mean err {mean_err:.4f}, sd rel "
          f"err {sd_rel:.4f}; {detail}; wall {wall:.2f} s [{card}]",
          flush=True)
    return stats, final


def infer_2d(et, method, through_flow, counters, seed, device, card):
    """``infer(logp, method=...)`` on the 2-D example target of
    benchmarks/bench_mcmc.py:35-44 (BASELINE.md:34's NUTS/ChEES row),
    raw (``precondition=None``, 128 chains x 250 warmup + 500 samples) or
    through its exact transport (``flow=``, 128 x 200 + 300, where the
    chains see N(0, I)). The target has several modes
    that raw chains started near 0 do not cross (the JAX package's own
    NUTS at these counts leaves R-hat far above 1.1 too). So the raw run
    is held to finite draws and the acceptance range, its moments printed;
    the flow run to mean within 0.1 sd and sd within 10% of Monte-Carlo
    truth (200,000 draws). No kernel may launch."""
    f = example_2d_flow(et, device)
    logp = et.FlowDistribution(f).requires_grad_(False).logpdf
    tag = (f"[nuts infer] {method} 2-D example, "
           f"{'flow' if through_flow else 'raw'}")
    reset_launches(*counters)
    t0 = time.perf_counter()
    kw = dict(flow=f) if through_flow else dict(precondition=None)
    sizes = INFER_2D_FLOW if through_flow else INFER_2D
    n, nw, ns = sizes["chains"], sizes["warmup"], sizes["samples"]
    res = et.infer(logp, dim=2, key=torch.Generator(device=device)
                   .manual_seed(seed), method=method, num_chains=n,
                   num_warmup=nw, num_samples=ns, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(counters)
    check(not any(launches.values()), f"{tag}: launched {launches}")
    check(res.draws.shape == (n, ns, 2)
          and bool(torch.isfinite(res.draws).all()),
          f"{tag}: draws {tuple(res.draws.shape)} not finite")
    d = res.diagnostics
    lo, hi = TREE_ACCEPT[method]
    check(lo <= d["accept_prob"] <= hi,
          f"{tag}: acceptance {d['accept_prob']:.3f}")
    with torch.no_grad():
        xs = f(torch.randn(200_000, 2, generator=torch.Generator(
            device=device).manual_seed(seed + 1), device=device))
    sd = xs.std(0)
    got = res.draws.reshape(-1, 2)
    mean_err = float(((got.mean(0) - xs.mean(0)).abs() / sd).max())
    sd_rel = float((got.std(0) / sd - 1).abs().max())
    if through_flow:
        check(mean_err < 0.1 and sd_rel < 0.1,
              f"{tag}: mean err {mean_err:.4f} sd, sd rel err {sd_rel:.4f}")
    print(f"{tag}: {n} chains, {nw} warmup + {ns} samples: "
          f"accept {d['accept_prob']:.3f}, divergences {d['divergences']}, "
          f"mean err {mean_err:.4f} sd, sd rel err {sd_rel:.4f}"
          f"{'' if through_flow else ' (not gated)'}, min bulk ESS "
          f"{d['min_bulk_ess']:.0f}, max rhat {float(d['rhat'].max()):.4f}; "
          f"kernel launches {sum(launches.values())}; wall {wall:.2f} s with "
          f"the host-side diagnostics [{card}]", flush=True)


def infer_pushforward_tree(et, target, dim, counters, gen, card):
    """``infer(target, method='nuts', precondition=None)`` on the BASELINE
    pushforward at 1024 chains x 100 + 100: a declared target with a tree
    method takes ``mcmc.sample``, not the fused HMC route: no B6 launch,
    no launch at all."""
    n, nw, ns = (INFER_PUSHFORWARD[k] for k in ("chains", "warmup",
                                                "samples"))
    reset_launches(*counters)
    t0 = time.perf_counter()
    res = et.infer(target, dim=dim, key=gen, method="nuts",
                   precondition=None, num_chains=n, num_warmup=nw,
                   num_samples=ns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(counters)
    tag = "[nuts infer] nuts BASELINE pushforward"
    check(not any(launches.values()), f"{tag}: launched {launches}")
    check(isinstance(res.stats, et.mcmc.SampleStats),
          f"{tag}: stats {type(res.stats).__name__}, not SampleStats")
    check(res.draws.shape == (n, ns, dim)
          and bool(torch.isfinite(res.draws).all()),
          f"{tag}: draws {tuple(res.draws.shape)} not finite")
    d = res.diagnostics
    mu, var = base_of(target, dim, res.draws.device)
    with torch.no_grad():
        xs = target.transport(mu + torch.sqrt(var) * torch.randn(
            200_000, dim, generator=gen, device=res.draws.device))
    got = res.draws.reshape(-1, dim)
    print(f"{tag}: {n} chains x d={dim}, {nw} warmup + {ns} samples through "
          f"mcmc.sample: B6 launches {launches['leapfrog']}, all kernels "
          f"{sum(launches.values())}; accept {d['accept_prob']:.3f}, "
          f"divergences {d['divergences']}, mean err "
          f"{float((got.mean(0) - xs.mean(0)).abs().max()):.4f}, sd rel err "
          f"{float((got.std(0) / xs.std(0) - 1).abs().max()):.4f} (not "
          f"gated), min bulk ESS {d['min_bulk_ess']:.0f}, max rhat "
          f"{float(d['rhat'].max()):.4f}; wall {wall:.2f} s with the "
          f"host-side diagnostics [{card}]", flush=True)


def tree_timing(et, NU, algorithm, target, stats, final, hmc_ms, card,
                transitions=20):
    """``[nuts timing]`` / ``[chees timing]``: ``transitions`` warm
    transitions from the slice's final states at its adapted step size and
    mass (and trajectory length), on the host clock ending in a synchronize:
    ms a transition, a leaf (NUTS, the lockstep's) or a leapfrog step
    (ChEES), gradient evaluations a second and host reads a transition;
    then ``torch.profiler`` over 5 transitions: the card's busy time, its
    idle share against the unprofiled transition, device ops a leaf or
    step. The fused HMC transition of ``[hmc timing]`` (L=64, B6) stands
    beside them as context."""
    from torch.profiler import ProfilerActivity, profile

    n = final.q.shape[0]
    step, inv_mass = stats.step_size, stats.inv_mass_diag
    kernel = et.mcmc.nuts_kernel(target)

    def run(count, seed):
        """(leaves or leapfrog steps of every chain, host reads) of
        ``count`` transitions from the slice's final states."""
        g = torch.Generator(device=final.q.device).manual_seed(seed)
        if algorithm == "chees":
            out = et.mcmc.run_chains_chees(
                target, final, g, count, step, stats.trajectory_length,
                inv_mass)
            return int(out[2].num_steps.sum()), 1
        lock0 = dict(NU.LOCKSTEP)
        st = final
        for _ in range(count):
            st, _ = kernel(g, st, step, inv_mass)
        return (NU.LOCKSTEP["leaves"] - lock0["leaves"],
                NU.LOCKSTEP["host_reads"] - lock0["host_reads"])

    run(2, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves, reads = run(transitions, 2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / transitions
    per_leaf = ms * transitions / leaves
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        leaves5, _ = run(5, 3)
        torch.cuda.synchronize()
    by_name, ops = device_kernel_us(prof)
    busy = sum(by_name.values()) / 1e3 / 5
    unit, units = (("leaf", "leaves") if algorithm == "nuts" else
                   ("leapfrog step", "leapfrog steps"))
    profile_line = (
        f"profiler over 5 transitions ({leaves5} {units}): device busy "
        f"{busy:.3f} ms a transition, idle {100 * (1 - busy / ms):.1f}% of "
        f"the unprofiled ms (if the 5 run as many {units} as the 20), "
        f"{ops / leaves5:.1f} device ops a {unit}" if busy else
        "profiler: no device time in the trace (not measured)")
    print(f"[{algorithm} timing] {n} chains x d={final.q.shape[1]}, "
          f"{transitions} warm transitions (host clock): {ms:.3f} "
          f"ms/transition, {leaves / transitions:.2f} {units} a transition, "
          f"{per_leaf:.4f} ms a {unit}, "
          f"{n * leaves / (ms * transitions) / 1e3:.3f} M gradient "
          f"evaluations/s, {reads / transitions:.2f} host reads a "
          f"transition; {profile_line}; fused HMC (B6, L=64) "
          f"{hmc_ms:.3f} ms/transition, {hmc_ms / 64:.4f} ms a leapfrog "
          f"step [{card}]", flush=True)
    return dict(ms_per_transition=ms, ms_per_leaf=per_leaf, busy_ms=busy)


# ------------------------------------------------------------------
# Tempered SMC (no kernel on the raw path; the learned transport's fit and
# application run B1 and B2).

# The BASELINE SMC configuration (benchmarks/bench_smc.py:108-117,
# BASELINE.md:36) and the 2-D transport configuration (bench_smc.py:150-169).
SMC = dict(particles=32768, dim=100, mutation_steps=8, leapfrog_steps=10,
           nsteps=100)
SMC_2D = dict(particles=65536, nsteps=60)
SMC_INFER = 65536
SMC_TIMING_TEMPS = 3


def smc_mixture(q):
    """The 100-D bimodal mixture 1/2 N(1.5 1, I) + 1/2 N(-1.5 1, I),
    unnormalized as in bench_smc.py:111-114 (log Z = 50 log 2 pi)."""
    a = -0.5 * ((q - 1.5) ** 2).sum(-1) + math.log(0.5)
    b = -0.5 * ((q + 1.5) ** 2).sum(-1) + math.log(0.5)
    return torch.logaddexp(a, b)


def smc_gauss_2d(q):
    """bench_smc.py:139-143: N((3, -2), 0.25 I), unnormalized (no constant
    tensor: a copy from the host would synchronize every call)."""
    d0, d1 = q[:, 0] - 3.0, q[:, 1] + 2.0
    return -0.5 * (d0 * d0 + d1 * d1) / 0.25


def weighted_moments(parts, lw):
    """(normalized weights, weighted mean, weighted variance), float64."""
    w = torch.softmax(lw.double(), 0)
    x = parts.double()
    mean = w @ x
    return w, mean, w @ (x - mean) ** 2


def smc_run(et, target, dim, n, gen, counters, fit=None, **kw):
    """One ``smc_sample`` run with the launch counters set to 0 just before
    it and read just after: (particles, log weights, log Z, infos,
    launches, wall seconds)."""
    reset_launches(*counters)
    t0 = time.perf_counter()
    parts, lw, logz, infos = et.smc.smc_sample(
        target, gen, dim=dim, num_particles=n, fit_transport=fit, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return parts, lw, logz, infos, kernel_launches(counters), wall


def smc_launch_check(tag, launches, temps, nsteps):
    """No kernel launches without a transport; with one, exactly
    T (nsteps + 1) B1 launches (every fitter step, then the transport on
    all particles) and T nsteps B2 launches, and nothing else."""
    want = {k: 0 for k in launches}
    if nsteps:
        want.update(fwd=temps * (nsteps + 1), bwd=temps * nsteps)
    check(launches == want, f"{tag}: launches {launches}, want {want}")


def smc_mixture_gates(tag, parts, lw, logz, infos):
    """beta reaches 1, draws finite, |log Z - 50 log 2 pi| < 0.5, the
    weighted mass with x_0 > 0 in [0.4, 0.6]. Returns (log Z error, mass)."""
    check(float(infos[-1].beta) == 1.0,
          f"{tag}: beta {float(infos[-1].beta)} after {len(infos)} "
          f"temperatures")
    check(bool(torch.isfinite(parts).all()), f"{tag}: draws not finite")
    err = float(logz) - 0.5 * SMC["dim"] * math.log(2 * math.pi)
    w, _, _ = weighted_moments(parts, lw)
    frac = float((w * (parts[:, 0] > 0)).sum())
    check(abs(err) < 0.5, f"{tag}: log Z error {err:.4f}")
    check(0.4 <= frac <= 0.6, f"{tag}: mass with x_0 > 0 {frac:.4f}")
    return err, frac


def smc_line(tag, what, infos, wall, n, launches, detail, card):
    """The run's line: temperatures, time, particle-temperatures/s, the
    acceptance range, how many temperatures resampled and how many moved
    beta by less than 1e-4 (a temperature that does not resample leaves the
    ESS just above the target, and the next bisection can only creep)."""
    temps = len(infos)
    acc = [float(i.accept_prob) for i in infos]
    resampled = sum(bool(i.resampled) for i in infos)
    betas = [0.0] + [float(i.beta) for i in infos]
    creeping = sum(b1 - b0 < 1e-4 for b0, b1 in zip(betas, betas[1:]))
    print(f"{tag} {what}: {temps} temperatures to beta = 1, wall "
          f"{wall:.3f} s, {wall * 1e3 / temps:.2f} ms a temperature, "
          f"{n * temps / wall / 1e6:.4f} M particle-temperatures/s; "
          f"acceptance {min(acc):.3f}-{max(acc):.3f}, resampled at "
          f"{resampled}, beta moved by less than 1e-4 at {creeping}; kernel "
          f"launches {launches}; {detail} [{card}]", flush=True)


def smc_slice(et, counters, device, card):
    """``[smc slice]``: ``smc_sample`` on the 100-D mixture at 32,768
    particles, mutation_steps=8, 10 leapfrog steps, f32, no transport: no
    kernel launches, and the mixture gates. Then the same run in float64
    (the same gates), to show what the ladder's length owes to float32
    rounding. Returns the f32 run's temperatures and wall seconds."""
    tag, out = "[smc slice]", {}
    for dtype in (torch.float32, torch.float64):
        parts, lw, logz, infos, launches, wall = smc_run(
            et, smc_mixture, SMC["dim"], SMC["particles"],
            torch.Generator(device=device).manual_seed(47), counters,
            mutation_steps=SMC["mutation_steps"],
            leapfrog_steps=SMC["leapfrog_steps"], dtype=dtype)
        smc_launch_check(tag, launches, len(infos), 0)
        err, frac = smc_mixture_gates(tag, parts, lw, logz, infos)
        smc_line(tag, f"{SMC['particles']} particles x d={SMC['dim']}, "
                 f"mutation_steps={SMC['mutation_steps']}, leapfrog "
                 f"{SMC['leapfrog_steps']}, {str(dtype)[6:]}", infos, wall,
                 SMC["particles"], sum(launches.values()),
                 f"log Z error {err:.4f}, mass with x_0 > 0 {frac:.4f}",
                 card)
        out[dtype] = dict(temps=len(infos), wall=wall)
    return out[torch.float32]


def recording_fitter(fit):
    """``fit`` as a user's ``fit_transport`` that keeps its last transport
    and the arguments it was fitted on (for [smc B1/B2 hold])."""
    last = {}

    def fit_transport(key, particles, log_weights, beta, beta_next):
        T = fit(key, particles, log_weights, beta, beta_next)
        last.update(T=T, particles=particles, log_weights=log_weights,
                    beta_next=beta_next)
        return T

    return fit_transport, last


def smc_transport(et, counters, gen, card):
    """``[smc transport]``: the slice's run with the default transport
    fitter (nsteps=100): exactly T (nsteps + 1) B1 and T nsteps B2
    launches, and the mixture gates. Returns the fitter's last inputs."""
    tag = "[smc transport]"
    fit, last = recording_fitter(et.smc.make_transport_fitter(
        et.std_normal_logpdf_sum, smc_mixture, nsteps=SMC["nsteps"]))
    parts, lw, logz, infos, launches, wall = smc_run(
        et, smc_mixture, SMC["dim"], SMC["particles"], gen, counters, fit,
        mutation_steps=SMC["mutation_steps"],
        leapfrog_steps=SMC["leapfrog_steps"])
    smc_launch_check(tag, launches, len(infos), SMC["nsteps"])
    err, frac = smc_mixture_gates(tag, parts, lw, logz, infos)
    smc_line(tag, f"the slice with the default ScaleShift transport, "
             f"nsteps={SMC['nsteps']} (fit on {SMC['particles'] // 2} "
             f"rows, applied to {SMC['particles']})", infos, wall,
             SMC["particles"], launches,
             f"log Z error {err:.4f}, mass with x_0 > 0 {frac:.4f}", card)
    return dict(temps=len(infos), wall=wall, fwd=launches["fwd"],
                bwd=launches["bwd"]), last


def smc_transport_2d(et, counters, device, card):
    """``[smc transport 2d]``: bench_smc.py's 2-D transport configuration
    (65,536 particles, nsteps=60) beside the same run without a transport:
    fewer temperatures with it, exact B1/B2 counts, log Z within 0.1 and
    the weighted mean within 0.05 (tests/test_smc.py:84-105)."""
    tag = "[smc transport 2d]"
    n, nsteps = SMC_2D["particles"], SMC_2D["nsteps"]
    true_logz = math.log(2 * math.pi * 0.25)
    out = {}
    for with_t in (False, True):
        fit = et.smc.make_transport_fitter(
            et.std_normal_logpdf_sum, smc_gauss_2d, nsteps=nsteps) \
            if with_t else None
        gen = torch.Generator(device=device).manual_seed(50)
        parts, lw, logz, infos, launches, wall = smc_run(
            et, smc_gauss_2d, 2, n, gen, counters, fit)
        smc_launch_check(tag, launches, len(infos), nsteps if with_t else 0)
        check(float(infos[-1].beta) == 1.0
              and bool(torch.isfinite(parts).all()),
              f"{tag}: beta {float(infos[-1].beta)}, finite "
              f"{bool(torch.isfinite(parts).all())}")
        _, mean, _ = weighted_moments(parts, lw)
        mean_err = float((mean.cpu() - torch.tensor([3.0, -2.0],
                                                    dtype=torch.float64))
                         .abs().max())
        err = float(logz) - true_logz
        if with_t:
            check(abs(err) < 0.1 and mean_err < 0.05,
                  f"{tag}: log Z error {err:.4f}, mean error "
                  f"{mean_err:.4f}")
        out[with_t] = (len(infos), launches)
        how = f"transport nsteps={nsteps}" if with_t else "no transport"
        smc_line(tag, f"{n} particles x d=2, {how}", infos, wall, n,
                 launches,
                 f"log Z error {err:.4f}, mean error {mean_err:.4f}"
                 f"{'' if with_t else ' (not gated)'}", card)
    check(out[True][0] < out[False][0],
          f"{tag}: {out[True][0]} temperatures with the transport, "
          f"{out[False][0]} without")
    return {"fwd": out[True][1]["fwd"], "bwd": out[True][1]["bwd"]}


def smc_hold(et, EW, last, card):
    """``[smc B1/B2 hold]``: the last fitted 100-D transport on the
    particles it was fitted on: B1 on all 32,768 (the application) and on
    the even 16,384 (the fitter's batch), y and ladj against the plain
    version run in float64 within the [B1] tolerances; B2 on the fitter's
    own cotangents (its loss's, with x wanting a gradient too) at both
    sizes, gx within the [B2] tolerance of the plain f32 run and the
    parameter gradients by ``grads_ok``. Then each kernel timed against
    its plain version (CUDA events, in turns) beside the byte bound.
    Returns {n: {"fwd": ..., "bwd": ...}}."""
    T, beta = last["T"], last["beta_next"]
    x_all = last["particles"].contiguous()
    lw = last["log_weights"]
    d = x_all.shape[1]
    T64 = copy.deepcopy(T).double()
    params, params64 = dict(T.named_parameters()), dict(T64.named_parameters())
    out = {}
    for what, x, w in (
            ("fit batch", x_all[0::2].contiguous(),
             torch.softmax(lw[0::2], 0)),
            ("application", x_all, torch.softmax(lw, 0))):
        n = x.shape[0]

        def loss_of(y, ladj, w=w):
            logp = (1.0 - beta) * et.std_normal_logpdf_sum(y) \
                + beta * smc_mixture(y)
            return -(w.to(y) * (logp + ladj)).sum()

        def grads(chain, xx, forward, ps):
            xr = xx.clone().requires_grad_(True)
            y, ladj = forward(chain, xr)
            gs = torch.autograd.grad(loss_of(y, ladj), [xr, *ps.values()])
            return y.detach(), ladj.detach(), gs[0], dict(zip(ps, gs[1:]))

        y, ladj, gx, g = grads(T, x, EW.fused_forward_and_ladj, params)
        _, _, gx0, g0 = grads(T, x, EW.forward_and_ladj_plain, params)
        y64, l64, _, g64 = grads(T64, x.double(), EW.forward_and_ladj_plain,
                                 params64)
        torch.cuda.synchronize()
        check(torch.allclose(y.double(), y64, rtol=Y_TOL, atol=Y_TOL),
              f"smc B1 y ({what}): max|dy| {max_abs(y.double(), y64):.3e}")
        check(torch.allclose(ladj.double(), l64, rtol=LADJ_TOL,
                             atol=LADJ_TOL),
              f"smc B1 ladj ({what}): {max_abs(ladj.double(), l64):.3e}")
        check(torch.allclose(gx, gx0, rtol=G_RTOL, atol=G_ATOL),
              f"smc B2 gx ({what}): max|diff| {max_abs(gx, gx0):.3e}")
        worst = grads_ok(g, g0, g64)

        with torch.no_grad():
            plan, bufs = EW._chain_plan(T, d, x.device)
            bufs = tuple(b.detach() for b in bufs)
            y1, l1 = EW._launch("fwd", plan, x, bufs)
        yr = y1.clone().requires_grad_(True)
        lr = l1.clone().requires_grad_(True)
        gy, gl = torch.autograd.grad(loss_of(yr, lr), [yr, lr])
        xr = x.clone().requires_grad_(True)
        y0, l0 = EW.forward_and_ladj_plain(T, xr)
        runs = {
            "fwd": (lambda: EW._launch("fwd", plan, x, bufs),
                    lambda: EW.forward_and_ladj_plain(T, x)),
            "bwd": (lambda: EW._launch("bwd", plan, x, bufs, gy, gl),
                    lambda: torch.autograd.grad(
                        [y0, l0], [xr, *params.values()], [gy, gl],
                        retain_graph=True))}
        # At these sizes a call costs the host more than the card, so CUDA
        # events around a run of calls measure the host's rate: the device
        # times come from calls queued behind a sleep, in turns.
        dev_ms, host_ms = {}, {}
        with torch.no_grad():
            for key, (kernel, plain) in runs.items():
                host_ms[key] = interleaved_ms(plain, kernel)
                p1, k1, k2, p2 = (queued_ms(f) for f in (plain, kernel,
                                                         kernel, plain))
                dev_ms[key] = (min(k1, k2), min(p1, p2))
        err_f = max(max_abs(y.double(), y64), max_abs(ladj.double(), l64))
        err_b = max(max_abs(gx, gx0), worst)
        # B1: x read, y and ladj written; B2: x and gy read, gladj read, gx
        # written. A ScaleShift does 2 FLOP an element forward, ~4 back; its
        # log|a| is taken once a column, so no special function runs per
        # element.
        b_fwd = bound_of(4 * n * (2 * d + 1), 2 * n * d)
        b_bwd = bound_of(4 * n * (3 * d + 1), 4 * n * d)
        out[n] = {key: dict(max_abs_err=err, ms=dev_ms[key][0],
                            plain_ms=dev_ms[key][1], **bound)
                  for key, err, bound in (("fwd", err_f, b_fwd),
                                          ("bwd", err_b, b_bwd))}
        timing = "; ".join(
            f"{label} {dev_ms[key][0]:.4f} ms device time (queued; B2 with "
            f"its partial sums), plain {dev_ms[key][1]:.4f}; at the host's "
            f"rate (events around unqueued calls) {host_ms[key][1]:.4f} "
            f"against plain {host_ms[key][0]:.4f}; bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})"
            for label, key, bound in (("B1", "fwd", b_fwd),
                                      ("B2", "bwd", b_bwd)))
        print(f"[smc B1/B2 hold] the fitted ScaleShift at d={d}, n={n} "
              f"({what}): B1 max|dy|, |dladj| vs f64 {err_f:.3e}; B2 "
              f"max|dgx| {max_abs(gx, gx0):.3e}, max|dgrad| {worst:.3e}; "
              f"{timing}; 0 special functions per element; "
              f"{smc_geometry_text(EW, plan, n)} [{card}]",
              flush=True)
    return out


def queued_ms(fn, iters=20, sleep_cycles=50_000_000, attempts=4):
    """Device milliseconds a call of ``fn``: CUDA events around ``iters``
    calls queued behind a sleep kernel, so that the card runs them back to
    back whatever the host's rate. The sleep starts at ``sleep_cycles``
    (~25 ms); when it ended before the host had queued the calls, the next
    attempt sleeps four times the host's measured queueing time, at the
    clock rate the last sleep showed, and queues half as many calls (in
    case the launch queue filled). Fails if no attempt kept the card
    asleep until the calls were queued."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        before, slept, start, end = ev
        before.record()
        torch.cuda._sleep(int(sleep_cycles))
        slept.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms, queued = 1e3 * (time.perf_counter() - t0), iters
        end.record()
        asleep = not slept.query()
        end.synchronize()
        if asleep:
            return start.elapsed_time(end) / iters
        cycles_per_ms = sleep_cycles / max(before.elapsed_time(slept), 1e-3)
        sleep_cycles = max(2 * sleep_cycles, 4 * host_ms * cycles_per_ms)
        iters = max(2, iters // 2)
    check(False, f"queued_ms: in {attempts} attempts the sleep ended before "
          f"the calls were queued (last: {host_ms:.1f} ms to queue "
          f"{queued} calls)")


def smc_geometry_text(EW, plan, n):
    """B1's and B2's launch for ``plan`` at n rows: lanes a sample,
    elements a lane, block, grid, blocks per SM and registers."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = []
    for mode in ("fwd", "bwd"):
        geo = EW.chain_geometry(
            plan, n, mode, lambda b, sm: EW.occupancy(mode, plan.E, b,
                                                      sm)[0], sms)
        bps, regs, _ = EW.occupancy(mode, plan.E, geo.block, geo.smem)
        parts.append(f"{mode} G={plan.G} E={plan.E} block {geo.block} grid "
                     f"{geo.grid}, {bps} blocks/SM, {regs} registers")
    return "; ".join(parts)


def smc_infer(et, counters, device, card):
    """``[smc infer]``: ``infer(method='smc')`` on tests/test_infer.py's
    2-D Gaussian (mean (1.5, -0.5), sd (1, 2)) at 65,536 particles, raw
    and through its exact ``flow=``: no kernel launch, log Z within 0.1,
    the mean within 0.15, weight ESS above 1000."""
    mu = torch.tensor([1.5, -0.5], device=device)
    sd = torch.tensor([1.0, 2.0], device=device)
    logp = lambda q: -0.5 * (((q - mu) / sd) ** 2).sum(-1)
    true_logz = math.log(2 * math.pi) + float(torch.log(sd).sum())
    for through_flow in (False, True):
        tag = f"[smc infer] {'flow' if through_flow else 'raw'}"
        kw = dict(flow=et.ScaleShift(sd.clone(), mu.clone())) \
            if through_flow else dict(precondition=None)
        reset_launches(*counters)
        t0 = time.perf_counter()
        res = et.infer(logp, dim=2, key=torch.Generator(device=device)
                       .manual_seed(60 + through_flow), method="smc",
                       num_particles=SMC_INFER, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches(counters)
        check(not any(launches.values()), f"{tag}: launched {launches}")
        d = res.diagnostics
        mean_err = float(abs(d["mean"] - mu.cpu().numpy()).max())
        err = d["log_z"] - true_logz
        check(res.draws.shape == (SMC_INFER, 2)
              and bool(torch.isfinite(res.draws).all()),
              f"{tag}: draws {tuple(res.draws.shape)} not finite")
        check(abs(err) < 0.1 and mean_err < 0.15 and d["weight_ess"] > 1000,
              f"{tag}: log Z error {err:.4f}, mean error {mean_err:.4f}, "
              f"weight ESS {d['weight_ess']:.0f}")
        print(f"{tag}: infer(method='smc') {SMC_INFER} particles x d=2, "
              f"{len(res.stats)} temperatures: log Z error {err:.4f}, mean "
              f"error {mean_err:.4f}, sd {d['sd'].round(4).tolist()}, weight "
              f"ESS {d['weight_ess']:.0f}; kernel launches "
              f"{sum(launches.values())}; wall {wall:.3f} s [{card}]",
              flush=True)


def smc_timing(et, EW, counters, last, slices, device, card):
    """``[smc timing]``: the slice's configuration, without and with the
    transport, over its first ``SMC_TIMING_TEMPS`` temperatures: ms a
    temperature (host clock ending in a synchronize), host reads a
    temperature (``torch.cuda.set_sync_debug_mode``, a warning for each
    synchronizing call), then ``torch.profiler`` over the same
    temperatures: the card's busy ms and device ops a temperature and its
    idle share against the unprofiled ms. Then the fitter's ms a step at
    the slice's last temperature, through B1/B2 against the plain route
    (100 steps each, timed plain, fused, fused, plain)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from enflows_tpu_torch.smc import flow_transport as TF
    from enflows_tpu_torch.train import vi as VI

    temps = SMC_TIMING_TEMPS
    kw = dict(mutation_steps=SMC["mutation_steps"],
              leapfrog_steps=SMC["leapfrog_steps"], max_temps=temps)
    n, d = SMC["particles"], SMC["dim"]
    for name, nsteps in (("no transport", 0), ("transport", SMC["nsteps"])):
        fit = (et.smc.make_transport_fitter(
            et.std_normal_logpdf_sum, smc_mixture, nsteps=nsteps)
            if nsteps else None)

        def run(seed):
            return smc_run(et, smc_mixture, d, n, torch.Generator(
                device=device).manual_seed(seed), counters, fit, **kw)

        run(70)
        *_, infos, _, wall = run(71)
        check(len(infos) == temps, f"[smc timing] {len(infos)} temperatures")
        ms = wall * 1e3 / temps
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run(72)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        reads = sum("synchroniz" in str(c.message) for c in caught)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(73)
        by_name, ops = device_kernel_us(prof)
        busy = sum(by_name.values()) / 1e3 / temps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        prof_text = (
            f"profiler: device busy {busy:.3f} ms a temperature in "
            f"{ops / temps:.0f} device ops, idle {100 * (1 - busy / ms):.1f}%"
            f" of the unprofiled ms; top kernels (ms a temperature) "
            + ", ".join(f"{k[:36]} {us / 1e3 / temps:.3f}" for k, us in top)
            if busy else "profiler: no device time in the trace (not "
            "measured)")
        full = slices[name]
        print(f"[smc timing] {name}, {n} x d={d}, the first {temps} "
              f"temperatures (host clock): {ms:.2f} ms a temperature, "
              f"{n / ms / 1e3:.4f} M particle-temperatures/s, "
              f"{reads / temps:.2f} host reads a temperature; {prof_text}; "
              f"the whole ladder: {full['temps']} temperatures, "
              f"{full['wall'] * 1e3 / full['temps']:.2f} ms a temperature "
              f"[{card}]", flush=True)

    # The fitter alone, fused against plain, on the slice's last fit.
    args = (et.std_normal_logpdf_sum, smc_mixture, TF.default_optimizer,
            SMC["nsteps"], last["particles"], last["log_weights"],
            last["beta_next"])
    times = {"plain": [], "fused": []}
    hist = {}
    for route in ("plain", "fused", "fused", "plain"):
        forward = (VI._plain_forward if route == "plain"
                   else EW.fused_forward_and_ladj)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = TF._fit(*args, TF.default_template(last["particles"]),
                            forward=forward)
        torch.cuda.synchronize()
        times[route].append((time.perf_counter() - t0) * 1e3 / SMC["nsteps"])
        hist[route] = losses
    rel = float(((hist["fused"] - hist["plain"]).abs()
                 / hist["plain"].abs()).max())
    check(rel <= SLICE_RTOL, f"[smc timing] fitter history fused vs plain "
          f"{rel:.3e}")
    print(f"[smc timing] transport fitter, {SMC['nsteps']} Adam steps on "
          f"{n // 2} x d={d} (host clock): fused (B1 + B2) "
          f"{min(times['fused']):.3f} ms a step, plain "
          f"{min(times['plain']):.3f}; loss histories within {rel:.2e} "
          f"relative [{card}]", flush=True)


def smc_phases(et, EW, counters, device, card):
    """The SMC phases, each main-path run with the launch counters set to 0
    just before it and read just after. Returns B1/B2 launches by path and
    the kernels' times at the SMC shapes."""
    slices = {"no transport": smc_slice(et, counters, device, card)}
    slices["transport"], last = smc_transport(
        et, counters, torch.Generator(device=device).manual_seed(47), card)
    l2d = smc_transport_2d(et, counters, device, card)
    held = smc_hold(et, EW, last, card)
    smc_infer(et, counters, device, card)
    smc_timing(et, EW, counters, last, slices, device, card)

    def path(name, d, n, key):
        apply = f", {n} apply" if key == "fwd" else ""
        return f"{name} (d={d}, n={n // 2} fit{apply})"

    paths = {key: {path("smc transport", SMC["dim"], SMC["particles"], key):
                   slices["transport"][key],
                   path("smc transport 2d", 2, SMC_2D["particles"], key):
                   l2d[key]}
             for key in ("fwd", "bwd")}
    return paths, held


# ------------------------------------------------------------------
# infer's default path: the precondition="auto" ladder, data= and
# refine_rounds. Each call with the launch counters set to 0 just before it
# and read just after; every phase draws from generators of its own.

# BASELINE.json configs[3]: bench_mcmc.py:174-181's equicorrelated Gaussian
# through et.infer(logp, dim=50) with the default ladder, 128 chains.
# NUTS cut from 300 + 500 to 20 + 20 at max_depth=4 (PERF.md §4): the
# ladder's pick between the elementwise and the spline transport turns on
# the seed in both packages, and NUTS through the spline transport runs to
# depth 10, ~120 leaves a transition, at ~36 ms of host work a leaf
# (ROADMAP C-12); the forced spline transport's NUTS too. The
# configuration's NUTS (300 + 500, max_depth 10) runs, gated, through the
# elementwise transport, the family that whitens this target exactly, at 32
# chains.
INFER_50D = dict(dim=50, rho=0.9, chains=128, warmup=20, samples=20,
                 max_depth=4)
INFER_ELEMENTWISE_50D = dict(chains=32, warmup=300, samples=500,
                             max_depth=10)
# tests/test_infer.py:303 and :353; examples/one_call_infer.py case [2];
# test_infer.py:101.
INFER_BIMODAL = dict(vi_steps=200, vi_batch=256, whiten_batches=16,
                     whiten_epochs=8, num_chains=8, num_warmup=100,
                     num_samples=200)
INFER_HARD = dict(vi_steps=5, vi_batch=128, whiten_batches=16,
                  whiten_epochs=8, num_chains=8, num_warmup=150,
                  num_samples=300)
# The example's NUTS (8 chains x 400 + 500) cut to 100 + 200, the bimodal
# test's (200 + 400) to 100 + 200 (PERF.md §4).
INFER_DATA = dict(n=100_000, whiten_batches=200, whiten_epochs=8,
                  num_chains=8, num_warmup=100, num_samples=200)
INFER_REFINE = dict(num_chains=8, num_warmup=300, num_samples=400)
INFER_SEEDS = dict(auto=50, spline=51, elementwise=57, bimodal=52, hard=53,
                   data=55, refine=56)
_LOG_2PI = 1.8378770664093453


def equicorr_logp(d, rho):
    """bench_mcmc.py:174-181's target, -q P q / 2 with P the inverse of
    rho 1 1^T + (1 - rho) I, in closed form, batched."""
    a = 1.0 / (1.0 - rho)
    c = rho / ((1.0 - rho) * (1.0 + (d - 1) * rho))

    def logp(q):
        s = q.sum(-1)
        return -0.5 * (a * (q * q).sum(-1) - c * s * s)
    return logp


def bimodal_2d(w_left, m_left, s_left, w_right, m_right, s_right):
    """tests/test_infer.py:281-294 and :337-350: x0 a two-Gaussian mixture,
    x1 | x0 ~ N(0.5 x0, 0.8^2), batched."""
    def logp(z):
        x0, x1 = z[..., 0], z[..., 1]
        m = torch.logaddexp(
            math.log(w_left) - 0.5 * ((x0 - m_left) / s_left) ** 2
            - math.log(s_left),
            math.log(w_right) - 0.5 * ((x0 - m_right) / s_right) ** 2
            - math.log(s_right)) - 0.5 * _LOG_2PI
        return m - 0.5 * ((x1 - 0.5 * x0) / 0.8) ** 2 - 0.5 * _LOG_2PI \
            - math.log(0.8)
    return logp


class infer_clock:
    """Inside the block, the seconds ``infer`` spends in each part (each
    ending in a synchronize) and the flows its trainers fit, with the rows
    of each step: the VI fits (``optimize_elbo``), the probes
    (``_fit_quality``), the SMC rescue, the ``data=`` whitening, the
    sampling and the host-side diagnostics."""
    PARTS = {"optimize_elbo": "vi fit", "_fit_quality": "probes",
             "_smc_rescue": "rescue", "_whitening_transport": "data fit",
             "sample": "sampling", "_infer_smc": "sampling",
             "summarize_draws": "diagnostics"}

    def __init__(self, TI):
        self.TI = TI
        self.seconds = {}
        self.fits = []          # (trainer, flow, rows a step)

    def _wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            part = self.PARTS.get(name)
            if part is not None:
                self.seconds[part] = self.seconds.get(part, 0.0) \
                    + time.perf_counter() - t0
            if name == "optimize_elbo":
                self.fits.append(("vi", out.result, 2 * k["batch_size"]))
            elif name == "optimize_whitening":
                self.fits.append(("whitening", out.result,
                                  a[0].shape[0] // k["nbatches"]))
            return out
        return timed

    def __enter__(self):
        self.saved = {name: getattr(self.TI, name)
                      for name in (*self.PARTS, "optimize_whitening")}
        for name, fn in self.saved.items():
            setattr(self.TI, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.TI, name, fn)

    def text(self, wall):
        parts = ", ".join(f"{k} {v:.2f}" for k, v in self.seconds.items())
        return f"{wall:.2f} s ({parts})"


def infer_call(et, TI, counters, logp, forbid_mcmc=None, **kw):
    """``et.infer(logp, **kw)`` with the launch counters set to 0 just
    before and read just after. ``forbid_mcmc``: a message; the MCMC
    sampler, if called, fails the run with it (a ladder that was to
    escalate to SMC did not). Returns (result, launches, wall, clock)."""
    real_sample = TI.sample
    if forbid_mcmc is not None:
        def refuse(*a, **k):
            check(False, forbid_mcmc)
        TI.sample = refuse
    try:
        reset_launches(*counters)
        with infer_clock(TI) as clock:
            t0 = time.perf_counter()
            res = et.infer(logp, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_launches(counters)
    finally:
        TI.sample = real_sample
    return res, launches, wall, clock


def expected_launches(C, clock, steps):
    """The launches the dispatch rule gives the fits ``clock`` recorded,
    ``steps[trainer]`` steps each: B1 + B2 a VI step of a fusible chain, B3
    a whitening step of one, B4 + B5 a step of a fusible coupling stack at
    the batches ``coupling_batch_held`` admits, nothing else."""
    want = {"leapfrog": 0, "fwd": 0, "bwd": 0, "negll": 0,
            "coupling_fwd": 0, "coupling_bwd": 0}
    for trainer, flow, rows in clock.fits:
        d = flow_width(flow)
        if C.is_fusible_coupling_stack(flow, d, torch.float32):
            keys = ("coupling_fwd", "coupling_bwd") \
                if C.coupling_batch_held(rows, d) else ()
        elif trainer == "vi":
            keys = ("fwd", "bwd")
        else:
            keys = ("negll",)
        for k in keys:
            want[k] += steps[trainer]
    return want


def launch_text(launches):
    return ", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none"


def infer_50d(et, TI, counters, kind, device, card):
    """``[infer auto 50d]`` (``kind`` None: the default ladder), ``[infer
    spline 50d]`` and ``[infer elementwise 50d]`` (``precondition_kind``):
    the equicorrelated Gaussian at d=50 through ``et.infer(logp, dim=50)``
    with vi_steps=500, vi_batch=512 (1,024 rows a step). Exactly the
    launches the dispatch rule gives the fits (``expected_launches``): 500
    B1 and 500 B2 for the elementwise rung; the spline rung's 1,024 rows
    and the rescue's 40 take the plain path. Draws finite. The auto call
    and the spline one (NUTS 128 x 20 + 20, max_depth=4) print
    the family, k-hat, gap, the draws' mean and sd against 1 (weighted
    where the ladder escalated to SMC), rhat and the tree depths: which
    transport the ladder keeps turns on the seed, and NUTS does not mix
    through the spline one here, in JAX as in the port (ROADMAP C-12). The
    elementwise call runs the configuration's NUTS (300 + 500, max_depth
    10, 32 chains) and holds the mean within 0.1 and the sd within 10% of
    1 in every dimension, and rhat below 1.05; its divergences are printed
    (the reference diverges on ~9% of its transitions here, C-12)."""
    cfg = {**INFER_50D,
           **(INFER_ELEMENTWISE_50D if kind == "elementwise" else {})}
    d = cfg["dim"]
    tag = f"[infer {kind or 'auto'} 50d]"
    kw = dict(max_depth=cfg["max_depth"])
    if kind is not None:
        kw["precondition_kind"] = kind
    res, launches, wall, clock = infer_call(
        et, TI, counters, equicorr_logp(d, cfg["rho"]), dim=d,
        key=torch.Generator(device=device).manual_seed(
            INFER_SEEDS[kind or "auto"]),
        num_chains=cfg["chains"], num_warmup=cfg["warmup"],
        num_samples=cfg["samples"], **kw)
    dg = res.diagnostics
    family = dg["precondition_family"]
    rungs = sum(1 for t, _, _ in clock.fits if t == "vi")
    whitened = sum(1 for t, _, _ in clock.fits if t == "whitening")
    want = expected_launches(et.ops.coupling, clock,
                             {"vi": 500, "whitening": 1000})
    check(launches == want, f"{tag}: launches {launches}, want {want} "
          f"({rungs} rungs, {whitened} rescue)")
    gated = kind == "elementwise"
    if "log_z" in dg:           # escalated to SMC: weighted moments
        mean_err = float(abs(dg["mean"]).max())
        sd_err = float(abs(dg["sd"] - 1.0).max())
        chain_text = (f"SMC on the raw target, {res.draws.shape[0]} "
                      f"particles, log Z {dg['log_z']:.4f}, weight ESS "
                      f"{dg['weight_ess']:.0f}")
    else:
        x = res.draws.reshape(-1, d).double()
        mean_err = float(x.mean(0).abs().max())
        sd_err = float((x.std(0) - 1.0).abs().max())
        rhat = float(dg["rhat"].max())
        steps = res.stats.num_steps.double()
        chain_text = (f"NUTS {cfg['chains']} chains x {cfg['warmup']} + "
                      f"{cfg['samples']} at max_depth {cfg['max_depth']}, "
                      f"max rhat {rhat:.4f}, min bulk ESS "
                      f"{dg['min_bulk_ess']:.0f}, divergences "
                      f"{dg['divergences']} (not gated, ROADMAP C-12), accept"
                      f" {dg['accept_prob']:.3f}, step size "
                      f"{float(res.stats.step_size):.4f}, leaves a "
                      f"transition mean {float(steps.mean()):.1f} max "
                      f"{float(steps.max()):.0f}")
        if gated:
            check(mean_err < 0.1 and sd_err < 0.1 and rhat < 1.05,
                  f"{tag}: mean err {mean_err:.4f}, sd err {sd_err:.4f}, "
                  f"max rhat {rhat:.4f}")
    check(bool(torch.isfinite(res.draws).all()), f"{tag}: draws not finite")
    check(kind is None or family == kind, f"{tag}: family {family}")
    chain_text += (" (gated: mean err < 0.1, sd err < 0.1, rhat < 1.05)"
                   if gated else " (moments not gated: ROADMAP C-12)")
    print(f"{tag} infer(logp, dim={d}, {kw!r}): "
          f"family {family}, k-hat {dg['precondition_khat']:.4f}, gap "
          f"{dg['precondition_coverage_gap']:.4f} after {rungs} rung(s)"
          f"{' and the rescue' if whitened else ''}; launches "
          f"{launch_text(launches)}; {chain_text}: mean err {mean_err:.4f}, "
          f"sd err {sd_err:.4f}; wall {clock.text(wall)} [{card}]",
          flush=True)
    return launches, clock, res


def infer_escalation(et, TI, counters, device, card):
    """``[infer escalation 2d]``: tests/test_infer.py's bimodal target
    (:303, its settings, NUTS cut to 100 + 200) must put 0.12-0.40 of the
    draws right of 0 with the x0 mean within 0.35 of -1.125; its hard
    target (:353, its settings, whiten_batches=16) must end on the SMC
    rescue, which samples the raw target by SMC, with exactly the launches
    the dispatch rule gives (``expected_launches``: 5 B1 and 5 B2 for the
    elementwise rung's VI; the spline rung's 256 rows and the rescue's
    inverted spline take the plain path, ROADMAP C-3). The hard run's share
    of the unweighted final particles right of 0 is printed, not gated
    (ROADMAP C-10). The rescue's whitening at the default whiten_batches
    (40 rows a step) is timed in ``[infer timing]`` and read in the C-3
    sweep."""
    out = {}
    res, launches, wall, clock = infer_call(
        et, TI, counters, bimodal_2d(0.75, -2.0, 0.4, 0.25, 1.5, 0.7),
        dim=2, key=torch.Generator(device=device).manual_seed(
            INFER_SEEDS["bimodal"]), **INFER_BIMODAL)
    x = res.draws.reshape(-1, 2).double()
    frac = float((x[:, 0] > 0).double().mean())
    mean0 = float(x[:, 0].mean())
    dg = res.diagnostics
    check(0.12 < frac < 0.40 and abs(mean0 + 1.125) < 0.35,
          f"[infer escalation 2d] bimodal: frac right {frac:.3f}, x0 mean "
          f"{mean0:.3f} (family {dg['precondition_family']})")
    print(f"[infer escalation 2d] bimodal (test_infer.py:303): family "
          f"{dg['precondition_family']}, k-hat "
          f"{dg['precondition_khat']:.4f}, gap "
          f"{dg['precondition_coverage_gap']:.4f}; frac right {frac:.4f}, x0 "
          f"mean {mean0:.4f}; launches {launch_text(launches)}; wall "
          f"{clock.text(wall)} [{card}]", flush=True)
    out["bimodal"] = (launches, clock)
    batches = INFER_HARD["whiten_batches"]
    tag = f"[infer escalation 2d] hard, whiten_batches={batches}"
    res, launches, wall, clock = infer_call(
        et, TI, counters, bimodal_2d(0.70, -3.0, 0.3, 0.30, 2.5, 0.5),
        forbid_mcmc=f"{tag}: the ladder did not end on the rescue",
        dim=2, key=torch.Generator(device=device).manual_seed(
            INFER_SEEDS["hard"]), **INFER_HARD)
    dg = res.diagnostics
    whiten = batches * INFER_HARD["whiten_epochs"]
    check(dg["precondition_family"] == "smc+spline-whitening"
          and dg.get("method_escalated_to") == "smc",
          f"{tag}: family {dg['precondition_family']}")
    want = expected_launches(et.ops.coupling, clock, {
        "vi": INFER_HARD["vi_steps"], "whitening": whiten})
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    x = res.draws.double()
    frac = float((x[:, 0] > 0).double().mean())
    check(bool(torch.isfinite(x).all()), f"{tag}: draws not finite")
    print(f"{tag} (test_infer.py:353): family "
          f"{dg['precondition_family']}, k-hat "
          f"{dg['precondition_khat']:.4f}, gap "
          f"{dg['precondition_coverage_gap']:.4f}, escalated to "
          f"{dg['method_escalated_to']}; {x.shape[0]} SMC particles, "
          f"weighted x0 mean {dg['mean'][0]:.4f} (mixture -1.35), "
          f"unweighted frac right {frac:.4f} (not gated, C-10), log Z "
          f"{dg['log_z']:.4f}; launches {launch_text(launches)} (the "
          f"rescue's {whiten} whitening steps at {4096 // batches} rows "
          f"and the spline rung's on the plain path, ROADMAP C-3); wall "
          f"{clock.text(wall)} [{card}]",
          flush=True)
    out["hard"] = (launches, clock)
    return out


def infer_data_2d(et, TI, counters, device, card):
    """``[infer data 2d]``: examples/one_call_infer.py's case [2] (the
    bimodal CenterStretch pushforward, 100,000 draws as data) through
    ``infer(data=X, whiten_batches=200, whiten_epochs=8)``: exactly 1,600 B3
    launches (the inverted elementwise template's whitening steps) and no
    other kernel; rhat < 1.05 and the mean within test_infer.py:92-94's
    bound of the data's."""
    cfg = INFER_DATA
    v = lambda *a: torch.tensor(a, device=device)
    f2 = et.compose(et.ScaleShift(v(1.3, 0.4), v(2.5, -1.2)),
                    et.Householder(v(1.0, 0.3)[None]),
                    et.CenterStretch(v(4.0, 4.1), v(2.0, 2.1), v(3.0, 3.1)))
    t2 = et.FlowDistribution(f2).requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(INFER_SEEDS["data"])
    with torch.no_grad():
        X = t2.sample(gen, (cfg["n"],), dim=2)
    res, launches, wall, clock = infer_call(
        et, TI, counters, t2.logpdf, dim=2, key=gen, data=X,
        whiten_batches=cfg["whiten_batches"],
        whiten_epochs=cfg["whiten_epochs"], num_chains=cfg["num_chains"],
        num_warmup=cfg["num_warmup"], num_samples=cfg["num_samples"])
    steps = cfg["whiten_batches"] * cfg["whiten_epochs"]
    check({k: v for k, v in launches.items() if v} == {"negll": steps},
          f"[infer data 2d]: launches {launches}, want {steps} B3")
    dg = res.diagnostics
    true_mean, true_sd = X.double().mean(0), X.double().std(0)
    bound = 5 * float(true_sd.max()) / math.sqrt(dg["min_bulk_ess"]) + 0.05
    mean_err = float((torch.as_tensor(dg["mean"]) - true_mean.cpu())
                     .abs().max())
    rhat = float(dg["rhat"].max())
    check(rhat < 1.05 and mean_err < bound,
          f"[infer data 2d]: rhat {rhat:.4f}, mean err {mean_err:.4f} "
          f"(bound {bound:.4f})")
    print(f"[infer data 2d] one_call_infer.py [2], {cfg['n']} draws, "
          f"whiten_batches={cfg['whiten_batches']}, whiten_epochs="
          f"{cfg['whiten_epochs']}: launches {launch_text(launches)}; max "
          f"rhat {rhat:.4f}, mean err {mean_err:.4f} (bound {bound:.4f}), "
          f"min bulk ESS {dg['min_bulk_ess']:.0f}, divergences "
          f"{dg['divergences']}; wall {clock.text(wall)} [{card}]",
          flush=True)
    return launches, clock, X


def infer_refine(et, TI, counters, device, card):
    """``[infer refine]``: test_infer.py:101's warped heavy-tail target, a raw
    first pass and one refinement round (8 chains x 300 + 400 each): the
    refined round fits a transport (its whitening B3 launches counted),
    rhat < 1.05, mean and sd within the test's bounds of 200,000 draws,
    min bulk ESS above 0.55 x 3,200 draws and above 0.8 x the raw
    round's."""
    v = lambda *a: torch.tensor(a, device=device)
    f_true = et.compose(et.ScaleShift(v(1.3, 0.4), v(2.5, -1.2)),
                        et.JohnsonInv(v(0.5, -0.3), v(2.0, 2.5),
                                      v(0.0, 0.0), v(1.0, 1.5)))
    target = et.FlowDistribution(f_true).requires_grad_(False)
    seed = INFER_SEEDS["refine"]
    raw, _, _, _ = infer_call(
        et, TI, counters, target.logpdf, dim=2, precondition=None,
        key=torch.Generator(device=device).manual_seed(seed), **INFER_REFINE)
    res, launches, wall, clock = infer_call(
        et, TI, counters, target.logpdf, dim=2, precondition=None,
        refine_rounds=1, key=torch.Generator(device=device).manual_seed(seed),
        **INFER_REFINE)
    with torch.no_grad():
        X = target.sample(torch.Generator(device=device).manual_seed(
            seed + 1), (200_000,), dim=2).double().cpu().numpy()
    dg = res.diagnostics
    rhat = float(dg["rhat"].max())
    bound = 5 * X.std(0).max() / math.sqrt(dg["min_bulk_ess"]) + 0.05
    mean_err = float(abs(dg["mean"] - X.mean(0)).max())
    sd_rel = float(abs(dg["sd"] / X.std(0) - 1).max())
    total = INFER_REFINE["num_chains"] * INFER_REFINE["num_samples"]
    ess, raw_ess = dg["min_bulk_ess"], raw.diagnostics["min_bulk_ess"]
    check(res.flow is not None and rhat < 1.05 and mean_err < bound
          and sd_rel < 0.15 and ess > 0.55 * total and ess > 0.8 * raw_ess,
          f"[infer refine]: rhat {rhat:.4f}, mean err {mean_err:.4f} "
          f"(bound {bound:.4f}), sd rel {sd_rel:.4f}, min bulk ESS {ess:.0f}"
          f" (raw {raw_ess:.0f})")
    print(f"[infer refine] test_infer.py:101, refine_rounds=1: launches "
          f"{launch_text(launches)}; max rhat {rhat:.4f}, mean err "
          f"{mean_err:.4f} (bound {bound:.4f}), sd rel err {sd_rel:.4f}, "
          f"min bulk ESS {ess:.0f} against the raw round's {raw_ess:.0f}; "
          f"wall {clock.text(wall)} [{card}]", flush=True)
    return launches, clock


def hold_coupling_flow(et, C, label, flow, d, n, gen, device, card,
                       scale=1.0, enforce=None):
    """``[infer B4/B5 hold]``: B4 and B5 on a coupling flow that a rung, the
    rescue or an affine fit trained, at ``n`` rows: y, ladj, gx and every
    parameter gradient, for random cotangents, against the [B4]/[B5] TF32
    gate (the plain version run in TF32 and in float64, as
    ``hold_vi_template``). ``enforce`` None holds the gate where the
    trainers' dispatch sends such a batch to the kernels
    (``coupling_batch_held``) and reads it elsewhere; False reads it only.
    Inputs ``scale`` x N(0, 1), rows near a spline knot dropped. The
    diagnosis of ROADMAP C-3: the rows where the kernel's gx is further
    from float64 than the plain TF32 run's worst row, and the reverse, with
    their least distance to a knot (``gx_diagnosis``). Returns (the largest
    y / ladj error where held, else 0, and the readings over the gate)."""
    if enforce is None:
        enforce = C.coupling_batch_held(n, d)
    x, dropped = drop_near_knot_rows(
        et, flow, scale * torch.randn(n, d, generator=gen, device=device))
    m = x.shape[0]
    gy = torch.randn(m, d, generator=gen, device=device)
    gl = torch.randn(m, generator=gen, device=device)
    got = vjp_run(flow, C.fused_coupling_forward_and_ladj, x, gy, gl)
    with matmul_tf32(True):
        ref = vjp_run(flow, plain_coupling(C), x, gy, gl)
    ref64 = vjp_run(copy.deepcopy(flow).double(), plain_coupling(C),
                    x.double(), gy, gl)
    pairs = [(got[0], ref[0], ref64[0], C_FWD_GATE, f"{label} y"),
             (got[1], ref[1], ref64[1], C_FWD_GATE, f"{label} ladj"),
             (got[2], ref[2], ref64[2], C_BWD_GATE, f"{label} gx")]
    pairs += [(got[3][k], ref[3][k], ref64[3][k], C_BWD_GATE,
               f"{label} grad {k}") for k in ref64[3]]
    helds = [(tf32_gate(*args, what, enforce), what)
             for *args, what in pairs]
    nearest = max(helds, key=lambda h: h[0].share)
    over = sum(1 for h, _ in helds if h.err > h.limit)
    # C-3's diagnosis: the same gate against the plain version run on the
    # kernels' own TF32-rounded operands, read only.
    with tf32_emulated():
        emu = vjp_run(flow, plain_coupling(C), x, gy, gl)
    emu_pairs = [(got[0], emu[0], ref64[0], C_FWD_GATE),
                 (got[1], emu[1], ref64[1], C_FWD_GATE),
                 (got[2], emu[2], ref64[2], C_BWD_GATE)]
    emu_pairs += [(got[3][k], emu[3][k], ref64[3][k], C_BWD_GATE)
                  for k in ref64[3]]
    emu_helds = [(tf32_gate(*args, what, False), what) for args, (_, what)
                 in zip(emu_pairs, helds)]
    emu_near = max(emu_helds, key=lambda h: h[0].share)
    emu_over = sum(1 for h, _ in emu_helds if h.err > h.limit)
    emu_text = (f"against the plain version on TF32-rounded operands: "
                f"{emu_over} of {len(emu_helds)} over, nearest "
                f"{emu_near[1]} {emu_near[0]} "
                f"({100 * emu_near[0].share:.0f}%)")
    st = C._stack_structure(flow, d)
    verdict = ("within the TF32 gate" if enforce else
               f"read against the TF32 gate, not held: {over} of "
               f"{len(helds)} readings over it")
    print(f"[infer B4/B5 hold] {label}: d={d}, n={m} ({dropped} rows within "
          f"{KNOT_EPS} of a knot dropped), B4 tile "
          f"{C._pick_tile(st, False)}, B5 tile {C._pick_tile(st, True)}: y, "
          f"ladj, gx and {len(ref64[3])} parameter gradients {verdict}; "
          f"nearest its limit: {nearest[1]}, {nearest[0]} "
          f"({100 * nearest[0].share:.0f}%); {emu_text}; "
          f"{gx_diagnosis(et, flow, x, got, ref, ref64)} [{card}]",
          flush=True)
    return (max(h.err for h, _ in helds[:2]) if enforce else 0.0), over, \
        emu_over


def gx_diagnosis(et, flow, x, got, ref, ref64):
    """ROADMAP C-3's reading of one hold: which rows set gx's max error.
    The rows where the kernel's gx is further from float64 than the plain
    TF32 run's worst row, and the reverse, with the largest of their least
    knot distances against the batch's median; and both runs' gx error on
    the half of the rows furthest from a knot."""
    e_k = (got[2].double() - ref64[2]).abs().amax(-1)
    e_t = (ref[2].double() - ref64[2]).abs().amax(-1)
    dist = knot_distance(et, flow, x)
    if not bool(torch.isfinite(dist).any()):
        return (f"gx max error kernel {float(e_k.max()):.3e}, plain TF32 "
                f"{float(e_t.max()):.3e} (no spline)")
    median = dist.median()
    k_over, t_over = e_k > e_t.max(), e_t > e_k.max()
    far = dist >= median
    near = lambda rows: (f"{int(rows.sum())}" + (
        f" (knot distance {float(dist[rows].max()):.2e} or less)"
        if bool(rows.any()) else ""))
    return (f"gx rows the kernel misses by more than the plain TF32 run's "
            f"worst: {near(k_over)}, the reverse: {near(t_over)}; median "
            f"knot distance {float(median):.2e}; on the {int(far.sum())} "
            f"rows at least that far, gx max error kernel "
            f"{float(e_k[far].max()):.3e}, plain TF32 "
            f"{float(e_t[far].max()):.3e}")


def step_ms(run, steps):
    """Milliseconds a step of ``run()`` (``steps`` steps ending in a
    synchronize), on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def fused_against_plain(fused, plain, steps):
    """(fused, plain) ms a step, the smaller of two runs each, timed plain,
    fused, fused, plain."""
    p1, f1, f2, p2 = (step_ms(r, steps) for r in (plain, fused, fused,
                                                   plain))
    return min(f1, f2), min(p1, p2)


def ew_kernel_times(EW, flow, x, mode):
    """Device ms (queued) of B1 ("fwd"), B2 ("bwd", random cotangents) or B3
    ("negll") on ``flow`` at x, against the plain version (B2 as autograd
    over a retained plain forward, B3 as ``negll_value_and_grad_plain``)."""
    n, d = x.shape
    params = list(flow.parameters())
    with torch.no_grad():
        plan, bufs = EW._chain_plan(flow, d, x.device)
        bufs = tuple(b.detach() for b in bufs)
    gen = torch.Generator(device=x.device).manual_seed(9)
    gy = torch.randn(n, d, generator=gen, device=x.device)
    gl = torch.randn(n, generator=gen, device=x.device)
    if mode == "fwd":
        kernel = lambda: EW._launch("fwd", plan, x, bufs)
        plain = lambda: EW.forward_and_ladj_plain(flow, x)
    elif mode == "bwd":
        xr = x.clone().requires_grad_(True)
        y0, l0 = EW.forward_and_ladj_plain(flow, xr)
        kernel = lambda: EW._launch("bwd", plan, x, bufs, gy, gl)
        plain = lambda: torch.autograd.grad([y0, l0], [xr, *params],
                                            [gy, gl], retain_graph=True)
    else:
        kernel = lambda: EW._launch("negll", plan, x, bufs)
        plain = lambda: EW.negll_value_and_grad_plain(flow, x)
    with torch.no_grad() if mode == "fwd" else torch.enable_grad():
        p1, k1, k2, p2 = (queued_ms(f) for f in (plain, kernel, kernel,
                                                 plain))
    return min(k1, k2), min(p1, p2), plan


def coupling_kernel_times(C, flow, x):
    """Ms by CUDA events of B4 writing B5's rows and of B5 on them (a fresh
    store each call: B4 + B5 less B4), against the plain forward and
    autograd over a retained plain forward, and the conditioner products
    alone in TF32 torch.matmul, with the TF32 bounds: {"b4": ..., "b5":
    ...}."""
    n, d = x.shape
    st = C._stack_structure(flow, d)
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(flow, st, torch.float32, x.device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
    gy, gl = torch.cos(y), 2.0 * ladj

    def b4b5():
        _, _, saved = C._launch_fwd(st, x, wbuf, pbuf, True)
        C._launch_bwd(st, x, wbuf, pbuf, gy, gl, saved)

    xr = x.clone().requires_grad_(True)
    y0, l0 = plain_coupling(C, physical_order=True)(flow, xr)
    params = list(flow.parameters())
    gen = torch.Generator(device=x.device).manual_seed(1)
    mats = [(torch.randn(n, K, generator=gen, device=x.device),
             torch.randn(K, N, generator=gen, device=x.device),
             torch.randn(n, N, generator=gen, device=x.device))
            for K, N in st.layers]

    def products(backward):
        for h, W, g in mats:
            if backward:
                torch.matmul(g, W.t())
                torch.matmul(h.t(), g)
            else:
                torch.matmul(h, W)

    # The wrappers read the card's free memory (``_rows_fit``) and sync,
    # so calls cannot queue behind a sleep: CUDA events, paced by the host
    # at these sizes.
    with torch.no_grad():
        b4 = cuda_ms(lambda: C._launch_fwd(st, x, wbuf, pbuf, True))
        both = cuda_ms(b4b5)
        plain4 = cuda_ms(lambda: C.coupling_forward_plain(st, wbuf, pbuf, x))
        with matmul_tf32(True):
            lib4 = cuda_ms(lambda: products(False))
            lib5 = cuda_ms(lambda: products(True))
    plain5 = cuda_ms(lambda: torch.autograd.grad(
        [y0, l0], [xr, *params], [gy, gl], retain_graph=True))
    flops = conditioner_flops(st) * n
    return {"b4": {**bound_of(4 * (n * (2 * d + 1) + st.w_len), flops,
                              TF32_FLOP_PER_S),
                   "ms": b4, "plain_ms": plain4, "library_ms": lib4},
            "b5": {**bound_of(4 * (n * (3 * d + 1) + 2 * st.w_len),
                              2 * flops, TF32_FLOP_PER_S),
                   "ms": both - b4, "plain_ms": plain5, "library_ms": lib5}}


def shape_text(t):
    return (f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} {t['bound_by']}"
            + ("" if t["library_ms"] is None else
               f", TF32 matmul {t['library_ms']:.4f}") + ")")


def infer_timing(et, EW, C, VI, TI, fits, data_x, device, card):
    """``[infer timing]``: ms a step through the kernels (forced for the
    coupling templates, which the dispatch rule sends to the plain path at
    these sizes, ROADMAP C-3) against the plain route forced (host clock,
    plain, fused, fused, plain): a VI step at each rung's shape and a
    whitening step at the rescue's and the data fit's; then each kernel's
    device time at the shapes the infer phases gave it (calls queued behind
    a sleep, ``queued_ms``) on the flows they fitted, against its plain
    version, the bound and, for B4/B5, the conditioner products alone in
    TF32 torch.matmul. Returns {kernel key: {shape: times}}."""
    gen = lambda: torch.Generator(device=device).manual_seed(60)
    rows = []
    for label, d, n, make, logp in (
            ("vi elementwise", 50, 1024, et.default_flow_template,
             equicorr_logp(50, 0.9)),
            ("vi spline", 50, 1024, et.coupling_flow_template(kind="spline"),
             equicorr_logp(50, 0.9)),
            ("vi spline", 2, 512, et.coupling_flow_template(kind="spline"),
             bimodal_2d(0.75, -2.0, 0.4, 0.25, 1.5, 0.7)),
            ("vi spline", 2, 256, et.coupling_flow_template(kind="spline"),
             bimodal_2d(0.70, -3.0, 0.3, 0.30, 2.5, 0.5))):
        flow = make(d, gen())
        kernels = True if label == "vi spline" else None
        run = lambda route: lambda: VI.optimize_elbo(
            logp, flow, dim=d, batch_size=n // 2, nsteps=20, key=gen(),
            use_fused_coupling=route)
        fused, plain = fused_against_plain(run(kernels), run(False), 20)
        rows.append(f"{label} d={d} n={n}: fused {fused:.3f} ms/step, plain "
                    f"{plain:.3f}")
    for label, make, n, nb, ne in (
            ("rescue whitening (inverted spline template)",
             et.coupling_flow_template(kind="spline"), 4000, 100, 1),
            ("rescue whitening (inverted spline template)",
             et.coupling_flow_template(kind="spline"), 4096, 16, 2),
            ("data whitening (inverted elementwise template, B3)",
             et.default_flow_template, 100_000, 200, 1)):
        white = TI._whitening_start(make(2, gen()))
        X = 2.0 * torch.randn(n, 2, generator=gen(), device=device)
        kernels = "coupling" if label.startswith("rescue") else True
        run = lambda route: lambda: et.optimize_whitening(
            X, white, nbatches=nb, nepochs=ne, use_fused=route)
        fused, plain = fused_against_plain(run(kernels), run(False),
                                           nb * ne)
        rows.append(f"{label} d=2 n={n // nb}: fused {fused:.3f} ms/step, "
                    f"plain {plain:.3f}")
    print(f"[infer timing] steps (host clock): {'; '.join(rows)} [{card}]",
          flush=True)

    shapes = {k: {} for k in ("fwd", "bwd", "negll", "coupling_fwd",
                              "coupling_bwd")}
    g = gen()
    by = {}             # the first fit of each (phase, trainer)
    for label, trainer, flow, _ in fits:
        by.setdefault((label, trainer), flow)
    auto = by[("infer auto 50d", "vi")]
    x50 = torch.randn(1024, 50, generator=g, device=device)
    for key in ("fwd", "bwd"):
        ms, plain, _ = ew_kernel_times(EW, auto, x50, key)
        # x (and gy) read, y and ladj (gx) written; the Householder
        # product's multiply-adds, twice in the backward.
        nbytes = 4 * 1024 * ((2 if key == "fwd" else 3) * 50 + 1)
        flops = 1024 * hh_flops(50, 4) * (1 if key == "fwd" else 2)
        shapes[key]["d=50 n=1024 (infer auto 50d)"] = {
            **bound_of(nbytes, flops), "ms": ms, "plain_ms": plain}
    white = by[("infer data 2d", "whitening")]
    x = data_x[:data_x.shape[0] // INFER_DATA["whiten_batches"]]
    ms, plain, _ = ew_kernel_times(EW, white, x, "negll")
    shapes["negll"][f"d=2 n={x.shape[0]} (infer data 2d)"] = {
        **bound_of(4 * x.numel(), 3 * x.shape[0] * hh_flops(2, 2)),
        "ms": ms, "plain_ms": plain}
    seen = set()
    for label, trainer, flow, n in fits:
        d = flow_width(flow)
        inverted = trainer == "whitening"
        if not C.is_fusible_coupling_stack(flow, d, torch.float32) or \
                (d, n, inverted) in seen:
            continue
        seen.add((d, n, inverted))
        t = coupling_kernel_times(C, flow, (2.0 if inverted else 1.0)
                                  * torch.randn(n, d, generator=g,
                                                device=device))
        shape = f"d={d} n={n} ({label} {trainer})"
        shapes["coupling_fwd"][shape] = t["b4"]
        shapes["coupling_bwd"][shape] = t["b5"]
    for key, times in shapes.items():
        how = "CUDA events" if key.startswith("coupling") else \
            "device time, queued"
        print(f"[infer timing] {key} ({how}): "
              + "; ".join(f"{s} {shape_text({'library_ms': None, **t})}"
                          for s, t in times.items()) + f" [{card}]",
              flush=True)
    return shapes


def flow_width(flow):
    """d of a chain whose first stage is a ScaleShift (every template and
    its whitening start)."""
    return flow.stages[0].a.shape[0]


# C-3's sweep: each trained coupling flow read at its own rows and at these.
C3_ROWS = (1024, 4096, 16384, 65536, 1 << 17)


def mixture_draws(n, gen, device):
    """n exact draws of tests/test_infer.py:353's hard target (x0 a 0.70 /
    0.30 mixture of N(-3, 0.3^2) and N(2.5, 0.5^2), x1 | x0 ~ N(0.5 x0,
    0.8^2))."""
    right = torch.rand(n, generator=gen, device=device) < 0.30
    e = torch.randn(n, 2, generator=gen, device=device)
    x0 = torch.where(right, 2.5 + 0.5 * e[:, 0], -3.0 + 0.3 * e[:, 0])
    return torch.stack([x0, 0.5 * x0 + 0.8 * e[:, 1]], -1)


def c3_fits(et, TI, device, splines):
    """The trained coupling flows C-3's sweep reads besides the infer
    phases', fitted by the trainers' dispatch rule: the affine template
    (infer's ``precondition_kind="affine"`` rung) by VI at d=50 on the
    equicorrelated Gaussian (500 steps of 1,024 rows) and at d=2 on the
    hard bimodal target (200 steps of 256 rows), and its whitening start on
    4,096 draws of that target (100 x 2 steps of 40 rows). ``splines``
    (``--infer-probe``): the ladder's spline fits too, standalone: the
    spline rung at d=50 (500 x 1,024 rows) and d=2 (200 x 512 rows on the
    bimodal target), the rescue's inverted spline on the hard target's
    draws (16 x 8 steps of 256 rows, 100 x 2 of 40) and on 4,096 draws of
    the Gaussian (100 x 2 of 40). Returns [(label, trainer, flow, rows)]."""
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    fits = []

    def vi(label, kind, d, logp, batch, steps, seed):
        flow = et.coupling_flow_template(kind=kind)(d, gen(seed))
        out = et.optimize_elbo(logp, flow, dim=d, batch_size=batch,
                               nsteps=steps, key=gen(seed + 1))
        fits.append((label, "vi", out.result, 2 * batch))

    def whiten(label, kind, X, nb, ne, seed):
        white = TI._whitening_start(et.coupling_flow_template(kind=kind)(
            X.shape[1], gen(seed)))
        out = et.optimize_whitening(X, white, nbatches=nb, nepochs=ne)
        fits.append((label, "whitening", out.result, X.shape[0] // nb))

    hard = bimodal_2d(0.70, -3.0, 0.3, 0.30, 2.5, 0.5)
    X2 = mixture_draws(4096, gen(70), device)
    vi("c3 affine 50d", "affine", 50, equicorr_logp(50, 0.9), 512, 500, 71)
    vi("c3 affine 2d", "affine", 2, hard, 128, 200, 73)
    whiten("c3 affine 2d", "affine", X2, 100, 2, 75)
    if splines:
        rho = 0.9
        L = torch.linalg.cholesky(rho * torch.ones(50, 50, device=device)
                                  + (1 - rho) * torch.eye(50, device=device))
        X50 = torch.randn(4096, 50, generator=gen(76), device=device) @ L.T
        vi("c3 spline 50d", "spline", 50, equicorr_logp(50, rho), 512, 500,
           77)
        vi("c3 spline 2d", "spline", 2,
           bimodal_2d(0.75, -2.0, 0.4, 0.25, 1.5, 0.7), 256, 200, 79)
        whiten("c3 spline 2d", "spline", X2, 16, 8, 81)
        whiten("c3 spline 2d", "spline", X2, 100, 2, 83)
        whiten("c3 spline 50d", "spline", X50, 100, 2, 85)
        for kind in ("affine", "spline"):
            flow = et.coupling_flow_template(kind=kind, hidden=(512, 512))(
                50, gen(87))
            out = et.optimize_elbo(equicorr_logp(50, rho), flow, dim=50,
                                   batch_size=512, nsteps=100, key=gen(88))
            fits.append((f"c3 {kind} 50d (512, 512)", "vi", out.result,
                         1024))
    return fits


def c3_sweep(et, C, fits, device, card, enforce=None, sizes=C3_ROWS):
    """B4 and B5 held (``hold_coupling_flow``) on each trained coupling flow
    of ``fits`` at its own rows and at ``sizes``; ``enforce`` None holds the
    gate where the dispatch rule sends such batches to the kernels, False
    reads it only. Prints each flow's readings over the gate by rows.
    Returns the largest y / ladj error where held."""
    g = torch.Generator(device=device).manual_seed(61)
    worst, table = 0.0, []
    for label, trainer, flow, n in fits:
        d = flow_width(flow)
        if not C.is_fusible_coupling_stack(flow, d, torch.float32):
            continue
        overs = []
        for rows in sorted({n, *sizes}):
            err, over, emu_over = hold_coupling_flow(
                et, C, f"{label} {trainer} at {rows} rows", flow, d, rows, g,
                device, card, scale=2.0 if trainer == "whitening" else 1.0,
                enforce=enforce)
            worst = max(worst, err)
            overs.append(f"{rows}: {over} ({emu_over})")
        table.append(f"{label} {trainer} (trained at {n} rows) "
                     f"{', '.join(overs)}")
    print("[infer B4/B5 hold] readings over the TF32 gate by rows (over it "
          "against the plain version on TF32-rounded operands): "
          + "; ".join(table) + f" [{card}]", flush=True)
    return worst


def infer_phases(et, EW, C, counters, device, card):
    """The infer phases, then the B4/B5 hold and sweep on every coupling
    flow they and ``c3_fits`` trained (C-3) and ``[infer timing]``. Returns
    (launches by path, the kernels' times at the new shapes by launch key,
    the worst B4/B5 y / ladj error where held)."""
    import importlib
    from enflows_tpu_torch.train import vi as VI
    TI = importlib.import_module("enflows_tpu_torch.infer")
    runs, fits = {}, []

    def keep(label, shape, launches, clock):
        runs[f"{label} ({shape})"] = launches
        fits.extend((label, *fit) for fit in clock.fits)

    for kind in (None, "spline", "elementwise"):
        launches, clock, _ = infer_50d(et, TI, counters, kind, device, card)
        keep(f"infer {kind or 'auto'} 50d", "d=50, vi n=1024", launches,
             clock)
    shapes = {"bimodal": "d=2, vi n=512",
              "hard": "d=2, vi n=256, whitening n=256"}
    for name, (launches, clock) in infer_escalation(
            et, TI, counters, device, card).items():
        keep(f"infer escalation 2d {name}", shapes[name], launches, clock)
    launches, clock, data_x = infer_data_2d(et, TI, counters, device, card)
    keep("infer data 2d", "d=2, whitening n=500", launches, clock)
    launches, clock = infer_refine(et, TI, counters, device, card)
    keep("infer refine", "d=2, whitening n=32", launches, clock)

    # C-3: B4/B5 on every coupling flow trained above and on the affine
    # fits, at its own rows (read) and at 2^17 rows (held at d=50; the
    # sweep over 2^10-2^17 is --infer-probe's).
    fits += c3_fits(et, TI, device, splines=False)
    worst = c3_sweep(et, C, fits, device, card, sizes=(1 << 17,))
    times = infer_timing(et, EW, C, VI, TI, fits, data_x, device, card)
    return runs, times, worst


def infer_probe(et, C, device, card):
    """``--infer-probe``: the C-3 sweep alone, on ``c3_fits``'s flows with
    the ladder's spline fits made standalone, every reading printed and
    none held; then ``[infer elementwise 50d]``."""
    import importlib
    TI = importlib.import_module("enflows_tpu_torch.infer")
    t0 = time.perf_counter()
    fits = c3_fits(et, TI, device, splines=True)
    print(f"[infer probe] fits {time.perf_counter() - t0:.1f} s", flush=True)
    c3_sweep(et, C, fits, device, card, enforce=False)
    from enflows_tpu_torch.ops import elementwise as EW
    from enflows_tpu_torch.ops import leapfrog as TL
    infer_50d(et, TI, (TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES), "elementwise",
              device, card)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available()"
                         " is False)")
    sys.path.insert(0, HERE)
    import enflows_tpu_torch as et
    from enflows_tpu_torch.ops import coupling as C
    from enflows_tpu_torch.ops import elementwise as EW
    from enflows_tpu_torch.ops import leapfrog as TL
    from enflows_tpu_torch.ops._build import build, load_library
    from enflows_tpu_torch.train import optimize_whitening

    pkg = os.path.dirname(os.path.abspath(et.__file__))
    check(pkg.startswith(HERE + os.sep),
          f"enflows_tpu_torch imported from {pkg}, not from this checkout")
    # The plain references run in full f32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = nvidia_smi_line()
    print(f"[gpu] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    so, seconds, report = build()
    load_library()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {seconds:.1f} s -> {os.path.relpath(so, HERE)}; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)
    ew_ptxas(report)
    if "--infer-probe" in sys.argv[1:]:
        infer_probe(et, C, device, smi)
        print(f"[time] chip_smoke.py --infer-probe "
              f"{time.perf_counter() - t_start:.1f} s [{smi}]", flush=True)
        raise SystemExit(0)

    gen = torch.Generator(device=device).manual_seed(0)
    b1 = phase_b1(et, EW, 2, 1 << 24, gen, device, smi)
    phase_b1(et, EW, 50, 1 << 17, gen, device, smi)
    b2 = phase_b2(et, EW, 2, 1 << 22, gen, device, smi)
    b3 = phase_b3(et, EW, 2, 1 << 22, gen, device, smi)
    # The slice's batch; the phases that earlier versions of this script
    # did not have draw from generators of their own, so that every other
    # phase sees the inputs it always saw.
    phase_b3(et, EW, 2, 1 << 20, torch.Generator(device=device).manual_seed(6),
             device, smi)
    phase_sweep(et, EW, gen, device)
    phase_corners(et, EW, device)
    phase_b3(et, EW, 50, 1 << 17, gen, device, smi)

    # The slice. Data and models are made before the counters are reset.
    f_true, model_2d = example_2d(et, gen, device)
    with torch.no_grad():
        X = f_true(torch.randn(1 << 22, 2, generator=gen, device=device))
    models = {"example_2d": model_2d,
              "flagship": flagship_flow(et, 2, gen, device)}
    initial = {k: copy.deepcopy(m) for k, m in models.items()}
    reset_launches(EW.LAUNCHES)
    hists = {k: train_and_evaluate(et, EW, k, m, X)
             for k, m in models.items()}
    torch.cuda.synchronize()
    launches = dict(EW.LAUNCHES)
    print(f"[launches] main path: {launches}", flush=True)
    check(all(launches[k] > 0 for k in ("fwd", "bwd", "negll")),
          f"a kernel of the path was not launched: {launches}")

    for k, m in initial.items():
        # Warm trainer runs from the same start, timed plain, fused, fused,
        # plain on the host clock (each run ends in a synchronize).
        runs = {"plain": [], "fused": []}
        for path in ("plain", "fused", "fused", "plain"):
            flow = copy.deepcopy(m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = optimize_whitening(X, flow, nbatches=4, nepochs=3,
                                   use_fused=path == "fused")
            hist = r.negll_history.cpu()
            runs[path].append(((time.perf_counter() - t0) * 1e3 / 12, hist))
        plain = runs["plain"][0][1]
        rel = float(((hists[k] - plain).abs() / plain.abs()).max())
        fused_step = min(t for t, _ in runs["fused"])
        print(f"[slice] {k}: plain-path history "
              f"{[round(float(h), 5) for h in plain]}; max rel diff "
              f"{rel:.3e}; warm ms/step (host clock, 2^20 samples): fused "
              f"{fused_step:.3f}, plain "
              f"{min(t for t, _ in runs['plain']):.3f} [{smi}]", flush=True)
        check(rel <= SLICE_RTOL, f"{k}: fused vs plain history {rel:.3e}")
        profile_whitening_steps(k, m, X, fused_step, smi)
    phase_householder_auto(
        et, torch.Generator(device=device).manual_seed(7), device, smi)

    # The coupling-flow path: B4 and B5 at the BASELINE config, the sweep,
    # then the slice, one main-path run per stack.
    n_b = 1 << 17
    b4 = {k: phase_b4(et, C, k, n_b, gen, device, smi)
          for k in ("affine", "spline")}
    b5 = {k: phase_b5(et, C, k, n_b, gen, device, smi)
          for k in ("affine", "spline")}
    phase_coupling_sweep(et, C, gen, device)
    X64 = coupling_data(et, 1 << 19, gen, device)
    stacks = {k: baseline_stack(et, k, gen, device, last=0.0)
              for k in ("affine", "spline")}
    initial_stacks = {k: copy.deepcopy(m) for k, m in stacks.items()}
    coupling_launches = {}
    for k, stack in stacks.items():
        hist, coupling_launches[k] = coupling_slice(C, EW, k, stack, X64)
        print(f"[launches] coupling slice {k}: {coupling_launches[k]}",
              flush=True)
        coupling_slice_timing(k, initial_stacks[k], X64, hist, gen, smi)
        profile_coupling_steps(k, initial_stacks[k], X64, smi)

    # Flow-VI through B1/B2 and B4/B5, then the 1-D example; B2 at d=50
    # first. Each phase draws from generators of its own.
    from enflows_tpu_torch.train import vi as VI
    b2_d50 = phase_b2(et, EW, 50, 1 << 17,
                      torch.Generator(device=device).manual_seed(16), device,
                      smi)
    vi_ew = phase_vi_elementwise(et, EW, C, VI, device, smi)
    vi_c, vi_tiles = phase_vi_coupling(et, EW, C, VI, device, smi)
    phase_coupling_sweep(et, C, torch.Generator(device=device).manual_seed(33),
                         device, VI_TEMPLATE_SWEEP, "vi template sweep", 16)
    vi_ex = phase_vi_example(EW, C, device, smi)

    # Flow-preconditioned HMC: B6 at the BASELINE leapfrog config, the B6
    # sweep, then the slice through infer, one main-path run per target.
    b6 = phase_b6(et, TL, gen, device, smi, report)
    phase_b6_sweep(et, TL, gen, device)
    d_lf = LF["dim"]
    target = et.mcmc.FlowPushforwardTarget(
        leapfrog_chain(et, d_lf, gen, device).inverse())
    res, hmc_launches = hmc_route(
        et, TL, "BASELINE chain", target, d_lf, LF["chains"], HMC_WARMUP,
        HMC_SAMPLES, torch.Generator(device=device).manual_seed(3), smi,
        num_steps=LF["steps"])
    b6["max_abs_err"] = max(b6["max_abs_err"], phase_b6_adapted(
        TL, target.whiten, res.draws[:, -1].contiguous(), res.stats.step_size,
        gen, device, smi))
    _, hmc_example_launches = hmc_route(
        et, TL, "examples/fused_pushforward_hmc.py", example_d8(
            et, gen, device), 8, 256, 200, 500,
        torch.Generator(device=device).manual_seed(4), smi)
    hmc_t = hmc_timing(TL, target.whiten, res.stats.step_size, gen, device,
                       smi)

    # NUTS and ChEES through sample and infer, no kernel on their path; each
    # run with the launch counters set to 0 just before it and read just
    # after. Each phase draws from generators of its own.
    from enflows_tpu_torch.mcmc import nuts as NU
    counters = (TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES)
    tree = {alg: tree_slice(et, NU, alg, target, d_lf, counters,
                            torch.Generator(device=device).manual_seed(seed),
                            smi)
            for alg, seed in (("nuts", 40), ("chees", 41))}
    for method, seed in (("nuts", 42), ("chees", 44)):
        for through_flow in (False, True):
            infer_2d(et, method, through_flow, counters, seed, device, smi)
    infer_pushforward_tree(et, target, d_lf, counters,
                           torch.Generator(device=device).manual_seed(46),
                           smi)
    for alg in ("nuts", "chees"):
        tree_timing(et, NU, alg, target, *tree[alg],
                    hmc_t["fused_ms_per_transition"], smi)

    # Tempered SMC: no kernel on the raw ladder; B1 and B2 in the learned
    # transport's fit and application. Each phase draws from generators of
    # its own.
    smc_paths, smc_held = smc_phases(et, EW, counters, device, smi)

    # infer's default path: the auto ladder (B1/B2, B4/B5), data= (B3),
    # refine_rounds, the B4/B5 hold at the ladder's shapes and the timing.
    # Each phase draws from generators of its own.
    infer_runs, infer_times, infer_hold_err = infer_phases(
        et, EW, C, counters, device, smi)

    def infer_paths(key):
        return {path: n[key] for path, n in infer_runs.items() if n[key]}

    src = "enflows_tpu_torch/ops/csrc/elementwise.cu"
    pallas = "enflows_tpu/ops/pallas/elementwise.py"
    # Each row's launches over every main-path run that launched it, by path
    # and shape.
    ew_paths = {key: {"whitening slice (d=2, n=2^20)": launches[key],
                      "vi elementwise (d=50, n=2^17)": vi_ew[False][key],
                      "vi elementwise stl (d=50, n=2^17)": vi_ew[True][key],
                      "vi example (d=1, n=200)": vi_ex[key],
                      **smc_paths[key], **infer_paths(key)}
                for key in ("fwd", "bwd")}
    b2 = {**b2, **{f"{k}_d50": b2_d50[k]
                   for k in ("ms", "plain_ms", "bound_ms")}}
    # B1 and B2 at the SMC transport's shapes: the fit's even half and the
    # application to all particles.
    for key, vals in (("fwd", b1), ("bwd", b2)):
        for n_rows, what in ((SMC["particles"] // 2, "fit"),
                             (SMC["particles"], "apply")):
            held = smc_held[n_rows][key]
            vals.update({f"{k}_smc_{what}": held[k]
                         for k in ("ms", "plain_ms", "bound_ms")})
            vals["max_abs_err"] = max(vals["max_abs_err"],
                                      held["max_abs_err"])
    # The kernels' times at the infer phases' shapes.
    for key, vals in (("fwd", b1), ("bwd", b2), ("negll", b3)):
        vals["infer_shapes"] = infer_times[key]
    rows = [("B1 fused_forward_and_ladj", ew_paths["fwd"], src,
             f"{pallas}:441", b1),
            ("B2 fused forward backward", ew_paths["bwd"], src,
             f"{pallas}:641", b2),
            ("B3 fused_negll_value_and_grad",
             {"whitening slice (d=2, n=2^20)": launches["negll"],
              **infer_paths("negll")}, src, f"{pallas}:852", b3)]
    csrc = "enflows_tpu_torch/ops/csrc/coupling.cu"
    cpallas = "enflows_tpu/ops/pallas/coupling.py"
    for k in ("affine", "spline"):
        paths = {key: {f"coupling slice {k} (d=64, n=2^17)":
                       coupling_launches[k][key],
                       **{f"vi coupling {k}{' stl' if stl else ''} template "
                          f"(d=64, n=2^17)": n_l[key]
                          for stl, n_l in vi_c[k].items()},
                       # every infer rung and rescue fits a spline template
                       **(infer_paths(key) if k == "spline" else {})}
                 for key in ("coupling_fwd", "coupling_bwd")}
        t = vi_tiles[k]
        yard = {b: {f"{key}_vi_template": v[key] for key in
                    ("plain_ms", "library_ms", "bound_ms")}
                for b, v in t["yardsticks"].items()}
        infer = {} if k == "affine" else {
            "infer_hold_max_abs_err": infer_hold_err}
        rows += [(f"B4 fused_coupling_forward_and_ladj ({k} BASELINE)",
                  paths["coupling_fwd"], csrc, f"{cpallas}:677",
                  {**b4[k], "ms_vi_template": t["b4_ms_vi_template"],
                   "tile_vi_template": t["b4_tile_vi_template"],
                   **yard["b4"], **infer, **({} if k == "affine" else {
                       "infer_shapes": infer_times["coupling_fwd"]})}),
                 (f"B5 fused coupling backward ({k} BASELINE)",
                  paths["coupling_bwd"], csrc, f"{cpallas}:616",
                  {**b5[k], "ms_vi_template": t["ms_vi_template"],
                   "tile_vi_template": t["tile_vi_template"],
                   **yard["b5"], **infer, **({} if k == "affine" else {
                       "infer_shapes": infer_times["coupling_bwd"]})})]
    rows.append((f"B6 fused_leapfrog (BASELINE {LF['chains']} x {d_lf} x "
                 f"{LF['steps']})",
                 {"hmc slice (8192 x d=50 x L=64)": hmc_launches["leapfrog"],
                  "hmc example (256 x d=8 x L=16)":
                  hmc_example_launches["leapfrog"]},
                 "enflows_tpu_torch/ops/csrc/leapfrog.cu",
                 "enflows_tpu/ops/pallas/leapfrog.py:157", b6))
    # "ms" is the variant the main path runs; B4/B5 add the other beside it,
    # and the VI template's tile; B2 its time at d=50, n=2^17.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ms_without_b5_rows", "ms_recomputing",
            "ms_vi_template", "tile_vi_template", "plain_ms_vi_template",
            "library_ms_vi_template", "bound_ms_vi_template", "ms_d50",
            "plain_ms_d50", "bound_ms_d50", "ms_smc_fit", "plain_ms_smc_fit",
            "bound_ms_smc_fit", "ms_smc_apply", "plain_ms_smc_apply",
            "bound_ms_smc_apply", "infer_hold_max_abs_err", "infer_shapes")
    print(f"[time] chip_smoke.py {time.perf_counter() - t_start:.1f} s, the "
          f"build included [{smi}]", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": sum(paths.values()), "launches_by_path": paths,
         **{key: vals[key] for key in keys if key in vals}}
        for name, paths, source, rep, vals in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
