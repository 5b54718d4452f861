"""Drive the PyTorch port's main paths once on one CUDA card: the
whitening slice (kernels B1-B3), the coupling-flow slice (B4, B5),
flow-VI (B1/B2 and B4/B5), flow-preconditioned HMC (B6), NUTS and ChEES
(no kernel), tempered SMC (no kernel; B1/B2 in its learned transports),
infer's default path (the auto ladder through B1/B2 and B4/B5, data=
through B3), the CLI (train through B3, killed and resumed; the ELBO
and infer commands through B1/B2), the multi-device layer (one rank on
NCCL, two ranks sharing the card over gloo: B1-B5 a rank) and the example
scripts (``enflows_tpu_torch/examples/``: B3, B1/B2 and B6).

Run from the repository root:  python3 chip_smoke.py
(``--timing`` adds the phases that only time and gate nothing: the
whitening and coupling profiles, ``[householder auto]``, ``[hmc
timing]``, ``[nuts timing]``, ``[chees timing]`` and ``[infer
timing]``.)

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
   (|b x| >> 88; finite values and gradients); ``[B3 examples]``: B3 on the
   whitening examples' models at their batch shapes (d=1 n=1,000, d=2
   n=100 and n=250) against the plain version in float32 and float64,
   timed by queued device time. Each B1-B3 line gives the
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
   and what the wgmma redesign is judged by (``[B4] ... redesign``, also
   for B5 and the bf16 variants): the achieved TFLOP/s against 495 TF32 /
   989 bf16, the factor against that yardstick, the tile rows, the shared
   memory a block, the ring slots, and ptxas's registers and spills;
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
   8192 chains x d=50, 200 warmup + 50 samples (100 before PR 12) of L=64
   on the BASELINE
   chain (exactly one B6 launch per transition), then ``[example
   fused_pushforward_hmc]``: the port's module's ``main()`` on the d=8
   declared target (256 chains, its mean/var base, 200 + 500 transitions
   of L=16: exactly 700 B6 launches; its own moment gate).
   Each run's draws are finite, its
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

bf16 runs after 9 and before flow-VI (``bf16_phases``), every phase from
generators of its own, each bf16 variant timed against its f32 twin in
turns, its bound (bytes at 2 per bf16 element; B4/B5 operations at 989
TFLOP/s dense bf16) and its plain version:

13a. ``[bf16 B1]``, ``[bf16 B2]``, ``[bf16 B3]``: the flagship flow at d=2
   (n=2^24 for B1, 2^22 for B2/B3) and d=50 (n=2^17) on bf16 samples:
   each output within one bf16 ulp of the plain version with the same
   arithmetic beyond the f32 tolerances above (``bf16_close``), the plan
   buffers' cotangents by ``grads_ok`` against the same function in
   float64, B1 and B3 against float64 by tests_tpu/test_tpu_kernels.py:
   139-185's gates;
13b. ``[bf16 B6]``: 8192 x d=50 x L=64 on bf16 q and p, held the same way;
13c. ``[bf16 B4/B5]``: the BASELINE affine and K=8 spline stacks with bf16
   conditioners (bf16 wgmma), with f32 storage and with bf16 storage,
   against a float64 plain run of the same weights with f32 conditioners
   within 2x the error of the plain version with bf16-rounded operands
   and f32 products, or 8e-3 (y, ladj) / 1.6e-3 (gradients) x (max + 1)
   (``C_FWD_GATE_BF16``), the spline's gradients on the rows no closer
   than 1e-4 to a knot of the exact function;
13d. ``[bf16 coupling slice]``: 12 whitening steps of each stack with bf16
   conditioners: exactly 12 + 12 launches of the bf16 path, the history
   held to the plain bf16-product route by the coupling slice's noise
   rule (the noise: the same route on reordered rows and with its
   products on the tensor cores), the bijector route's printed; then
   ``[bf16 step diagnosis]``: one step's gradients at the fitted stack
   within 2x the rounding-only runs' distance from float64 sums;
13e. ``[bf16 whitening slice]``: the flagship flow on the whitening slice's
   2^22 samples in bf16, 24 steps of 2^20: exactly 24 B3 launches of the
   bf16 variant, then one B1 and one B2 for the fit's full-data negll and
   gradient; the history within 2e-2 relative of the plain route, the
   final negll printed against the f32 samples' fit;
13f. ``[bf16 hmc]``: ``fused_flow_hmc_sample(dtype=torch.bfloat16)`` on a
   BASELINE pushforward, 8192 chains, 20 + 20 transitions of L=64:
   exactly one B6 bf16 launch a transition, draws finite, acceptance
   within 0.3-1.0.

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
   B5's row tile and times (CUDA events, on B4's stored rows) on the
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
before it, reads them just after and fails if any kernel launched. The
NUTS and HMC kernels replay the density and its backward as a CUDA graph
(``mcmc.hmc.graphed_value_and_grad``); first

``[nuts graph]``: on full_pipeline's preconditioned density at 64 chains,
the graph's log densities and gradients against eager autograd's (equal
to 1e-6 relative, the density captured once and never run eagerly), 3
NUTS transitions each way from one state and seed (the draws' difference
printed) and the host-clock ms a lockstep leaf each way;

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
   (``precondition=None``, 128 chains, 100 + 40: finite draws and the
   acceptance range; its moments, min bulk ESS and max rhat are printed
   but not gated, since raw chains do not cross the target's modes) and
   through its exact transport (``flow=``, 128 chains, 100 + 100: mean
   within 0.1 sd, sd within 10% of Monte-Carlo truth); then
   ``infer(target, method='nuts', precondition=None)`` on the BASELINE
   pushforward at 1024 chains, 100 + 50, through ``mcmc.sample``, with no
   B6 launch;
20. ``[nuts timing]`` / ``[chees timing]``: 20 warm transitions from the
   slice's final states at its adapted settings (host clock): ms a
   transition, a leaf (NUTS) or a leapfrog step (ChEES), gradient
   evaluations a second and host reads a transition; ``torch.profiler``
   over 2 (NUTS; 5 before the mesh phases) or 5 (ChEES): the card's busy
   time, its idle share and device ops a leaf or step; the fused HMC
   transition of 13 beside them as context.

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
   vi_batch=512), NUTS over 128 chains x 10 + 10 at max_depth=4.
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
   ``precondition_kind='elementwise'`` and the configuration's NUTS at
   max_depth 10, cut to 150 + 300, over 32 chains: 500 B1 and 500 B2, the
   mean within 0.1 and the sd within 10% of 1 in every dimension, rhat <
   1.05; divergences printed (C-12);
29. ``[infer escalation 2d]``: tests/test_infer.py's bimodal target
   (:303, its settings but NUTS at 100 + 100: 0.12-0.40 of the draws right
   of 0, the x0 mean within 0.35 of -1.125) and its hard target (:353,
   whiten_batches=16): the ladder ends on the SMC rescue and escalates to
   SMC on the raw target, with exactly the rule's launches (5 B1 and 5
   B2; the spline rung and the whitening on the plain path), the
   unweighted share right of 0 printed, not gated (ROADMAP C-10);
30. ``[example one_call_infer]``: the port's module's ``main()`` at
   ``EXAMPLES``' depth (the JAX script's), its three cases: [1] the auto
   ladder (the elementwise rung's 500 B1 + B2), [2] ``data=`` with
   100,000 draws, whiten_batches=200, whiten_epochs=8 (exactly 1,600 B3),
   [3] SMC at 16,384 particles (no kernel); launches exactly as the
   dispatch rule gives the fits, [1] and [2] finite with rhat < 1.05,
   [2]'s mean within test_infer.py:92-94's bound;
31. ``[infer refine]``: test_infer.py:101's target and gates, one
   refinement round, NUTS at 8 chains x 150 + 100 a round;
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
   ``python3 chip_smoke.py --examples [name ...]`` runs only the named
   example scripts (all by default) at the JAX scripts' full defaults;
33. ``[infer timing]``: ms a step fused against plain (host clock) for a VI
   step at each rung's shape and a whitening step at the rescue's 40 and
   256 rows and the data fit's 500 (the coupling steps forced through
   B4/B5, to read what the kernels would give at the sizes the rule keeps
   from them); each kernel's time at these shapes (B1-B3 device time by
   ``queued_ms``, B4/B5 by CUDA events) against its plain version, the
   bound and, for B4/B5, TF32 torch.matmul. Each infer phase's line splits
   its call's seconds into the VI fit, the probes, the rescue, the
   sampling and the diagnostics.
34. ``[example ...]``: the port's other example modules' ``main()`` at
   ``EXAMPLES``' depths, each run with the launch counters set to 0 just
   before it and read just after, its own gates deciding its return
   code: nf_example_1d (exactly 1,000 B3 at d=1), nf_example_2d (10,000
   B3 at d=2), full_pipeline (2,000 B3, then NUTS raw and preconditioned
   at 50 + 500, its leaves through CUDA graphs, and SMC, no kernel),
   coupling_conditional_2d (30 epochs, NUTS 200 + 200) and
   spline_multimodal_2d (150 VI steps); no launch in the last two: d=2
   batches take the plain path by the row rule, ROADMAP C-3.
35. ``[cli train]``: ``python -m enflows_tpu_torch.cli train`` in a child
   process run from the repository root (``CLI_CHILD``, which writes the
   process's launch counts), the flagship stages as ``FlowConfig`` stages
   at d=2 with 4 Householder reflections, on 2^22 samples of the whitening
   slice's f_true written to an .npz, 24 epochs of 4 batches of 2^20 in
   chunks of 2 epochs (``--train.checkpoint_every=2``, ``--checkpoint_dir``,
   ``--metrics_path``): uninterrupted (exactly 96 B3 launches), SIGKILLed
   once its first chunk checkpoint lands (retried as
   tests/test_resilience.py:239-265 does), and the same command again,
   which resumes. The resumed run's final flow and optimizer state and its
   last chunk state (history included) equal the uninterrupted run's bit
   for bit; the uninterrupted metrics file holds a record a step equal to
   the history bit for bit. In this process the same trainer chunked with
   checkpoints equals it unchunked bit for bit, and its history is held to
   the plain path's as [vi elementwise] holds its own: 1e-4 relative
   unless the plain path on rows reordered within each batch already
   differs by more, then the noise rule. Printed: ms a step of the CLI run
   (its metrics clock) and in process, and a checkpoint's milliseconds;
36. ``[cli elbo]``, ``[cli sample]``, ``[cli infer]``: ``cli.main`` in this
   process at tests/test_utils.py:179-290's sizes: the ELBO objective at
   d=1 (exactly 50 B1 and 50 B2, the final loss within 0.05 of 0), ``sample``
   with SMC at its 8192 particles on the demo target (one temperature,
   ``logZ=1.8379``) and with HMC (4 chains x 100 + 100; no launch; rhat
   within 1.5 unless a coordinate's 32 leapfrog steps, at the adapted step
   size and inverse mass, turn within 0.05 of a whole number of times, as
   python -m tests.test_torch_cli hmc shows both packages stall there), and
   ``infer --sampler.precondition_kind=elementwise`` on the demo target
   (``family=elementwise``, exactly 150 B1 and 150 B2). Each ELBO fit,
   recorded from the run, is held to the plain path from the same flow and
   generator state as [vi elementwise] holds its own (``hold_history``);
37. ``[trace]``: ``utils.trace`` around four fused whitening steps: the
   Chrome trace holds the trainer's range, four
   ``enflows.cuda.fused_negll_grad`` ranges and B3 kernel events, each
   launched inside one of them;
38. ``[heartbeat]``: the default probe True within its deadline, a hung
   probe False at its deadline, ``run_checkpointed`` with a failing probe
   raising ``HeartbeatTimeout`` after its rescue save (restored onto the
   card), and running through with the default probe.

The multi-device layer runs after 38 (``mesh_phases``), a rank a child
process (``python3 chip_smoke.py --mesh-child``, every rank started
together under ``MESH_TIMEOUT``; a rank that fails fails the script). The
ranks warm up beside the torchrun CLI of 39; then each phase runs alone
on the card, each run with the launch counters set to 0 just before it
and read just after:

39. ``[mesh nccl w1]``: one rank, NCCL on cuda:0: the whitening slice's
   trainer on a mesh (12 B3), flow-VI on a mesh (the default template at
   d=50, 2^17 rows: 12 B1 + 12 B2; the affine coupling template at d=64,
   2^17 rows: 12 B4 + 12 B5), ``smc_sample_sharded`` with the default
   transport on the 2-D transport configuration (T 61 B1 and T 60 B2),
   ``sample_sharded`` NUTS and ``infer(mesh=)`` on the 2-D example target,
   each held to the unsharded entry point on the same generator (the
   whitening and elementwise histories within 1e-4, the coupling one by
   the noise rule, the 2-D SMC by tests/test_smc.py's gates and a ladder
   within 3 temperatures, the NUTS draws within 1e-5); NCCL collectives
   counted, none staged; and, before it, ``torchrun --nproc_per_node=1 -m
   enflows_tpu_torch.cli train --mesh.axes='{"batch": 1}'`` printing the
   unsharded command's final loss;
40. ``[mesh gloo w2]``: two ranks sharing cuda:0 over gloo: the whitening
   slice's data and flagship flow at a global batch of 2^20 (2^19 a
   rank), exactly 24 B3 a rank, the history within 1e-4 of the unsharded
   fused run and every replicated output equal on both ranks; flow-VI as
   in 38 at 2^17 global rows (B1 + B2) and, for the coupling template,
   2^18 (2^17 a rank, B4 + B5), one of each a rank a step; the 100-D
   mixture at 32,768 particles with the default transport under [smc
   transport]'s gates, exactly T 101 B1 and T 100 B2 a rank; the
   resampler's gather and ring exchanges giving the same rows; the
   event-sharded forward of an elementwise chain at d=64, n=2^20 (32
   columns a rank, one B1) within [B1]'s gate of the single-process B1;
   the collectives launched and those staged through the host (STAGED).
   Each rank of 39 and 40 prints its ms a whitening step and the
   collectives' share of it (``torch.profiler``): under NCCL the device
   time of the NCCL kernels against the unprofiled step, under gloo the
   host time inside the ``enflows.parallel.*`` ranges against the
   profiled step.
41. ``[mesh shapes]``: in this process, each kernel at the shapes a rank
   gives it in 39 and 40 (B1/B2 on the VI template and the SMC
   transport's fit and application rows, B1 on the event-sharded columns,
   B3 at 2^19 rows, B4/B5 on the affine VI template at 2^17 rows): device
   time against the plain version, the bound and, for B4/B5, TF32
   torch.matmul.

The script ends with its total time, the kernels line (each kernel's
launches summed over every main-path run, by path, the mesh paths summed
over their ranks) and the ``{"ok": true, ...}`` line.

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
import contextlib
import copy
import json
import functools
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
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
    """ptxas's registers and spills of every B1-B3 instantiation (float32
    and bf16 storage); a spill fails the run."""
    ents = [e for needle in ("ew_fwd_kernel", "ew_grad_kernel")
            for e in ptxas_entries(report, needle)]
    check(len(ents) == 18 and all(st == 0 and ld == 0
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


def matmul_only_ms(st, n, device, backward, tf32=False,
                   dtype=torch.float32):
    """The same conditioner products alone, in torch.matmul f32 (or TF32,
    or on ``dtype`` operands): the forward's h @ W per layer, or the
    backward's g @ W^T and h^T @ g. A yardstick; the port never calls
    it."""
    gen = torch.Generator(device=device).manual_seed(1)
    mats = [tuple(torch.randn(*s, generator=gen, device=device).to(dtype)
                  for s in ((n, K), (K, N), (n, N)))
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


def coupling_kernel_note(C, st, backward, ms, flops, rate, library_ms):
    """What a B4 / B5 time is judged by: the achieved rate against the
    tensor cores' (``rate``: TF32 or bf16), the factor against one
    torch.matmul of the same products, and the kernel's geometry: tile rows,
    cluster, shared memory a block, ring slots, and ptxas's registers and
    spills for it (from the build report)."""
    from enflows_tpu_torch.ops._build import build

    tm = C._pick_tile(st)
    names = (("coupling_bwd_kernel", "coupling_dw_kernel") if backward
             else ("coupling_fwd_kernel",))
    if tm != 64:
        names = tuple(k + "_wide" for k in names)
    ents = [e for e in ptxas_entries(build()[2], "coupling")
            if any(k in e[0] and (tm != 64 or "_wide" not in e[0])
                   for k in names)]
    regs = ", ".join(f"{next(k for k in names if k in e[0])} {e[1]} "
                     f"registers, spills {e[2]}/{e[3]} B" for e in ents)
    geo = (f"{tm}-row tiles, "
           f"{C._smem_bytes(st, tm, backward, False)} B shared memory a "
           f"block, {C._ring_slots(st, backward, False)} ring slots of "
           f"{C._padded(st).slot} B" if tm == 64 else
           f"{tm}-row tiles, {C._smem_bytes(st, tm, backward)} B shared "
           f"memory a block")
    tflops = flops / ms / 1e9
    return (f"{tflops:.2f} TFLOP/s = {100 * tflops * 1e12 / rate:.1f}% of "
            f"{rate / 1e12:.0f}; {ms / library_ms:.2f}x the torch.matmul "
            f"yardstick; {geo}; ptxas: {regs}")


def l2_weight_bytes(C, st, n):
    """The weight bytes B4 reads from L2: every tile of rows reads every
    layer's packed W and bias once."""
    pp = C._padded(st)
    tm = C._pick_tile(st)
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
    print(f"[B4] {kind} redesign: "
          f"{coupling_kernel_note(C, st, False, ms, flops, TF32_FLOP_PER_S, tf32_ms)}"
          f" [{card}]", flush=True)
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
    """The plain version through the plan, as a forward function (a bf16
    batch on the float32 plan, as the kernels read it)."""
    def forward(chain, x):
        st = C._stack_structure(chain, x.shape[1])
        wbuf, pbuf = C._stack_plan(chain, st, torch.promote_types(
            x.dtype, torch.float32), x.device)
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
    print(f"[B5] {kind} redesign: "
          f"{coupling_kernel_note(C, st, True, ms, flops, TF32_FLOP_PER_S, tf32_ms)}"
          f" [{card}]", flush=True)
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
    around 2 x (512, 512) couplings at d=64: B5 reads their inputs back from
    device memory and runs in 64-row tiles, as at the VI slice's 4
    couplings."""
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
# The VI templates' tails at the BASELINE widths, B5 in 64-row tiles; swept with
# a generator of their own, after the VI slice.
VI_TEMPLATE_SWEEP = [
    ("template tails, affine 2x(512, 512), B5 in 64-row tiles", 3001,
     _sweep_vi_template("affine")),
    ("template tails, spline 2x(512, 512), B5 in 64-row tiles", 2001,
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
                         tag="coupling sweep", tile=None):
    """B4 and B5 (on B4's stored rows and recomputing) against the plain
    version in float64 on small chains at a few thousand rows, with random
    cotangents, under the TF32 gate; and B5 with the parameters stopped
    giving the same gx, both ways. ``tile``: the rows of the B4/B5 tile
    every chain must take."""
    nearest = None   # (Held, label) of the reading nearest its limit
    for name, n, build_chain in sweep:
        chain = build_chain(et, gen, device)
        with torch.no_grad():
            for p in chain.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=device))
        d = next(s for s in chain.stages if hasattr(s, "split")).split * 2
        check(C.is_fusible_coupling_stack(chain, d), f"sweep {name} fusible")
        if tile is not None:
            got = C._pick_tile(C._stack_structure(chain, d))
            check(got == tile, f"sweep {name}: tile {got}, not {tile}")
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

    def check(self, what, ref="plain TF32"):
        check(self.rel_calm <= self.limit_calm,
              f"{what}: first {self.calm} steps fused vs {ref} "
              f"{self.rel_calm:.3e}, the plain path's own rounding noise "
              f"{self.noise_calm:.3e}")
        check(self.rel <= self.limit,
              f"{what}: fused vs {ref} history {self.rel:.3e}, the "
              f"plain path's own rounding noise {self.noise:.3e}")

    def __str__(self):
        return (f"max rel diff {self.rel:.3e} (limit {self.limit:.3e}; "
                f"first {self.calm} steps {self.rel_calm:.3e}, limit "
                f"{self.limit_calm:.3e}); noise {self.noise:.3e}, first "
                f"{self.calm} steps {self.noise_calm:.3e}")


def hold_history(what, hist, plain, other):
    """[vi elementwise]'s rule for a fused history against the plain
    path's on the same draws: within ``SLICE_RTOL`` relative, the whitening
    slice's gate, unless the plain path on rows reordered within each step
    (``other``) already differs from it by more; then the coupling slice's
    noise rule. Returns (max rel diff, the noise, the rule applied)."""
    rel, noise = rel_diff(hist, plain), rel_diff(other, plain)
    if noise <= SLICE_RTOL:
        check(rel <= SLICE_RTOL, f"{what}: fused vs plain {rel:.3e}")
        return rel, noise, f"limit {SLICE_RTOL:.0e}"
    gate = NoiseGate.of(hist, plain, [other])
    gate.check(what)
    return rel, noise, f"the noise rule: {gate}"


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
        rel, noise, rule = hold_history(what, hist, plain, other)
        print(f"[{what}] nELBO history {[round(float(v), 4) for v in hist]}"
              f"; plain path {[round(float(v), 4) for v in plain]}; fused vs "
              f"plain max rel diff {rel:.3e}, the plain path on reordered "
              f"rows vs plain {noise:.3e} ({rule}); launches {out[stl]} "
              f"[{card}]", flush=True)
    return out


def b5_stored_at(C, flow, x):
    """(B4 ms writing B5's rows, B5 ms on them, the rows of their tile) of a
    fusible stack on ``x``, by CUDA events."""
    st = C._stack_structure(flow, x.shape[1])
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(flow, st, torch.float32, x.device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
    b4 = cuda_ms(lambda: C._launch_fwd(st, x, wbuf, pbuf, True), iters=3)
    b5 = stored_b5_ms(C, st, x, wbuf, pbuf, torch.cos(y), 2.0 * ladj)
    return b4, b5, C._pick_tile(st)


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
          f"and B5 tile {C._pick_tile(st)}:"
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
        b4_t, b5_t, t = b5_stored_at(C, flow, x)
        b4_0, b5_0, s = b5_stored_at(
            C, baseline_stack(et, kind, gen, device), x)
        yard = template_yardsticks(C, flow, x)
        tiles[kind] = dict(ms_vi_template=b5_t, b4_ms_vi_template=b4_t,
                           tile_vi_template=t, yardsticks=yard)
        print(f"[vi B5 tile] {kind} template (ScaleShift, JohnsonInv, "
              f"4x{BASELINE['hidden']}, ScaleShift) n={x.shape[0]}: B4 and "
              f"B5 in {t}-row tiles; B5 on B4's stored rows {b5_t:.3f} ms "
              f"against {b5_0:.3f} ms for the bare BASELINE stack ({s}-row "
              f"tiles); B4 writing B5's rows {b4_t:.3f} ms against "
              f"{b4_0:.3f} ms; on the template, "
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
HMC_WARMUP, HMC_SAMPLES = 200, 50   # samples cut from 100 in PR 12


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


def b6_geometry(TL, args, n, d, bf16=False):
    """(G, E, block, grid, blocks per SM, registers, local bytes) of B6's
    launch for ``args`` (the card's occupancy query; the bf16-storage
    instantiation with ``bf16``)."""
    import ctypes

    from enflows_tpu_torch.ops._build import load_library

    plan = args.plan
    geo = TL.leapfrog_geometry(n, d, plan.n_stages, n_rows=plan.n_rows,
                               n_smem_slots=plan.n_smem_slots,
                               elements=args.elements)
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = load_library().enf_leapfrog_occupancy(
        int(bf16), geo.E, plan.nreg, geo.block, geo.smem,
        *map(ctypes.byref, vals))
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
# The raw target at 100 + 40 (BASELINE.md:34's row runs 500 + 1000; cut to
# 250 + 500 to keep the script near 400 s with the SMC phases, to 100 + 150
# to keep it under 950 s with the CLI phases, and to 100 + 40 for the mesh
# phases; its moments are not gated); the flow= route at 100 + 100 (200 +
# 300 before the CLI phases). The pushforward through infer at 100 + 50
# (100 + 100 before the mesh phases; its moments are not gated).
INFER_2D = dict(chains=128, warmup=100, samples=40)         # raw target
INFER_2D_FLOW = dict(chains=128, warmup=100, samples=100)   # flow= route
INFER_PUSHFORWARD = dict(chains=1024, warmup=100, samples=50)
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
    raw (``precondition=None``, 128 chains x 100 warmup + 40 samples) or
    through its exact transport (``flow=``, 128 x 100 + 100, where the
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
    pushforward at 1024 chains x 100 + 50: a declared target with a tree
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
    then ``torch.profiler`` over 2 (NUTS) or 5 (ChEES) transitions: the
    card's busy time, its
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
    # NUTS's trace of 5 transitions took ~30 s to read; 2 since the mesh
    # phases needed the time.
    n_prof = 2 if algorithm == "nuts" else 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        leaves5, _ = run(n_prof, 3)
        torch.cuda.synchronize()
    by_name, ops = device_kernel_us(prof)
    busy = sum(by_name.values()) / 1e3 / n_prof
    unit, units = (("leaf", "leaves") if algorithm == "nuts" else
                   ("leapfrog step", "leapfrog steps"))
    profile_line = (
        f"profiler over {n_prof} transitions ({leaves5} {units}): device "
        f"busy {busy:.3f} ms a transition, idle {100 * (1 - busy / ms):.1f}%"
        f" of the unprofiled ms (if the {n_prof} run as many {units} as the "
        f"20), "
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
# NUTS cut from 300 + 500 to 10 + 10 at max_depth=4 (PERF.md §4): the
# ladder's pick between the elementwise and the spline transport turns on
# the seed in both packages, and NUTS through the spline transport runs to
# depth 10, ~120 leaves a transition, at ~36 ms of host work a leaf
# (ROADMAP C-12); the forced spline transport's NUTS too. The
# configuration's NUTS (max_depth 10; 300 + 500, cut to 150 + 300 to make
# room for the CLI phases; at 150 + 150 its rhat, 1.0481, came within 0.002
# of the gate, at 100 + 100 it failed, 1.1096) runs,
# gated, through the elementwise transport,
# the family that whitens this target exactly, at 32 chains.
INFER_50D = dict(dim=50, rho=0.9, chains=128, warmup=10, samples=10,
                 max_depth=4)
INFER_ELEMENTWISE_50D = dict(chains=32, warmup=150, samples=300,
                             max_depth=10)
# tests/test_infer.py:303 and :353; test_infer.py:101.
INFER_BIMODAL = dict(vi_steps=200, vi_batch=256, whiten_batches=16,
                     whiten_epochs=8, num_chains=8, num_warmup=100,
                     num_samples=100)
INFER_HARD = dict(vi_steps=5, vi_batch=128, whiten_batches=16,
                  whiten_epochs=8, num_chains=8, num_warmup=150,
                  num_samples=150)
# The refinement test's NUTS (300 + 400) cut to 150 + 100 (PERF.md §4).
INFER_REFINE = dict(num_chains=8, num_warmup=150, num_samples=100)
INFER_SEEDS = dict(auto=50, spline=51, elementwise=57, bimodal=52, hard=53,
                   refine=56)
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
    and the spline one (NUTS 128 x 10 + 10, max_depth=4) print
    the family, k-hat, gap, the draws' mean and sd against 1 (weighted
    where the ladder escalated to SMC), rhat and the tree depths: which
    transport the ladder keeps turns on the seed, and NUTS does not mix
    through the spline one here, in JAX as in the port (ROADMAP C-12). The
    elementwise call runs the configuration's NUTS (max_depth 10, cut to
    150 + 300 over 32 chains) and holds the mean within 0.1 and the sd
    within 10% of 1 in every dimension, and rhat below 1.05; its
    divergences are printed
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
    (:303, its settings, NUTS cut to 100 + 100) must put 0.12-0.40 of the
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


def infer_refine(et, TI, counters, device, card):
    """``[infer refine]``: test_infer.py:101's warped heavy-tail target, a raw
    first pass and one refinement round (8 chains x 150 + 100 each, cut
    from 300 + 400 for the CLI phases): the refined round fits a transport
    (its whitening B3 launches counted), rhat < 1.05, mean and sd within
    the test's bounds of 200,000 draws, min bulk ESS above 0.55 x the
    800 draws and above 0.8 x the raw round's."""
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
          f"{KNOT_EPS} of a knot dropped), B4 and B5 tile "
          f"{C._pick_tile(st)}: y, "
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
        p1, k1, k2, p2 = (queued_ms(f, iters=10) for f in (plain, kernel,
                                                           kernel, plain))
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
    ms = functools.partial(cuda_ms, iters=4, warmup=1)
    with torch.no_grad():
        b4 = ms(lambda: C._launch_fwd(st, x, wbuf, pbuf, True))
        both = ms(b4b5)
        plain4 = ms(lambda: C.coupling_forward_plain(st, wbuf, pbuf, x))
        with matmul_tf32(True):
            lib4 = ms(lambda: products(False))
            lib5 = ms(lambda: products(True))
    plain5 = ms(lambda: torch.autograd.grad(
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
            logp, flow, dim=d, batch_size=n // 2, nsteps=8, key=gen(),
            use_fused_coupling=route)
        fused, plain = fused_against_plain(run(kernels), run(False), 8)
        rows.append(f"{label} d={d} n={n}: fused {fused:.3f} ms/step, plain "
                    f"{plain:.3f}")
    # The rescue's and the data fit's step shapes (40 and 500 rows), over
    # 25 and 50 steps.
    for label, make, n, nb, ne in (
            ("rescue whitening (inverted spline template)",
             et.coupling_flow_template(kind="spline"), 1000, 25, 1),
            ("rescue whitening (inverted spline template)",
             et.coupling_flow_template(kind="spline"), 4096, 16, 2),
            ("data whitening (inverted elementwise template, B3)",
             et.default_flow_template, 25_000, 50, 1)):
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
    white = by[("example one_call_infer", "whitening")]
    x = data_x[:data_x.shape[0]
               // EXAMPLES["one_call_infer"]["whiten_batches"]]
    ms, plain, _ = ew_kernel_times(EW, white, x, "negll")
    shapes["negll"][f"d=2 n={x.shape[0]} (example one_call_infer)"] = {
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


def infer_phases(et, EW, C, counters, device, card, timing=True):
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
    launches, clock, data_x = example_one_call_infer(TI, C, counters, card)
    keep("example one_call_infer", "d=2, vi n=1024, whitening n=500",
         launches, clock)
    launches, clock = infer_refine(et, TI, counters, device, card)
    keep("infer refine", "d=2, whitening n=32", launches, clock)

    # C-3: B4/B5 on every coupling flow trained above and on the affine
    # fits, at its own rows (read) and at 2^17 rows (held at d=50; the
    # sweep over 2^10-2^17 is --infer-probe's).
    fits += c3_fits(et, TI, device, splines=False)
    worst = c3_sweep(et, C, fits, device, card, sizes=(1 << 17,))
    times = infer_timing(et, EW, C, VI, TI, fits, data_x, device, card) \
        if timing else {k: {} for k in ("fwd", "bwd", "negll",
                                         "coupling_fwd", "coupling_bwd")}
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


# ----------------------------------------------------------------------
# The example scripts (enflows_tpu_torch/examples/, counterparts of
# examples/): each module's main() on the card, as a user runs it, with the
# launch counters set to 0 just before and read just after.

# The depths each example runs at here: the JAX scripts' widths (dims, data
# sizes, layers, bins, chains, particles) and, where the run fits the
# script's time, their depths. NUTS through a fitted flow adapts a small
# step and deep trees (the JAX package's too, PERF.md §6); its leaves
# replay the density as a CUDA graph (mcmc.hmc.graphed_value_and_grad).
# full_pipeline's warmup is cut to 50: the shorter adaptation keeps a
# larger step, and its 500 samples keep the preconditioned ESS its median
# gate needs (PERF.md §4 gives the gates' values on five seeds).
EXAMPLES = {
    "one_call_infer": dict(vi_steps=500, warmup=400, samples=500,
                           whiten_batches=200, whiten_epochs=8),
    "fused_pushforward_hmc": dict(warmup=200, samples=500),
    "nf_example_1d": dict(batches=100, epochs=10),
    "nf_example_2d": dict(batches=1000, epochs=10),
    "full_pipeline": dict(batches=200, epochs=10, warmup=50, samples=500),
    "coupling_conditional_2d": dict(epochs=30, warmup=200, samples=200),
    "spline_multimodal_2d": dict(vi_steps=150),
}


def example_argv(name):
    """The command-line flags of ``EXAMPLES[name]``."""
    return [a for k, v in EXAMPLES[name].items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def example_run(name, counters, argv=None):
    """``enflows_tpu_torch.examples.<name>.main(argv)`` on the card
    (``argv``: ``EXAMPLES[name]``'s depths by default, [] for the JAX
    script's defaults), the launch counters and ``mcmc.hmc.GRAPHS`` set to
    0 just before and read just after; fails the run on a non-zero return.
    Returns (the report main filled, launches, seconds, the graphs)."""
    import importlib
    from enflows_tpu_torch.mcmc import hmc
    ex = importlib.import_module(f"enflows_tpu_torch.examples.{name}")
    argv = example_argv(name) if argv is None else argv
    print(f"[example {name}] main({argv}):", flush=True)
    report = {}
    reset_launches(*counters, hmc.GRAPHS)
    t0 = time.perf_counter()
    rc = ex.main(argv, report=report)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(counters)
    check(rc == 0, f"[example {name}]: main returned {rc}")
    return report, launches, wall, dict(hmc.GRAPHS)


# full_pipeline's main() in a process of its own: its launches, graphs,
# seconds and report, torch.save'd to the file named by argv[3].
EXAMPLE_CHILD = """
import importlib, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from enflows_tpu_torch.mcmc import hmc
from enflows_tpu_torch.ops import coupling as C
from enflows_tpu_torch.ops import elementwise as EW
from enflows_tpu_torch.ops import leapfrog as TL
name, out = sys.argv[2], sys.argv[3]
ex = importlib.import_module("enflows_tpu_torch.examples." + name)
report = {}
t0 = time.perf_counter()
rc = ex.main(sys.argv[4:], report=report)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
torch.save(dict(rc=rc, report=report, wall=wall, graphs=dict(hmc.GRAPHS),
                launches=cs.kernel_launches((TL.LAUNCHES, EW.LAUNCHES,
                                             C.LAUNCHES))), out)
"""


def example_run_fresh(name, counters):
    """``example_run`` in a process of its own, as a user runs the script:
    for full_pipeline, whose SMC ladder is not reproducible on the card
    (ROADMAP C-14) and took other ladders in this process after the
    phases before it (51 and 55 temperatures, its median gate missed)
    than in a fresh one (89, held). The child's launch counters and
    ``mcmc.hmc.GRAPHS`` start at 0; fails the run on a non-zero return.
    Returns (the report main filled, launches, seconds, the graphs)."""
    import subprocess
    import tempfile
    argv = example_argv(name)
    print(f"[example {name}] main({argv}), in a process of its own:",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        out = os.path.join(tmp, "result.pt")
        proc = subprocess.run([sys.executable, "-c", EXAMPLE_CHILD, HERE,
                               name, out, *argv], cwd=HERE)
        check(proc.returncode == 0 and os.path.exists(out),
              f"[example {name}]: its process exited {proc.returncode}")
        res = torch.load(out, weights_only=False)
    check(set(res["launches"]) == set(kernel_launches(counters)),
          f"[example {name}]: counters {sorted(res['launches'])}")
    check(res["rc"] == 0, f"[example {name}]: main returned {res['rc']}")
    return res["report"], res["launches"], res["wall"], res["graphs"]


def examples_at_defaults(names, counters, card):
    """``--examples [name ...]``: each named example's ``main([])`` at the
    JAX script's defaults (``example_run``); prints its seconds, launches,
    graphs and the numbers it reported."""
    for name in names:
        report, launches, wall, graphs = example_run(name, counters, [])
        numbers = {k: v for k, v in report.items()
                   if isinstance(v, (int, float, np.ndarray))
                   or (type(v) is tuple and all(
                       isinstance(u, (int, float)) for u in v))}
        example_line(name, launches, f"{wall:.1f} s",
                     f"the JAX script's defaults; {graph_text(graphs)}; "
                     f"{numbers}", card)


def graph_text(graphs):
    return (f"sampler densities {graphs['captured']} captured as CUDA "
            f"graphs ({graphs['replays']} replays), {graphs['eager']} run "
            f"eagerly")


def example_line(name, launches, seconds, detail, card):
    print(f"[example {name}] {seconds} (host clock, the host-side "
          f"diagnostics included); launches {launch_text(launches)}; "
          f"{detail} [{card}]", flush=True)


def example_gate_launches(name, launches, want):
    full = {k: 0 for k in launches}
    full.update(want)
    check(launches == full, f"[example {name}]: launches "
          f"{launch_text(launches)}, want {launch_text(full)}")


def example_one_call_infer(TI, C, counters, card):
    """``[example one_call_infer]``: [1] the auto ladder (its elementwise
    rung B1 + B2 a VI step), [2] ``data=`` (B3 a whitening step: 1,600 at
    200 x 8), [3] SMC (no kernel); launches exactly as the dispatch rule
    gives the fits ``infer`` made, [1] and [2]'s draws finite with rhat <
    1.05, and [2]'s mean within test_infer.py:92-94's bound of the data's.
    The JAX script only prints; these are the gates test_infer.py holds
    such runs to. Returns (launches, the clock, the data)."""
    cfg = EXAMPLES["one_call_infer"]
    with infer_clock(TI) as clock:
        rep, launches, wall, graphs = example_run("one_call_infer", counters)
    steps = {"vi": cfg["vi_steps"],
             "whitening": cfg["whiten_batches"] * cfg["whiten_epochs"]}
    want = expected_launches(C, clock, steps)
    check(launches == want and launches["negll"] == steps["whitening"],
          f"[example one_call_infer]: launches {launch_text(launches)}, "
          f"want {launch_text(want)} with {steps['whitening']} B3")
    check(graphs["captured"] > 0,
          f"[example one_call_infer]: {graph_text(graphs)}")
    rhat = {}
    for case in ("r1", "r2"):
        rhat[case] = float(rep[case].diagnostics["rhat"].max())
        check(bool(torch.isfinite(rep[case].draws).all())
              and rhat[case] < 1.05,
              f"[example one_call_infer] {case}: rhat {rhat[case]:.4f}, "
              f"draws finite {bool(torch.isfinite(rep[case].draws).all())}")
    dg, X = rep["r2"].diagnostics, rep["X"]
    bound = 5 * float(X.double().std(0).max()) / math.sqrt(
        dg["min_bulk_ess"]) + 0.05
    mean_err = float((torch.as_tensor(dg["mean"])
                      - X.double().mean(0).cpu()).abs().max())
    check(mean_err < bound, f"[example one_call_infer] [2]: mean err "
          f"{mean_err:.4f} (bound {bound:.4f})")
    d1, d3 = rep["r1"].diagnostics, rep["r3"].diagnostics
    example_line("one_call_infer", launches, clock.text(wall),
                 f"[1] family {d1.get('precondition_family')}, rhat "
                 f"{rhat['r1']:.4f}; [2] rhat {rhat['r2']:.4f}, mean err "
                 f"{mean_err:.4f} (bound {bound:.4f}), min bulk ESS "
                 f"{dg['min_bulk_ess']:.0f}; rhat gated < 1.05 on [1] and "
                 f"[2]; [3] log Z {d3['log_z']:.4f}, "
                 f"{len(rep['r3'].stats)} temperatures; "
                 f"{graph_text(graphs)}", card)
    return launches, clock, X


def example_pushforward_hmc(counters, card):
    """``[example fused_pushforward_hmc]``: ``infer(method="hmc")`` on the
    declared d=8 target, 256 chains: exactly one B6 launch a transition,
    the draws finite and of their shape, acceptance within 0.6-1.0, and
    the example's own moment gate (it returns 1 otherwise)."""
    cfg = EXAMPLES["fused_pushforward_hmc"]
    rep, launches, wall, _ = example_run("fused_pushforward_hmc", counters)
    res = rep["result"]
    n = cfg["warmup"] + cfg["samples"]
    example_gate_launches("fused_pushforward_hmc", launches,
                          {"leapfrog": n})
    check(res.draws.shape == (256, cfg["samples"], 8)
          and bool(torch.isfinite(res.draws).all()),
          f"[example fused_pushforward_hmc]: draws "
          f"{tuple(res.draws.shape)}")
    acc = res.diagnostics["accept_prob"]
    check(0.6 <= acc <= 1.0, f"[example fused_pushforward_hmc]: "
          f"acceptance {acc:.3f}")
    example_line("fused_pushforward_hmc", launches, f"{wall:.1f} s",
                 f"accept {acc:.3f}, step size "
                 f"{float(res.stats.step_size):.4f}, mean err "
                 f"{rep['mean_err']:.4f}, sd rel err {rep['sd_rel']:.4f}, "
                 f"max rhat {float(res.diagnostics['rhat'].max()):.4f}",
                 card)
    return launches


def example_phases(counters, card):
    """The whitening examples (B3 a step), full_pipeline (B3, then NUTS and
    SMC with no kernel) and the two coupling examples (no kernel: d=2
    batches take the plain path by the row rule, C-3), each failing the run
    if its own gates fail; full_pipeline's and coupling_conditional_2d's
    NUTS must have replayed CUDA graphs of their densities. Returns {path:
    launches}."""
    paths = {}
    for name, want, detail in (
            ("nf_example_1d", "negll", lambda r: (
                f"final negll {r['final_negll']:.4f} (analytic "
                f"{r['target_negll']:.4f})")),
            ("nf_example_2d", "negll", lambda r: (
                f"cov - I {np.abs(r['cov'] - np.eye(2)).max():.4f}, "
                f"|mean| {np.abs(r['mean']).max():.4f}")),
            ("full_pipeline", "negll", lambda r: (
                f"medians NUTS {np.round(r['nuts_med'], 3)} SMC "
                f"{np.round(r['smc_med'], 3)} data "
                f"{np.round(r['data_med'], 3)} (max errors "
                f"{np.abs(r['nuts_med'] - r['data_med']).max():.4f} / "
                f"{np.abs(r['smc_med'] - r['data_med']).max():.4f} < 0.15),"
                f" log Z {r['logz']:.4f} ({r['temperatures']} "
                f"temperatures), min ESS raw {r['ess_raw']:.0f} / "
                f"preconditioned {r['ess_pre']:.0f} (ratio "
                f"{r['ess_pre'] / r['ess_raw']:.1f} > 10; raw "
                f"{r['t_raw']:.1f} s, preconditioned {r['t_pre']:.1f} s, "
                f"{r['div_pre']} divergences)")),
            ("coupling_conditional_2d", None, lambda r: (
                f"cov - I {np.abs(r['cov'] - np.eye(2)).max():.4f}, rhat "
                f"{r['rhat']:.4f}, x1 mean/sd {r['x1'][0]:+.3f} / "
                f"{r['x1'][1]:.3f}, resid {r['resid'][0]:+.3f} / "
                f"{r['resid'][1]:.3f}")),
            ("spline_multimodal_2d", None, lambda r: (
                f"negll spline {r['n_spl']:.4f} affine {r['n_aff']:.4f} "
                f"bound {r['bound']:.4f}, balance {r['balance']:.3f}, gap "
                f"{r['gap']:.4f}, VI balance {r['balance_vi']:.3f}"))):
        run = example_run_fresh if name == "full_pipeline" else example_run
        rep, launches, wall, graphs = run(name, counters)
        cfg = EXAMPLES[name]
        example_gate_launches(name, launches, {} if want is None else {
            want: cfg["batches"] * cfg["epochs"]})
        if name in ("full_pipeline", "coupling_conditional_2d"):
            # Their NUTS leaves replayed CUDA graphs of the density.
            check(graphs["captured"] > 0,
                  f"[example {name}]: {graph_text(graphs)}")
        example_line(name, launches, f"{wall:.1f} s",
                     f"{detail(rep)}; {graph_text(graphs)}", card)
        paths[name] = launches
    return paths


def phase_nuts_graph(et, device, card, transitions=3, step=0.05):
    """``[nuts graph]``: NUTS's leaves through a CUDA graph of the density
    and its backward (``mcmc.hmc.graphed_value_and_grad``) against eager
    autograd, on full_pipeline's preconditioned density (its whitening
    model after 20 steps) at its 64 chains: the graph's log densities and
    gradients equal eager's on the same points (gated), then
    ``transitions`` NUTS transitions each way from the same state and
    generator seed (the draws' difference printed) and the host-clock
    milliseconds a lockstep leaf each way. Returns the leaf times."""
    from enflows_tpu_torch.examples import full_pipeline as FP
    from enflows_tpu_torch.examples.nf_example_2d import ground_truth
    from enflows_tpu_torch.mcmc import flow_preconditioned, hmc, nuts
    gen = torch.Generator(device=device).manual_seed(80)
    target = et.FlowDistribution(ground_truth(device)).requires_grad_(False)
    with torch.no_grad():
        X = target.sample(gen, (50_000,), dim=2)
    fit = FP.fit(X, FP.model(torch.randn(2, generator=gen, device=device)),
                 20, 1)
    pre = flow_preconditioned(target.logpdf, et.invert(fit.result))
    q = torch.randn(64, 2, generator=gen, device=device)
    eager = lambda x: hmc.value_and_grad(pre.logdensity_fn, x)
    graphed = hmc.graphed_value_and_grad(pre.logdensity_fn)
    hmc.GRAPHS.update(captured=0, replays=0, eager=0)
    worst = 0.0
    for x in (q, 2.0 * q, q + 1.0):
        (l0, g0), (l1, g1) = eager(x), graphed(x)
        worst = max(worst, *(float((b - a).abs().max()
                                   / (1.0 + a.abs().max()))
                             for a, b in ((l0, l1), (g0, g1))))
    check(hmc.GRAPHS["captured"] == 1 and hmc.GRAPHS["eager"] == 0
          and worst <= 1e-6,
          f"[nuts graph]: graphs {hmc.GRAPHS}, max |graph - eager| / (1 + "
          f"max |eager|) {worst:.3e}")
    inv_mass = torch.ones(2, device=device)
    runs = {}
    for label, fn in (("eager", eager), ("graph", graphed),
                      ("graph", graphed), ("eager", eager)):
        kernel = nuts.nuts_kernel(pre.logdensity_fn, value_and_grad_fn=fn)
        state = hmc.init_state(pre.logdensity_fn, q)
        g = torch.Generator(device=device).manual_seed(81)
        leaves = nuts.LOCKSTEP["leaves"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(transitions):
            state, _ = kernel(g, state, step, inv_mass)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = nuts.LOCKSTEP["leaves"] - leaves
        runs.setdefault(label, []).append((ms / max(n, 1), state.q, n))
    diff = float((runs["graph"][0][1] - runs["eager"][0][1]).abs().max())
    leaf = {k: min(ms for ms, _, _ in v) for k, v in runs.items()}
    print(f"[nuts graph] full_pipeline's preconditioned density, 64 chains: "
          f"value and gradient max |graph - eager| / (1 + max |eager|) "
          f"{worst:.3e} (limit 1e-6); "
          f"{transitions} NUTS transitions at step {step} "
          f"({runs['graph'][0][2]} lockstep leaves), draws max |graph - "
          f"eager| {diff:.3e}; host-clock ms a leaf: eager {leaf['eager']:.3f}"
          f", graph {leaf['graph']:.3f} [{card}]", flush=True)
    return leaf


def phase_b3_examples(et, EW, device, card):
    """``[B3 examples]``: B3 on the whitening examples' models at their
    batch shapes (nf_example_1d d=1 n=1,000, nf_example_2d d=2 n=100,
    full_pipeline d=2 n=250), on data from their ground truths: the negll
    and every gradient against the plain version in float32 and float64
    (``close_to_f64``), then the kernel's device time against the plain
    version's (``queued_ms``: at these sizes the host's launch rate would
    pace calls timed one by one), with the byte bound. Returns {shape:
    times}."""
    from enflows_tpu_torch.examples import full_pipeline as FP
    from enflows_tpu_torch.examples import nf_example_1d as E1
    from enflows_tpu_torch.examples import nf_example_2d as E2

    gen = torch.Generator(device=device).manual_seed(70)
    reflection = lambda: torch.randn(2, generator=gen, device=device)
    out = {}
    for label, ex, model, d, n in (
            ("nf_example_1d", E1, E1.model(device), 1, 1000),
            ("nf_example_2d", E2, E2.model(reflection()), 2, 100),
            ("full_pipeline", FP, FP.model(reflection()), 2, 250)):
        with torch.no_grad():
            x = ex.ground_truth(device)(torch.randn(n, d, generator=gen,
                                                    device=device))
        v, g = EW.fused_negll_value_and_grad(model, x)
        v0, g0 = EW.negll_value_and_grad_plain(model, x)
        # The float64 reference on the host: a few hundred rows.
        v64, g64 = EW.negll_value_and_grad_plain(
            copy.deepcopy(model).cpu().double(), x.cpu().double())
        v64 = v64.to(device)
        g64 = {k: g.to(device) for k, g in g64.items()}
        what = f"[B3 examples] {label} d={d} n={n}"
        errs = [close_to_f64(v, v0, v64, NEGLL_RTOL, what + " negll")]
        errs += [close_to_f64(g[k], g0[k], g64[k], G_RTOL,
                              f"{what} grad {k}") for k in g64]
        plan, bufs = EW._chain_plan(model, d, device)
        bufs = tuple(b.detach() for b in bufs)
        kernel = lambda: EW._launch("negll", plan, x, bufs)
        plain = lambda: EW.negll_value_and_grad_plain(model, x)
        p1, k1, k2, p2 = (queued_ms(f, iters=10) for f in (plain, kernel,
                                                           kernel, plain))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        k = 1 if d == 2 else 0
        t = {**bound_of(4 * n * d, 3 * n * hh_flops(d, k)), "ms": ms,
             "plain_ms": plain_ms, "max_abs_err": max(errs)}
        out[f"d={d} n={n} ({label})"] = t
        print(f"{what}: negll {float(v):.7f} vs plain {float(v0):.7f}, "
              f"worst |kernel - f64| {max(errs):.3e}; kernel "
              f"{shape_text(t)} (device time, queued); "
              f"{chain_geometry_text(EW, plan, n, 'negll')} [{card}]",
              flush=True)
    return out


def phase_mesh_shapes(et, EW, C, device, card):
    """``[mesh shapes]``: each kernel's device time at the shapes a rank
    gives it in the mesh phases (the same kernels on the same card, in
    this process): B1 and B2 on the d=50 default template at 2^17 and
    2^16 rows (VI at one and two ranks), on the SMC transport's ScaleShift
    at its fit (B1 + B2) and application (B1) rows, 100-D at 8,192 /
    16,384 (two ranks) and 2-D at 32,768 / 65,536 (one rank), B1 on the
    event-sharded chain's 32 columns at 2^20 rows; B3 on the flagship flow
    at d=2, 2^19 rows; B4/B5 on the affine VI template at d=64, 2^17 rows
    (CUDA events), with the conditioner products alone in TF32
    torch.matmul. Returns {kernel key: {shape: times}}."""
    from enflows_tpu_torch.smc.flow_transport import default_template

    gen = torch.Generator(device=device).manual_seed(72)
    shapes = {k: {} for k in ("fwd", "bwd", "negll", "coupling_fwd",
                              "coupling_bwd")}

    def ew(flow, d, n, keys, label, k=0):
        x = torch.randn(n, d, generator=gen, device=device)
        for key in keys:
            ms, plain, _ = ew_kernel_times(EW, flow, x, key)
            if key == "negll":
                nbytes, flops = 4 * n * d, 3 * n * hh_flops(d, k)
            else:
                nbytes = 4 * n * ((2 if key == "fwd" else 3) * d + 1)
                flops = n * hh_flops(d, k) * (1 if key == "fwd" else 2)
            shapes[key][f"d={d} n={n} ({label})"] = {
                **bound_of(nbytes, flops), "ms": ms, "plain_ms": plain}

    t50 = et.default_flow_template(50, gen)
    for n, ranks in ((1 << 17, "w1"), (1 << 16, "w2")):
        ew(t50, 50, n, ("fwd", "bwd"), f"mesh vi elementwise {ranks}", 4)
    for d, n, ranks in ((100, 16384, "w2"), (2, 65536, "w1")):
        flow = default_template(torch.randn(n, d, generator=gen,
                                            device=device))
        ew(flow, d, n // 2, ("fwd", "bwd"), f"mesh smc fit {ranks}")
        ew(flow, d, n, ("fwd",), f"mesh smc apply {ranks}")
    d = MESH_EVENT["dim"] // 2
    vec = lambda v: torch.full((d,), v, device=device)
    event = et.compose(
        et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0)),
        et.ScaleShift(torch.linspace(0.5, 2.0, d, device=device), vec(0.0)),
        et.invert(et.CenterStretch(vec(0.5), vec(1.0), vec(0.0))))
    ew(event, d, MESH_EVENT["n"], ("fwd",), "mesh event w2")
    ew(flagship_flow(et, 2, gen, device), 2, 1 << 19, ("negll",),
       "mesh whitening w2", 4)
    flow = et.coupling_flow_template(
        BASELINE["n_layers"], BASELINE["hidden"], kind="affine")(
            BASELINE["dim"], gen)
    t = coupling_kernel_times(C, flow, torch.randn(
        1 << 17, BASELINE["dim"], generator=gen, device=device))
    label = f"d={BASELINE['dim']} n={1 << 17} (mesh vi affine w1, w2)"
    shapes["coupling_fwd"][label] = t["b4"]
    shapes["coupling_bwd"][label] = t["b5"]
    for key, times in shapes.items():
        how = "CUDA events" if key.startswith("coupling") else \
            "device time, queued"
        print(f"[mesh shapes] {key} ({how}): "
              + "; ".join(f"{s} {shape_text({'library_ms': None, **t})}"
                          for s, t in times.items()) + f" [{card}]",
              flush=True)
    return shapes


# ----------------------------------------------------------------------
# The run utilities and the CLI (python -m enflows_tpu_torch.cli): the
# whitening trainer through B3 in preemption-safe chunks, killed and
# resumed; the ELBO, sample and infer commands; a profiler trace of the
# kernel ranges; the heartbeat.

CLI_TRAIN = dict(rows=1 << 22, nbatches=4, epochs=24, every=2)
CLI_STAGES = ["johnson", "center_stretch_inv", "householder", "johnson",
              "center_stretch_inv"]
CLI_INFER_STEPS = 150
# How near a whole number of turns HMC's 32 steps may come before the CLI
# sample's rhat goes ungated (python -m tests.test_torch_cli hmc: every
# seed of 20 with rhat > 1.5 turned within 0.04 of one, in both packages).
HMC_RESONANCE = 0.05
# ``python -m enflows_tpu_torch.cli`` as runpy runs it, then the process's
# launch counts written to the file named first.
CLI_CHILD = (
    "import json, runpy, sys\n"
    "from enflows_tpu_torch.ops import elementwise as EW\n"
    "out = sys.argv[1]\n"
    "sys.argv = ['enflows_tpu_torch.cli'] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_module('enflows_tpu_torch.cli', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    if e.code:\n"
    "        raise\n"
    "with open(out, 'w') as f:\n"
    "    json.dump(dict(EW.LAUNCHES), f)\n")


def cli_train_argv(data, root):
    """The [cli train] command: the flagship stages at d=2 on ``data``, 4
    batches a epoch, chunks of 2 epochs checkpointed under
    ``root/ck/train``, the final snapshot in ``root/ck``, a metrics record a
    step in ``root/metrics.jsonl``."""
    return ["train", "--data", data, "--flow.dim=2",
            f"--flow.stages={json.dumps(CLI_STAGES)}",
            "--flow.householder_reflections=4",
            f"--train.nbatches={CLI_TRAIN['nbatches']}",
            f"--train.nepochs={CLI_TRAIN['epochs']}",
            f"--train.checkpoint_every={CLI_TRAIN['every']}",
            f"--checkpoint_dir={os.path.join(root, 'ck')}",
            f"--metrics_path={os.path.join(root, 'metrics.jsonl')}"]


def cli_child(argv, root, wait=True):
    """The CLI in a child process run from the repository root (so that
    ``--target`` and the package resolve there); with ``wait``, (its
    printed lines, its launch counts)."""
    out = os.path.join(root, "launches.json")
    p = subprocess.Popen([sys.executable, "-c", CLI_CHILD, out] + argv,
                         cwd=HERE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    if not wait:
        return p
    stdout, stderr = p.communicate(timeout=600)
    check(p.returncode == 0, f"cli child exited {p.returncode}: "
          f"{stderr[-3000:]}")
    with open(out) as f:
        return stdout.strip().splitlines(), json.load(f)


def same_state(a, b, what):
    """Two checkpoints' states equal leaf for leaf, bit for bit."""
    from enflows_tpu_torch.utils import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            ok = isinstance(y, torch.Tensor) and x.dtype == y.dtype and \
                torch.equal(x, y)
        else:
            ok = x == y
        check(ok, f"{what}: leaf {i} differs")


def load_state(path, step):
    from enflows_tpu_torch.utils import restore_checkpoint
    return restore_checkpoint(path, None, step=step)


def kill_after_first_checkpoint(argv, root, attempts=3):
    """Start the command, SIGKILL it once its first chunk checkpoint lands
    under ``root/ck/train``, retried while the child wins the race (as
    tests/test_resilience.py:239-265). Returns the chunks it had saved."""
    import shutil
    import signal

    from enflows_tpu_torch.utils import latest_step

    ck = os.path.join(root, "ck")
    final = os.path.join(ck, f"step_{CLI_TRAIN['epochs'] * 4}.pt")
    for _ in range(attempts):
        shutil.rmtree(ck, ignore_errors=True)
        p = cli_child(argv, root, wait=False)
        deadline = time.time() + 600
        while latest_step(os.path.join(ck, "train")) is None:
            if p.poll() is not None:
                check(False, "cli train: the child ended before its first "
                      f"checkpoint: {p.communicate()[1][-2000:]}")
            check(time.time() < deadline, "cli train: no checkpoint")
            time.sleep(0.005)
        p.send_signal(signal.SIGKILL)
        p.communicate(timeout=60)
        if not os.path.exists(final):
            return latest_step(os.path.join(ck, "train"))
    check(False, f"cli train: the child finished before {attempts} kills")


def cli_train(et, EW, counters, device, card):
    """``[cli train]``: the whitening slice's data (2^22 samples of f_true,
    written to an .npz) trained by the CLI in a child process three ways:
    uninterrupted, SIGKILLed once its first checkpoint lands, and the same
    command again to resume. The resumed run's final flow, optimizer state
    and history equal the uninterrupted run's bit for bit; its metrics file
    has a record a step equal to the history bit for bit; B3 runs exactly
    epochs x 4 times in the uninterrupted child. In this process, the same
    trainer chunked equals it unchunked bit for bit and the plain path
    within 1e-4 relative. Returns B3's launches by path."""
    import tempfile

    import numpy as np
    from enflows_tpu_torch import cli
    from enflows_tpu_torch.train import optimize_whitening
    from enflows_tpu_torch.utils import (load_config, build_flow,
                                         save_checkpoint)

    E, nb = CLI_TRAIN["epochs"], CLI_TRAIN["nbatches"]
    steps, chunks = E * nb, E // CLI_TRAIN["every"]
    gen = torch.Generator(device=device).manual_seed(60)
    f_true = example_2d_flow(et, device)
    with torch.no_grad():
        X = f_true(torch.randn(CLI_TRAIN["rows"], 2, generator=gen,
                               device=device))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "X.npz")
        np.savez(data, X=X.cpu().numpy())
        for name in ("full", "killed"):
            os.makedirs(os.path.join(tmp, name))
        t0 = time.perf_counter()
        lines, full_launches = cli_child(
            cli_train_argv(data, os.path.join(tmp, "full")),
            os.path.join(tmp, "full"))
        full_s = time.perf_counter() - t0
        check(full_launches["negll"] == steps and not full_launches["fwd"]
              and not full_launches["bwd"],
              f"cli train: launches {full_launches}, not {steps} B3")
        killed_dir = os.path.join(tmp, "killed")
        argv = cli_train_argv(data, killed_dir)
        killed_at = kill_after_first_checkpoint(argv, killed_dir)
        t0 = time.perf_counter()
        resumed_lines, resumed_launches = cli_child(argv, killed_dir)
        resumed_s = time.perf_counter() - t0
        left = (chunks - killed_at) * CLI_TRAIN["every"] * nb
        check(resumed_launches["negll"] == left,
              f"cli train resumed: {resumed_launches}, not {left} B3")
        check(lines[-1] == resumed_lines[-1],
              f"cli train: {lines[-1]!r} against {resumed_lines[-1]!r}")
        full_ck = os.path.join(tmp, "full", "ck")
        res_ck = os.path.join(killed_dir, "ck")
        same_state(load_state(full_ck, steps), load_state(res_ck, steps),
                   "cli train: resumed final flow and optimizer state")
        chunk_state = load_state(os.path.join(full_ck, "train"), chunks)
        same_state(chunk_state, load_state(os.path.join(res_ck, "train"),
                                           chunks),
                   "cli train: resumed chunk state with its history")
        hist = chunk_state["history"]
        with open(os.path.join(tmp, "full", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        check([r["step"] for r in recs] == list(range(steps))
              and [r["negll"] for r in recs] == hist.tolist(),
              "cli train: the metrics records are not the history")
        cli_ms = (recs[-1]["time"] - recs[0]["time"]) * 1e3 / (steps - 1)

        # In this process: the same trainer unchunked, chunked, plain.
        cfg = load_config(None, cli_train_argv(data, tmp)[3:])
        flow0 = build_flow(cfg.flow, device)
        opt = cli._optimizer(cfg)
        reset_launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = optimize_whitening(X, flow0, opt, nbatches=nb, nepochs=E)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        check(EW.LAUNCHES["negll"] == steps,
              f"cli train in-process: {EW.LAUNCHES['negll']} B3")
        t0 = time.perf_counter()
        r2 = optimize_whitening(X, flow0, opt, nbatches=nb, nepochs=E,
                                checkpoint_every=CLI_TRAIN["every"],
                                ckpt_dir=os.path.join(tmp, "inproc"))
        torch.cuda.synchronize()
        chunked_ms = (time.perf_counter() - t0) * 1e3 / steps
        runs["in-process"] = EW.LAUNCHES["negll"]
        check(torch.equal(r1.negll_history, r2.negll_history),
              "cli train: chunked history differs from unchunked")
        same_state([r1.result.state_dict(), r1.optimizer_state],
                   [r2.result.state_dict(), r2.optimizer_state],
                   "cli train: chunked flow and optimizer state")
        cli_same = torch.equal(r1.negll_history.cpu(), hist)
        # The history against the plain path: within 1e-4 relative (the
        # whitening slice's gate) unless the plain path on rows reordered
        # within each batch already differs from it by more; then by the
        # coupling slice's noise rule (as [vi elementwise]).
        plain = optimize_whitening(X, flow0, opt, nbatches=nb, nepochs=E,
                                   use_fused=False).negll_history.cpu()
        other = optimize_whitening(
            rows_permuted_within_batches(X, nb, torch.Generator(
                device=device).manual_seed(62)), flow0, opt, nbatches=nb,
            nepochs=E, use_fused=False).negll_history.cpu()
        fused = r1.negll_history.cpu()
        by_epoch = lambda h: [f"{r:.1e}" for r in ((h - plain).abs()
                              / plain.abs()).view(E, nb).amax(1).tolist()]
        rel, noise, rule = hold_history(
            f"cli train (by epoch {by_epoch(fused)})", fused, plain, other)
        state = {"flow": r1.result.state_dict(),
                 "opt_state": r1.optimizer_state,
                 "history": r1.negll_history}
        ck_s = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(tmp, "timed"), state, step=i)
            ck_s.append(time.perf_counter() - t0)
    runs = {"cli train (d=2, n=2^20)": full_launches["negll"],
            "cli train resumed (d=2, n=2^20)": resumed_launches["negll"],
            "cli train in-process unchunked + chunked (d=2, n=2^20)":
            runs["in-process"]}
    print(f"[cli train] python -m enflows_tpu_torch.cli train, {E} epochs x "
          f"{nb} batches of 2^20 (d=2, the flagship stages), chunks of "
          f"{CLI_TRAIN['every']} epochs: {lines[-1]!r}; B3 {steps} launches "
          f"uninterrupted; killed after {killed_at} of {chunks} chunks, "
          f"resumed with {resumed_launches['negll']} B3: flow, optimizer "
          f"state and history bit-equal; {len(recs)} metrics records equal "
          f"to the history; child wall {full_s:.1f} s (resume "
          f"{resumed_s:.1f} s); CLI {cli_ms:.3f} ms/step (metrics clock, "
          f"with its chunk checkpoints and a host read a record); in "
          f"process {step_ms:.3f} ms/step unchunked, {chunked_ms:.3f} "
          f"chunked with checkpoints, bit-equal; CLI history bit-equal to "
          f"the in-process run: {cli_same}; history {hist[0]:.5f} -> "
          f"{hist[-1]:.5f}, fused vs plain max rel {rel:.3e} (by epoch "
          f"{by_epoch(fused)}), the plain path on reordered rows vs plain "
          f"{noise:.3e} (by epoch {by_epoch(other)}; {rule}); a "
          f"checkpoint of the trainer state {1e3 * min(ck_s):.3f}-"
          f"{1e3 * max(ck_s):.3f} ms [{card}]",
          flush=True)
    return runs, dict(cli_ms_per_step=cli_ms, ms_per_step=step_ms,
                      chunked_ms_per_step=chunked_ms,
                      checkpoint_ms=1e3 * min(ck_s))


def run_cli(argv, counters, record=()):
    """``cli.main(argv)`` in this process with the launch counters set to
    0 just before and read just after: (printed lines, launches, wall,
    calls). ``record`` names functions, as (owner, attribute), whose calls
    in the run are kept (``recording``); ``calls`` holds them in order."""
    import contextlib
    import io

    from enflows_tpu_torch import cli

    out = io.StringIO()
    calls = []
    with contextlib.ExitStack() as stack:
        for owner, name in record:
            stack.enter_context(recording(owner, name, calls))
        reset_launches(*counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches(counters)
    check(rc == 0, f"cli {argv}: exit {rc}")
    return out.getvalue().strip().splitlines(), launches, wall, calls


class Call(NamedTuple):
    args: tuple
    kwargs: dict
    key_state: object       # the ``key=`` generator's state before the call
    result: object


@contextlib.contextmanager
def recording(owner, name, calls):
    """Replace ``owner.name`` by a wrapper that calls it and appends a
    ``Call`` to ``calls``; it launches nothing of its own."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        key = kwargs.get("key")
        state = key.get_state().clone() if key is not None else None
        out = real(*args, **kwargs)
        calls.append(Call(args, kwargs, state, out))
        return out
    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def replay_plain_elbo(VI, call, reorder_seed):
    """A recorded ``optimize_elbo`` call again on the plain path, from the
    same flow and generator state: once on the same draws and once with
    each step's draws in another row order (the same samples, summed in
    another order). Returns the two nELBO histories on the host."""
    logp, flow = call.args[:2]
    opt = call.args[2] if len(call.args) > 2 else call.kwargs.get(
        "optimizer")
    kw = call.kwargs
    dev = kw["key"].device

    def key():
        g = torch.Generator(device=dev)
        g.set_state(call.key_state)
        return g
    fit = dict(dim=kw["dim"], batch_size=kw.get("batch_size", 100),
               nsteps=kw.get("nsteps", 1000),
               antithetic=kw.get("antithetic", True),
               dtype=kw.get("dtype", torch.float32), stl=kw.get("stl", False))
    plain = VI.optimize_elbo(logp, flow, opt, key=key(),
                             use_fused_coupling=False, **fit)
    reorder = torch.Generator(device=dev).manual_seed(reorder_seed)

    def draws(generator, step, batch_size, d, dtype, device):
        xi = VI._base_draws(generator, step, batch_size, d, dtype, device)
        return xi[torch.randperm(batch_size, generator=reorder,
                                 device=device)]
    other = VI._fit(logp, flow, opt, draws, key=key(), opt_state=None,
                    nelbo_history=None, use_fused_coupling=False, **fit)
    return plain.nelbo_history.cpu(), other.nelbo_history.cpu()


def hold_cli_elbo(VI, what, call, reorder_seed):
    """The ELBO fit of a CLI run (its recorded call, through B1 and B2) held
    to the plain path from the same start on the same draws by
    ``hold_history``. Returns the text for the phase's line."""
    hist = call.result.nelbo_history.cpu()
    check(bool(torch.isfinite(hist).all()), f"{what}: history {hist}")
    plain, other = replay_plain_elbo(VI, call, reorder_seed)
    rel, noise, rule = hold_history(what, hist, plain, other)
    return (f"{len(hist)} nELBO steps {float(hist[0]):.5f} -> "
            f"{float(hist[-1]):.5f}, fused vs plain max rel diff {rel:.3e}, "
            f"the plain path on reordered rows vs plain {noise:.3e} "
            f"({rule})")


def leapfrog_turns(step_size, inv_mass_diag, num_steps):
    """Each coordinate's rotation, in turns, over ``num_steps`` leapfrog
    steps on a standard Gaussian: num_steps * arccos(1 - eps^2 w / 2) /
    2 pi, w the inverse mass (nan where the steps are unstable). Near an
    integer a trajectory ends about where it began."""
    c = 1.0 - 0.5 * float(step_size) ** 2 * inv_mass_diag.double().cpu()
    turns = num_steps * torch.arccos(c.clamp(-1.0, 1.0)) / (2 * math.pi)
    return torch.where(c.abs() <= 1.0, turns, float("nan"))


def cli_commands(counters, card):
    """``[cli elbo]``, ``[cli sample]`` and ``[cli infer]``: the commands at
    tests/test_utils.py:179-290's sizes on the card, each with its launch
    counts: the ELBO fit B1 + B2 a step, no kernel in ``sample``, the
    elementwise rung's fit B1 + B2 a step. Each ELBO fit (recorded from the
    run) is held to the plain path from the same start by
    ``hold_history``. HMC's rhat is held to 1.5 unless a coordinate's 32
    leapfrog steps turn within ``HMC_RESONANCE`` of a whole number of
    turns. Returns (B1/B2) launches by path."""
    import re

    import enflows_tpu_torch.mcmc as mcmc
    import enflows_tpu_torch.train as train
    from enflows_tpu_torch.train import vi as VI

    infer_module = sys.modules["enflows_tpu_torch.infer"]

    lines, launches, wall, calls = run_cli(
        ["train", "--train.objective=elbo", "--flow.dim=1",
         "--train.nsteps=50"], counters, record=[(train, "optimize_elbo")])
    loss = float(re.fullmatch(r"final loss: (-?\d+\.\d+)", lines[-1])[1])
    want = {**{k: 0 for k in launches}, "fwd": 50, "bwd": 50}
    check(launches == want and abs(loss) < 0.05 and len(calls) == 1,
          f"cli elbo: {lines}, launches {launches}, {len(calls)} fits")
    held = hold_cli_elbo(VI, "cli elbo", calls[0], 63)
    paths = {"cli elbo (d=1, n=200)": launches}
    print(f"[cli elbo] train --train.objective=elbo --flow.dim=1 "
          f"--train.nsteps=50: {lines[-1]!r}; launches {launch_text(launches)}"
          f"; {held}; wall {wall:.2f} s [{card}]", flush=True)

    lines, launches, wall, _ = run_cli(["sample", "--sampler.algorithm=smc",
                                        "--flow.dim=2"], counters)
    check(lines == ["SMC: 1 temperatures, logZ=1.8379"]
          and not any(launches.values()), f"cli sample smc: {lines}")
    print(f"[cli sample] smc, 8192 particles, the demo target (the base up "
          f"to log 2 pi): {lines[-1]!r}; no launch; wall {wall:.2f} s "
          f"[{card}]", flush=True)
    lines, launches, wall, calls = run_cli([
        "sample", "--sampler.algorithm=hmc", "--flow.dim=2",
        "--sampler.num_warmup=100", "--sampler.num_samples=100",
        "--sampler.num_chains=4"], counters, record=[(mcmc, "sample")])
    m = re.fullmatch(r"hmc: rhat=(\d+\.\d+) ess_min=(\d+) "
                     r"accept=(\d\.\d+)", lines[-1])
    stats = calls[0].result[2]
    turns = leapfrog_turns(stats.step_size, stats.inv_mass_diag, 32)
    off = float((turns - turns.round()).abs().min())
    check(m and math.isfinite(float(m[1])) and 0.5 < float(m[3]) <= 1.0
          and (float(m[1]) <= 1.5 or off < HMC_RESONANCE)
          and not any(launches.values()),
          f"cli sample hmc: {lines}, turns {turns.tolist()}")
    print(f"[cli sample] hmc, 4 chains x 100 + 100: {lines[-1]!r}; adapted "
          f"step size {float(stats.step_size):.4f}, inverse mass "
          f"{[round(v, 4) for v in stats.inv_mass_diag.tolist()]}, 32 steps "
          f"turn {[round(v, 3) for v in turns.tolist()]} times (nearest "
          f"whole number {off:.3f} away; rhat held to 1.5 unless under "
          f"{HMC_RESONANCE}); no launch; wall {wall:.2f} s [{card}]",
          flush=True)

    n = CLI_INFER_STEPS
    lines, launches, wall, calls = run_cli([
        "infer", "--flow.dim=2", "--sampler.precondition_kind=elementwise",
        "--sampler.num_warmup=100", "--sampler.num_samples=100",
        "--sampler.num_chains=4", f"--train.nsteps={n}"], counters,
        record=[(infer_module, "optimize_elbo")])
    want = {**{k: 0 for k in launches}, "fwd": n, "bwd": n}
    m = re.fullmatch(r"nuts: rhat=(\d+\.\d+) .*divergences=\d+ mean=.*",
                     lines[-1])
    check(len(lines) == 2 and lines[0].startswith(
        "precondition: family=elementwise ") and m
        and math.isfinite(float(m[1])) and launches == want
        and len(calls) == 1,
        f"cli infer: {lines}, launches {launches}, {len(calls)} fits")
    held = hold_cli_elbo(VI, "cli infer", calls[0], 64)
    paths["cli infer elementwise (d=2, n=1024)"] = launches
    print(f"[cli infer] infer --sampler.precondition_kind=elementwise on the "
          f"demo target, {n} VI steps, NUTS 4 x 100 + 100: {lines}; "
          f"launches {launch_text(launches)}; the rung's fit: {held}; wall "
          f"{wall:.2f} s [{card}]", flush=True)
    return {key: {p: v[key] for p, v in paths.items()}
            for key in ("fwd", "bwd")}


def trace_phase(et, device, card, steps=4):
    """``[trace]``: ``utils.trace`` around ``steps`` fused whitening steps
    of the flagship flow at 2^20 samples: the exported Chrome trace holds
    the trainer's range and a B3 wrapper's ``enflows.cuda.fused_negll_grad``
    range a step, and B3 kernel events each launched (the runtime call of
    the same correlation id) inside one of those ranges. Not every kernel
    event need be in the trace: late in this script the profiler has
    dropped the first step's (PERF.md §7), so the count is printed."""
    import tempfile

    from enflows_tpu_torch.train import optimize_whitening
    from enflows_tpu_torch.utils import trace

    gen = torch.Generator(device=device).manual_seed(61)
    with torch.no_grad():
        X = example_2d_flow(et, device)(torch.randn(
            steps << 20, 2, generator=gen, device=device))
    flow = flagship_flow(et, 2, gen, device)
    optimize_whitening(X, flow, nbatches=steps, nepochs=1)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            optimize_whitening(X, flow, nbatches=steps, nepochs=1)
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    name = "enflows.cuda.fused_negll_grad"
    ranges = [e for e in events if e.get("name") == name
              and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "ew_grad_kernel" in e.get("name", "")]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    held = [0] * len(ranges)
    for k in kernels:
        call = runtime.get(k.get("args", {}).get("correlation"))
        for i, r in enumerate(ranges):
            if call is not None and r["tid"] == call["tid"] and \
                    r["ts"] <= call["ts"] and \
                    call["ts"] + call.get("dur", 0) <= r["ts"] + r["dur"]:
                held[i] += 1
    trainer = sum(e.get("name") == "enflows.train.whitening"
                  for e in events)
    device_events = sum(e.get("cat") == "kernel" for e in events)
    check(len(ranges) == steps and kernels and sum(held) == len(kernels)
          and max(held) <= 1 and trainer,
          f"trace: {len(ranges)} {name} ranges, {len(kernels)} B3 kernel "
          f"events, launched inside the ranges {held}, {trainer} trainer "
          f"ranges")
    print(f"[trace] utils.trace over {steps} fused whitening steps (2^20 "
          f"samples): {len(events)} events ({device_events} kernel events), "
          f"{size} bytes; {len(ranges)} {name} ranges; {len(kernels)} B3 "
          f"kernel events in the trace, each launched inside one of them "
          f"(by range: {held}; {kernels[0]['name'][:48]}, "
          f"{', '.join(str(k['dur']) for k in kernels)} us); the "
          f"enflows.train.whitening range present [{card}]", flush=True)


def heartbeat_phase(device, card):
    """``[heartbeat]``: the default probe (a one-element sum on the card,
    synchronized in the watchdog thread) returns True within its
    deadline; an injected hung probe returns False at its deadline;
    ``run_checkpointed`` with a failing probe saves its rescue checkpoint
    of the last step and raises ``HeartbeatTimeout``, and with the default
    probe runs through."""
    import tempfile
    import threading

    from enflows_tpu_torch.utils import (HeartbeatTimeout, heartbeat,
                                         latest_step, restore_checkpoint,
                                         run_checkpointed)

    t0 = time.perf_counter()
    ok = heartbeat(30.0)
    probe_ms = (time.perf_counter() - t0) * 1e3
    check(ok is True, "heartbeat: the default probe failed")
    t0 = time.perf_counter()
    hung = heartbeat(1.0, _probe=lambda: threading.Event().wait())
    hung_s = time.perf_counter() - t0
    check(hung is False and 0.9 <= hung_s < 5.0,
          f"heartbeat: a hung probe gave {hung} after {hung_s:.2f} s")

    def step(state, i):
        return {"x": state["x"] * 1.5 + i, "i": state["i"] + 1}

    state0 = {"x": torch.ones(4, device=device), "i": 0}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run_checkpointed(step, state0, 10, ckpt_dir=tmp,
                             checkpoint_every=100, heartbeat_every=5,
                             heartbeat_timeout_s=30.0,
                             _heartbeat_fn=lambda t: False)
            raised = ""
        except HeartbeatTimeout as e:
            raised = str(e)
        check("after step 5" in raised and "checkpoint saved" in raised
              and latest_step(tmp) == 5,
              f"heartbeat: rescue {raised!r}, latest {latest_step(tmp)}")
        rescued = restore_checkpoint(tmp, state0, step=5)
        want = state0
        for i in range(5):
            want = step(want, i)
        check(torch.equal(rescued["x"], want["x"])
              and rescued["x"].device == want["x"].device
              and rescued["i"] == 5, "heartbeat: the rescue state differs")
    final, _ = run_checkpointed(step, state0, 10, heartbeat_every=5)
    check(final["i"] == 10, "heartbeat: the default probe stopped the loop")
    print(f"[heartbeat] default probe True in {probe_ms:.2f} ms; a hung "
          f"probe False after {hung_s:.2f} s (deadline 1 s); "
          f"run_checkpointed with a failing probe saved step 5 and raised "
          f"HeartbeatTimeout; with the default probe it ran 10 steps "
          f"[{card}]", flush=True)


def cli_phases(et, EW, counters, device, card):
    """The run utilities' and the CLI's phases. Returns B1-B3's launches by
    path and [cli train]'s times."""
    train_paths, times = cli_train(et, EW, counters, device, card)
    paths = cli_commands(counters, card)
    paths["negll"] = train_paths
    trace_phase(et, device, card)
    heartbeat_phase(device, card)
    return paths, times


# ----------------------------------------------------------------------
# bf16: the kernels' bf16-storage variants (B1-B3, B6, B4/B5) and bf16
# conditioners (B4/B5's bf16 wgmma), each held to its plain version with
# the same arithmetic and to float64, then the slices that run them.

BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# B4/B5 with bf16 conditioners: against a float64 plain run, within 2x the
# error of the plain version run with bf16-rounded operands and f32
# products, or 8e-3 (y, ladj) / 1.6e-3 (gradients) x (max + 1): the TF32
# floors times 8, bf16's unit roundoff against TF32's.
C_FWD_GATE_BF16, C_BWD_GATE_BF16 = (2.0, 8e-3), (2.0, 1.6e-3)
BF16_WHITEN_RTOL = 2e-2
BF16_HMC = dict(warmup=20, samples=20)


def bf16_ulp(t):
    """One bf16 ulp at |t| (2^-7 of its binade's bottom), elementwise."""
    m = t.float().abs()
    return torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8).clamp(
        min=2.0 ** -126)


def bf16_close(got, ref, tol, what):
    """A bf16 output against its plain version with the same arithmetic:
    within one bf16 ulp of the plain value beyond the float32 kernels' own
    tolerance (rtol = atol = ``tol``), since the two float32 values may
    differ by that before each is rounded once. Returns (max |d| in ulps,
    max |d|)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    lim = bf16_ulp(torch.maximum(g.abs(), r.abs())) + tol * (1 + r.abs())
    worst = float((d / bf16_ulp(torch.maximum(g.abs(), r.abs()))).max())
    check(got.dtype == torch.bfloat16 and bool((d <= lim).all()),
          f"{what}: {int((d > lim).sum())} elements beyond one bf16 ulp + "
          f"{tol:g}; max|d| {float(d.max()):.3e} ({worst:.1f} ulps)")
    return worst, float(d.max())


def tpu_bf16_gate(got, yard, ref64, what):
    """tests_tpu/test_tpu_kernels.py:139-163's gate: the kernel's max error
    against float64 within 4x the error of the chain's own bf16 path or
    1e-2 x (max|f64| + 1). Returns (kernel error, yardstick error)."""
    e_k = max_abs(got.double(), ref64)
    e_j = max_abs(yard.double(), ref64)
    check(e_k <= max(4.0 * e_j, 1e-2 * (float(ref64.abs().max()) + 1.0)),
          f"{what}: |kernel - f64| {e_k:.3e}, bf16 path {e_j:.3e}")
    return e_k, e_j


def ew_buffer_grads(EW, chain, plan, bufs, x16, mode, gy=None, gl=None,
                    dtype=torch.float32):
    """The plain version's cotangents of the plan's buffers (and of x for
    B2) in ``dtype``, by autograd through ``_run_plan`` on the same bf16
    values the kernel reads: B2 for the cotangents gy, gl; B3 for
    -(sum logN(y) + sum ladj). Returns (gx or the loss, gp, gw, gq)."""
    from enflows_tpu_torch.distributions.base import std_normal_logpdf

    leaves = [b.detach().to(dtype).requires_grad_(True) for b in bufs]
    xr = x16.to(dtype).requires_grad_(mode == "bwd")
    y, ladj = EW._run_plan(chain, plan, leaves, xr)
    zero = lambda gs, ts: [torch.zeros_like(t) if g is None else g
                           for g, t in zip(gs, ts)]
    if mode == "bwd":
        gs = torch.autograd.grad([y, ladj], [xr, *leaves],
                                 [gy.to(dtype), gl.to(dtype)],
                                 allow_unused=True)
        return zero(gs, [xr, *leaves])
    loss = -(std_normal_logpdf(y).sum() + ladj.sum())
    return (loss.detach(), *zero(torch.autograd.grad(
        loss, leaves, allow_unused=True), leaves))


def buffer_dict(grads):
    """The plan buffers' cotangents by name, the empty ones left out."""
    return {k: g for k, g in zip(("params", "rows", "dense Q"), grads)
            if g.numel()}


def phase_bf16_ew(et, EW, d, n_fwd, n_grad, gen, device, card):
    """B1, B2 and B3 with bf16 storage on the flagship chain: each against
    its plain version (``forward_and_ladj_plain`` on bf16, ``_run_plan`` on
    the same rounded buffers) within one bf16 ulp an element beyond the
    f32 tolerances, the buffers' cotangents (float32) by ``grads_ok``
    against the same function in float64; B1 and B3 against float64 by the
    TPU reference's bf16 gates (tests_tpu/test_tpu_kernels.py:139-185).
    Each timed against its float32 twin in turns, and its plain version."""
    chain = flagship_flow(et, d, gen, device)
    chain16 = copy.deepcopy(chain).to(torch.bfloat16)
    chain64 = copy.deepcopy(chain).double()
    x = torch.randn(n_fwd, d, generator=gen, device=device)
    x16 = x.to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        y, ladj = EW.fused_forward_and_ladj(chain, x16)
        yp, lp = EW.forward_and_ladj_plain(chain, x16)
        torch.cuda.synchronize()
        uy = bf16_close(y, yp, Y_TOL, f"B1 bf16 y d={d}")
        ul = bf16_close(ladj, lp, LADJ_TOL, f"B1 bf16 ladj d={d}")
        y64, l64 = EW.forward_and_ladj_plain(chain64, x.double())
        yj, lj = chain16.forward_and_ladj(x16)
        gy_ = tpu_bf16_gate(y, yj, y64, f"B1 bf16 y d={d} vs f64")
        gl_ = tpu_bf16_gate(ladj, lj, l64, f"B1 bf16 ladj d={d} vs f64")
        del y64, l64, yj, lj, yp, lp
        plan16, bufs16 = EW._chain_plan(chain, d, device, torch.bfloat16)
        plan, bufs = EW._chain_plan(chain, d, device)
        bufs16 = tuple(b.detach() for b in bufs16)
        bufs = tuple(b.detach() for b in bufs)
        t32, t16 = interleaved_ms(
            lambda: EW._launch("fwd", plan, x, bufs),
            lambda: EW._launch("fwd", plan16, x16, bufs16))
        plain_ms = cuda_ms(lambda: EW.forward_and_ladj_plain(chain, x16),
                           iters=3)
    bound = bound_of(2 * n_fwd * (2 * d + 1), n_fwd * hh_flops(d, 4))
    out["fwd"] = dict(max_abs_err=max(uy[1], ul[1]), ms=t16,
                      ms_f32_twin=t32, plain_ms=plain_ms, **bound)
    print(f"[bf16 B1] flagship d={d} n={n_fwd}: kernel vs plain bf16 y "
          f"{uy[0]:.1f} ulps (max|d| {uy[1]:.3e}), ladj {ul[0]:.1f} ulps; "
          f"vs f64 y {gy_[0]:.3e} (the chain's bf16 path {gy_[1]:.3e}), "
          f"ladj {gl_[0]:.3e} ({gl_[1]:.3e}); kernel {t16:.4f} ms, f32 "
          f"twin {t32:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{card}]",
          flush=True)
    del x, x16, y, ladj

    x, dropped = drop_exact_zero_rows(et, EW, chain, torch.randn(
        n_grad, d, generator=gen, device=device).to(torch.bfloat16).float())
    x16 = x.to(torch.bfloat16)
    with torch.no_grad():
        y, ladj = EW._launch("fwd", plan16, x16, bufs16)
    gy, gl = torch.cos(y.float()).to(torch.bfloat16), \
        (2.0 * ladj.float()).to(torch.bfloat16)
    gx, *gk = EW._launch("bwd", plan16, x16, bufs16, gy, gl)
    gxp, *gp = ew_buffer_grads(EW, chain, plan16, bufs16, x16, "bwd", gy, gl)
    _, *g64 = ew_buffer_grads(EW, chain, plan16, bufs16, x16, "bwd", gy, gl,
                              torch.float64)
    torch.cuda.synchronize()
    ux = bf16_close(gx, gxp.to(torch.bfloat16), G_RTOL, f"B2 bf16 gx d={d}")
    worst = grads_ok(*(buffer_dict(g) for g in (gk, gp, g64)))
    t32, t16 = interleaved_ms(
        lambda: EW._launch("bwd", plan, x, bufs, gy.float(), gl.float()),
        lambda: EW._launch("bwd", plan16, x16, bufs16, gy, gl))
    plain_ms = cuda_ms(lambda: ew_buffer_grads(EW, chain, plan16, bufs16,
                                               x16, "bwd", gy, gl), iters=3)
    bound = bound_of(2 * x.shape[0] * (3 * d + 1),
                     3 * x.shape[0] * hh_flops(d, 4))
    out["bwd"] = dict(max_abs_err=max(ux[1], worst), ms=t16, ms_f32_twin=t32,
                      plain_ms=plain_ms, **bound)
    print(f"[bf16 B2] flagship d={d} n={n_grad} ({dropped} exact-zero rows "
          f"dropped): gx vs plain bf16 {ux[0]:.1f} ulps; buffer cotangents "
          f"max|kernel - plain| {worst:.3e} (held to float64); kernel "
          f"{t16:.4f} ms, f32 twin {t32:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{card}]",
          flush=True)

    n = x.shape[0]
    loss, *gk = EW._launch("negll", plan16, x16, bufs16)
    lossp, *gp = ew_buffer_grads(EW, chain, plan16, bufs16, x16, "negll")
    _, *g64 = ew_buffer_grads(EW, chain, plan16, bufs16, x16, "negll",
                              dtype=torch.float64)
    v = (-loss / n).to(torch.bfloat16)
    vp = (lossp / n).to(torch.bfloat16)
    uv = bf16_close(v, vp, NEGLL_RTOL, f"B3 bf16 negll d={d}")
    worst = grads_ok(*(buffer_dict(g) for g in (gk, gp, g64)))
    vw, gw = EW.fused_negll_value_and_grad(chain, x16)
    v64, g64c = EW.negll_value_and_grad_plain(chain64, x.double())
    torch.cuda.synchronize()
    check(vw.dtype == torch.bfloat16 and abs(float(vw) - float(v64))
          < 2e-2 * (abs(float(v64)) + 1.0),
          f"B3 bf16 negll d={d}: {float(vw)} vs f64 {float(v64)}")
    g_err = 0.0
    for k, r in g64c.items():
        check(gw[k].dtype == torch.float32, f"B3 bf16 grad {k} dtype")
        err = max_abs(gw[k].double(), r)
        check(err < 3e-2 * (float(r.abs().max()) + 1.0),
              f"B3 bf16 grad {k} d={d}: {err:.3e} from f64")
        g_err = max(g_err, err / (float(r.abs().max()) + 1.0))
    t32, t16 = interleaved_ms(
        lambda: EW._launch("negll", plan, x, bufs),
        lambda: EW._launch("negll", plan16, x16, bufs16))
    plain_ms = cuda_ms(lambda: EW.negll_value_and_grad_plain(chain, x16),
                       iters=3)
    bound = bound_of(2 * n * d, 3 * n * hh_flops(d, 4))
    out["negll"] = dict(max_abs_err=max(uv[1], worst), ms=t16,
                        ms_f32_twin=t32, plain_ms=plain_ms, **bound)
    print(f"[bf16 B3] flagship d={d} n={n}: negll {float(v):.6g} vs plain "
          f"bf16 {float(vp):.6g} ({uv[0]:.1f} ulps), vs f64 {float(v64):.6g};"
          f" buffer cotangents max|kernel - plain| {worst:.3e} (held to "
          f"float64); parameter gradients vs f64 {g_err:.3e} x (max + 1) "
          f"(gate 3e-2); kernel {t16:.4f} ms, f32 twin {t32:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}) [{card}]", flush=True)
    return out


def phase_bf16_b6(et, TL, gen, device, card):
    """B6 with bf16 q and p at the BASELINE leapfrog config against its
    plain version with the same arithmetic (``leapfrog_plain`` on bf16):
    q_L, p_L, logp_0, logp_L within one bf16 ulp beyond B6's f32 tolerance;
    timed against its float32 twin in turns, and its plain version."""
    n, d, steps = LF["chains"], LF["dim"], LF["steps"]
    chain = leapfrog_chain(et, d, gen, device)
    q = (0.3 * torch.randn(n, d, generator=gen, device=device)).to(
        torch.bfloat16)
    p = torch.randn(n, d, generator=gen, device=device).to(torch.bfloat16)
    eps = torch.tensor(0.05, device=device)
    got = TL.fused_leapfrog(chain, q, p, eps, steps)
    ref = TL.leapfrog_plain(chain, q, p, eps, steps)
    torch.cuda.synchronize()
    held = [bf16_close(g, r, LF_TOL, f"B6 bf16 {name}")
            for g, r, name in zip(got, ref, ("q_L", "p_L", "logp_0",
                                             "logp_L"))]
    args16 = TL._prepare(chain, q, eps, storage=torch.bfloat16)
    args = TL._prepare(chain, q.float(), eps)
    q32, p32 = q.float(), p.float()
    t32, t16 = interleaved_ms(lambda: TL._launch(args, q32, p32, steps),
                              lambda: TL._launch(args16, q, p, steps),
                              iters=10)
    plain_ms = cuda_ms(lambda: TL.leapfrog_plain(chain, q, p, eps, steps),
                       iters=2, warmup=1)
    bound = bound_of(2 * (4 * n * d + 2 * n),
                     (steps + 1) * 2 * n * hh_flops(d, 4))
    G, E, blk, grid, bps, regs, local = b6_geometry(TL, args16, n, d,
                                                    bf16=True)
    print(f"[bf16 B6] BASELINE chain {n} x d={d} x L={steps}: kernel vs "
          f"plain bf16 "
          + ", ".join(f"{name} {u:.1f} ulps" for (u, _), name in
                      zip(held, ("q_L", "p_L", "logp_0", "logp_L")))
          + f"; kernel {t16:.4f} ms, f32 twin {t32:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); G={G} E={E} block {blk}: {bps} blocks/SM,"
          f" {regs} registers, {local} local bytes [{card}]", flush=True)
    return dict(max_abs_err=max(e for _, e in held), ms=t16,
                ms_f32_twin=t32, plain_ms=plain_ms, **bound)


def bf16_conditioners(stack):
    """``stack`` with every coupling's conditioner computing in bf16."""
    for s in stack.stages:
        if hasattr(s, "conditioner"):
            s.conditioner.compute_dtype = "bfloat16"
    return stack


def bf16_grads(C, chain, x, forward):
    """(gx, {parameter: gradient}) of sum(sin y) + sum(ladj^2), the loss
    taken in float32 whatever y's storage."""
    params = dict(chain.named_parameters())
    xr = x.clone().requires_grad_(True)
    y, ladj = forward(chain, xr)
    y, ladj = y.float(), ladj.float()
    gs = torch.autograd.grad(torch.sin(y).sum() + (ladj * ladj).sum(),
                             [xr, *params.values()], allow_unused=True)
    return gs[0], {k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(params.items(), gs[1:])}


def scaled_err(got, ref):
    """max|got - ref| / (max|ref| + 1), as the gates scale their floors."""
    got, ref = got.float(), ref.float()
    return max_abs(got, ref) / (float(ref.abs().max()) + 1.0)


def phase_bf16_coupling(et, C, kind, n, gen, device, card):
    """B4 and B5 on the BASELINE stack with bf16 conditioners, with float32
    storage and with bf16 storage: y, ladj, gx and every gradient against a
    float64 plain run under the bf16 yardstick (``C_*_GATE_BF16``: 2x the
    plain version with bf16-rounded operands and f32 products, or 8x the
    TF32 floors), on the rows no closer than KNOT_EPS to a spline knot for
    the gradients; the float64 run is the same weights with f32
    conditioners. Timed against the float32 (TF32) twin in turns, the
    plain version, the bf16 FLOP bound and the same products in bf16
    torch.matmul. The kernels line's error of B4 is y's and ladj's from
    the plain bf16-product run, of B5 gx's and the gradients', each scaled
    by (max + 1)."""
    stack32 = baseline_stack(et, kind, gen, device)
    d = BASELINE["dim"]
    st32 = C._stack_structure(stack32, d)
    stack = bf16_conditioners(copy.deepcopy(stack32))
    st = C._stack_structure(stack, d)
    # The exact function: the same weights with f32 conditioners
    # (compute_dtype None), every product in float64.
    stack64 = copy.deepcopy(stack32).double()
    x = 2.2 * torch.randn(n, d, generator=gen, device=device)
    readings, err4, err5 = [], 0.0, 0.0
    for storage in (torch.float32, torch.bfloat16):
        xs = x.to(storage)
        tag = "f32" if storage == torch.float32 else "bf16"
        with torch.no_grad():
            y, ladj = C.fused_coupling_forward_and_ladj(stack, xs)
            yb, lb = plain_coupling(C)(stack, xs)
            y64, l64 = plain_coupling(C)(stack64, xs.double())
            torch.cuda.synchronize()
            check(y.dtype == storage and ladj.dtype == storage,
                  f"B4 bf16 {kind} {tag} storage dtypes")
            hy = tf32_gate(y.float(), yb.float(), y64, C_FWD_GATE_BF16,
                           f"B4 bf16 {kind} {tag} y")
            hl = tf32_gate(ladj.float(), lb.float(), l64, C_FWD_GATE_BF16,
                           f"B4 bf16 {kind} {tag} ladj")
            err4 = max(err4, scaled_err(y, yb), scaled_err(ladj, lb))
            del y, ladj, yb, lb, y64, l64
        # Knots of the exact function (f32 conditioners in float64).
        xk, dropped = drop_near_knot_rows(et, stack32, xs.float())
        xk = xk.to(storage)
        gx, g = bf16_grads(C, stack, xk, C.fused_coupling_forward_and_ladj)
        gxb, gb = bf16_grads(C, stack, xk, plain_coupling(C))
        gx64, g64 = bf16_grads(C, stack64, xk.double(), plain_coupling(C))
        torch.cuda.synchronize()
        hx = tf32_gate(gx.float(), gxb.float(), gx64, C_BWD_GATE_BF16,
                       f"B5 bf16 {kind} {tag} gx")
        grads = {k: tf32_gate(g[k], gb[k], g64[k], C_BWD_GATE_BF16,
                              f"B5 bf16 {kind} {tag} grad {k}")
                 for k in g64}
        k = max(grads, key=lambda k: grads[k].share)
        err5 = max([err5, scaled_err(gx, gxb)]
                   + [scaled_err(g[j], gb[j]) for j in g])
        readings.append((
            f"{tag} storage: y {hy}, ladj {hl}; gx {hx}, nearest its limit "
            f"grad {k} {grads[k]} ({100 * grads[k].share:.0f}% of it; "
            f"{dropped} rows within {KNOT_EPS} of a knot dropped)").replace(
                "plain TF32", "plain bf16 products"))
        del gx, g, gxb, gb, gx64, g64
    # Times: B4 writing B5's rows and B5 on them, as training runs them,
    # the bf16 variant against its TF32 twin in turns; bf16 storage once.
    with torch.no_grad():
        wbuf, pbuf = C._stack_plan(stack, st, torch.float32, device)
        y, ladj, _ = C._launch_fwd(st, x, wbuf, pbuf)
    gy, gl = torch.cos(y), 2.0 * ladj
    x16 = x.to(torch.bfloat16)
    t32, t16 = interleaved_ms(
        lambda: C._launch_fwd(st32, x, wbuf, pbuf, True),
        lambda: C._launch_fwd(st, x, wbuf, pbuf, True), iters=5)
    t16_io = cuda_ms(lambda: C._launch_fwd(st, x16, wbuf, pbuf, True),
                     iters=5)
    b5_32 = stored_b5_ms(C, st32, x, wbuf, pbuf, gy, gl)
    b5_16 = stored_b5_ms(C, st, x, wbuf, pbuf, gy, gl)
    b5_32 = min(b5_32, stored_b5_ms(C, st32, x, wbuf, pbuf, gy, gl))
    b5_16_io = stored_b5_ms(C, st, x16, wbuf, pbuf, gy.to(torch.bfloat16),
                            gl.to(torch.bfloat16))
    with torch.no_grad():
        plain4 = cuda_ms(lambda: C.coupling_forward_plain(st, wbuf, pbuf, x),
                         iters=3, warmup=1)
    params = list(stack.parameters())
    xr = x.clone().requires_grad_(True)
    y0, l0 = plain_coupling(C, physical_order=True)(stack, xr)
    plain5 = cuda_ms(lambda: torch.autograd.grad(
        [y0, l0], [xr, *params], [gy, gl], retain_graph=True), iters=3,
        warmup=1)
    del y0, l0, xr
    lib4 = matmul_only_ms(st, n, device, False, dtype=torch.bfloat16)
    lib5 = matmul_only_ms(st, n, device, True, dtype=torch.bfloat16)
    flops = conditioner_flops(st) * n
    b4b = bound_of(4 * (n * (2 * d + 1) + st.w_len), flops, BF16_FLOP_PER_S)
    b5b = bound_of(4 * (n * (3 * d + 1) + 2 * st.w_len), 2 * flops,
                   BF16_FLOP_PER_S)
    print(f"[bf16 B4/B5] {kind} d={d} 4x{BASELINE['hidden']} n={n}, bf16 "
          f"conditioners: |kernel - f64| {'; '.join(readings)}; |kernel - "
          f"plain bf16 products| / (max + 1): y, ladj {err4:.3e}, gx and "
          f"gradients {err5:.3e} [{card}]", flush=True)
    print(f"[bf16 B4] {kind}: kernel {t16:.3f} ms writing B5's rows "
          f"(bf16 storage {t16_io:.3f} ms), TF32 twin {t32:.3f} ms, plain "
          f"{plain4:.3f} ms, bf16 FLOP bound {b4b['bound_ms']:.3f} ms "
          f"({flops / 1e9:.1f} GFLOP, {flops / t16 / 1e9:.2f} TFLOP/s), "
          f"the products alone in bf16 torch.matmul {lib4:.3f} ms [{card}]",
          flush=True)
    print(f"[bf16 B5] {kind}: kernel {b5_16:.3f} ms on B4's rows (bf16 "
          f"storage {b5_16_io:.3f} ms), TF32 twin {b5_32:.3f} ms, plain "
          f"autograd backward {plain5:.3f} ms, bf16 FLOP bound "
          f"{b5b['bound_ms']:.3f} ms, dh and dW alone in bf16 torch.matmul "
          f"{lib5:.3f} ms [{card}]", flush=True)
    print(f"[bf16 B4] {kind} redesign: "
          f"{coupling_kernel_note(C, st, False, t16, flops, BF16_FLOP_PER_S, lib4)}"
          f" [{card}]", flush=True)
    print(f"[bf16 B5] {kind} redesign: "
          f"{coupling_kernel_note(C, st, True, b5_16, 2 * flops, BF16_FLOP_PER_S, lib5)}"
          f" [{card}]", flush=True)
    return (dict(max_abs_err=err4, ms=t16, ms_f32_twin=t32,
                 ms_bf16_storage=t16_io, plain_ms=plain4,
                 **{**b4b, "library_ms": lib4}),
            dict(max_abs_err=err5, ms=b5_16, ms_f32_twin=b5_32,
                 ms_bf16_storage=b5_16_io, plain_ms=plain5,
                 **{**b5b, "library_ms": lib5}))


class _MatmulBF16Reordered(torch.autograd.Function):
    """``ops.coupling._MatmulBF16`` with every product's f32 sum taken in
    reversed order (h[:, ::-1] @ W[::-1], and so on in the backward): the
    same function, another rounding."""

    @staticmethod
    def forward(ctx, h, W):
        h16, W16 = (t.to(torch.bfloat16).float() for t in (h, W))
        ctx.save_for_backward(h16, W16)
        ctx.dtypes = (h.dtype, W.dtype)
        return torch.matmul(h16.flip(1), W16.flip(0))

    @staticmethod
    def backward(ctx, g):
        h16, W16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16).float()
        return (torch.matmul(g16.flip(1), W16.flip(1).T).to(ctx.dtypes[0]),
                torch.matmul(h16.flip(0).T, g16.flip(0)).to(ctx.dtypes[1]))


class _MatmulBF16TensorCores(torch.autograd.Function):
    """``ops.coupling._MatmulBF16`` with its products on the tensor cores
    (``torch.mm`` of the bf16 operands with a float32 output: cuBLAS, f32
    accumulation): the plain route's operands, summed by the hardware that
    B4/B5's ``wgmma`` sums on. Read only, to tell that hardware's
    accumulation from the kernels' own arithmetic."""

    @staticmethod
    def forward(ctx, h, W):
        h16, W16 = h.to(torch.bfloat16), W.to(torch.bfloat16)
        ctx.save_for_backward(h16, W16)
        ctx.dtypes = (h.dtype, W.dtype)
        return torch.mm(h16, W16, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h16, W16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        return (torch.mm(g16, W16.T, out_dtype=torch.float32)
                .to(ctx.dtypes[0]),
                torch.mm(h16.T, g16, out_dtype=torch.float32)
                .to(ctx.dtypes[1]))


class patched:
    """``setattr(obj, name, value)`` inside the block, undone after it."""

    def __init__(self, obj, name, value):
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.was = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.was)


def coupling_plain_negll(C):
    """negll of a coupling stack through the plan's plain version, as
    ``optimize_whitening``'s loss: bf16-operand products for a bf16
    conditioner, f32 (or float64) ones for an f32 conditioner."""
    from enflows_tpu_torch.distributions.base import std_normal_logpdf_sum

    def loss(flow, x):
        st = C._stack_structure(flow, x.shape[1])
        wbuf, pbuf = C._stack_plan(flow, st, x.dtype, x.device)
        y, ladj = C.coupling_forward_plain(st, wbuf, pbuf, x)
        return -(std_normal_logpdf_sum(y).sum() + ladj.sum()) / x.shape[0]
    return loss


def bf16_step_diagnosis(C, kind, flow, xb, gen, card):
    """One B4 + B5 step's negll and gradients on one batch of the slice,
    at the fitted parameters, against the plain bf16-product route on the
    same batch, beside runs that differ from that route in rounding alone:
    the rows in another order, the products' sums reversed, the products
    on the tensor cores, and every sum in float64 (the operands still
    rounded to bf16; the yardstick of the others). Reads, per run, the
    largest relative L2 distance of a parameter's gradient from the
    float64-sum run and from the plain route, and how much of its distance
    from the float64 run points toward zero (sum((g - g64) sign(g64)) /
    sum|g - g64|; 0 for unbiased rounding, -1 for sums cut toward zero).
    The kernels' distance must stay within 2x the largest rounding-only
    one (a product that skipped a bf16 rounding moves a gradient by ~2^-9
    relative an element, several times that). Returns both distances."""
    from enflows_tpu_torch.train import whitening as W

    loss = coupling_plain_negll(C)
    perm = torch.randperm(xb.shape[0], generator=gen, device=xb.device)

    def grads(f, x, fn):
        v, g = W.mvnormal_negll_grad(f, x, loss_fn=fn)
        return float(v), {k: g[k].double() for k in sorted(g)}

    runs = {"kernels": grads(flow, xb, W.mvnormal_negll_coupling),
            "plain": grads(flow, xb, loss),
            "rows reordered": grads(flow, xb[perm], loss)}
    with patched(C, "_MatmulBF16", _MatmulBF16Reordered):
        runs["sums reversed"] = grads(flow, xb, loss)
    with patched(C, "_MatmulBF16", _MatmulBF16TensorCores):
        runs["tensor-core products"] = grads(flow, xb, loss)
    v64, g64 = grads(copy.deepcopy(flow).double(), xb.double(), loss)

    def dist(g, ref):
        return max((float((g[k] - ref[k]).norm() / ref[k].norm()), k)
                   for k in ref if float(ref[k].norm()) > 0)

    def toward_zero(g):
        num = sum(float(((g[k] - g64[k]) * g64[k].sign()).sum()) for k in g)
        den = sum(float((g[k] - g64[k]).abs().sum()) for k in g)
        return num / max(den, 1e-300)

    rows = []
    for name, (v, g) in runs.items():
        d64, k64 = dist(g, g64)
        dp = dist(g, runs["plain"][1])[0] if name != "plain" else 0.0
        rows.append(f"{name} {d64:.3e} ({k64}; from the plain route "
                    f"{dp:.3e}; toward zero {toward_zero(g):+.2f}; negll "
                    f"{abs(v - v64) / abs(v64):.2e})")
    kernel = dist(runs["kernels"][1], g64)[0]
    rounding = max(dist(g, g64)[0] for name, (_, g) in runs.items()
                   if name != "kernels")
    print(f"[bf16 step diagnosis] {kind} d={xb.shape[1]} n={xb.shape[0]}, "
          f"the fitted stack: largest relative L2 distance of a parameter "
          f"gradient from the float64-sum run: {'; '.join(rows)}; the "
          f"kernels {kernel / rounding:.2f}x the largest rounding-only run "
          f"(limit 2x) [{card}]", flush=True)
    check(kernel <= 2.0 * rounding,
          f"bf16 step diagnosis {kind}: the kernels' gradients {kernel:.3e} "
          f"from the float64-sum run, the rounding-only runs' {rounding:.3e}")
    return kernel, rounding


def bf16_coupling_slice(et, C, EW, kind, initial, X, gen, card):
    """The coupling slice with bf16 conditioners: ``optimize_whitening`` of
    the identity-initialized BASELINE stack, 3 epochs of 4 batches of 2^17,
    with the counters set to 0 just before: exactly 12 B4 and 12 B5
    launches of the bf16 path and none of the TF32 one. The history is held
    to the plain bf16-product route (the same trainer with the plan's plain
    version, ``_MatmulBF16`` products, in place of B4/B5) by the coupling
    slice's noise rule, the noise being how far the plain path on rows in
    another order and with its products on the tensor cores sits from it:
    runs that differ from it in rounding alone. The bijector route's
    history (bf16 layers throughout) is printed beside it; then one step's
    gradients are read against runs that differ in rounding alone
    (``bf16_step_diagnosis``)."""
    from enflows_tpu_torch.train import optimize_whitening
    from enflows_tpu_torch.train import whitening as W

    stack = bf16_conditioners(copy.deepcopy(initial))
    reset_launches(C.LAUNCHES_BF16, C.LAUNCHES, EW.LAUNCHES)
    res = optimize_whitening(X, copy.deepcopy(stack), adam, nbatches=4,
                             nepochs=3)
    hist = res.negll_history.cpu()
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES_BF16)
    check(launches == {"coupling_fwd": 12, "coupling_bwd": 12}
          and not any(C.LAUNCHES.values()),
          f"bf16 coupling slice {kind}: launches bf16 {launches}, TF32 "
          f"{dict(C.LAUNCHES)}, not exactly 12 + 12 bf16")
    check(bool(torch.isfinite(hist).all()) and float(hist[-1])
          < float(hist[0]), f"bf16 coupling slice {kind}: {hist.tolist()}")

    def plain_route(data):
        # optimize_whitening's steps (make_train_step, its batches) on the
        # plan's plain version.
        flow = copy.deepcopy(stack)
        step = W.make_train_step(
            adam(list(flow.parameters())),
            functools.partial(W.mvnormal_negll_grad,
                              loss_fn=coupling_plain_negll(C)))
        bs = data.shape[0] // 4
        return torch.stack([step(flow, data[b * bs:(b + 1) * bs])
                            for _ in range(3) for b in range(4)]).cpu()

    ref = plain_route(X)
    noise = [plain_route(rows_permuted_within_batches(X, 4, gen))]
    with patched(C, "_MatmulBF16", _MatmulBF16TensorCores):
        noise.append(plain_route(X))
    bij = optimize_whitening(X, copy.deepcopy(stack), adam, nbatches=4,
                             nepochs=3, use_fused=False).negll_history.cpu()
    gate = NoiseGate.of(hist, ref, noise)
    print(f"[bf16 coupling slice] {kind}: negll history "
          f"{[round(float(v), 5) for v in hist]}; plain bf16-product route "
          f"{[round(float(v), 5) for v in ref]}; {gate}; the plain route "
          f"on reordered rows {rel_diff(noise[0], ref):.3e} from it, with "
          f"tensor-core products {rel_diff(noise[1], ref):.3e}; bijector "
          f"route (bf16 layers) {[round(float(v), 5) for v in bij]}, max rel "
          f"diff {rel_diff(hist, bij):.3e}; launches {launches} [{card}]",
          flush=True)
    gate.check(f"bf16 coupling slice {kind}",
               "the plain bf16-product route")
    bf16_step_diagnosis(C, kind, res.result, X[:X.shape[0] // 4], gen, card)
    return launches


def bf16_whitening_slice(et, EW, X, gen, card):
    """The whitening slice on bf16 samples: the flagship flow on the
    slice's 2^22 samples rounded to bf16, 24 steps of 2^20, with the
    counters set to 0 just before: exactly 24 B3 launches of the bf16
    variant; then the fitted flow's full-data negll and its gradient
    through B1 and B2 (one launch each). The history within
    ``BF16_WHITEN_RTOL`` relative of the plain route (the chain's own
    forward, f32 arithmetic on the bf16 values); its final negll printed
    against the same fit on the float32 samples."""
    from enflows_tpu_torch.train import (mvnormal_negll_fused,
                                         optimize_whitening)

    flow = flagship_flow(et, 2, gen, X.device)
    X16 = X.to(torch.bfloat16)
    reset_launches(EW.LAUNCHES_BF16, EW.LAUNCHES)
    res = optimize_whitening(X16, copy.deepcopy(flow), nbatches=4,
                             nepochs=6)
    hist = res.negll_history.cpu()
    fitted = res.result
    negll = mvnormal_negll_fused(fitted, X16)
    grads = torch.autograd.grad(negll, list(fitted.parameters()))
    negll = negll.detach()
    torch.cuda.synchronize()
    launches = dict(EW.LAUNCHES_BF16)
    check(launches == {"fwd": 1, "bwd": 1, "negll": 24}
          and not any(EW.LAUNCHES.values()),
          f"bf16 whitening slice: bf16 launches {launches}, f32 "
          f"{dict(EW.LAUNCHES)}, not 24 B3 + 1 B1 + 1 B2")
    check(bool(torch.isfinite(hist).all()) and all(
        bool(torch.isfinite(g).all()) and g.dtype == torch.float32
        for g in grads), "bf16 whitening slice: history or gradient")
    plain = optimize_whitening(X16, copy.deepcopy(flow), nbatches=4,
                               nepochs=6, use_fused=False)
    h32 = optimize_whitening(X, copy.deepcopy(flow), nbatches=4,
                             nepochs=6).negll_history.cpu()
    rel = rel_diff(hist, plain.negll_history.cpu())
    print(f"[bf16 whitening slice] flagship d=2 on 2^22 bf16 samples, 24 "
          f"steps of 2^20: history {[round(float(v), 4) for v in hist]}; "
          f"max rel diff from the plain route {rel:.3e} (limit "
          f"{BF16_WHITEN_RTOL:g}); final negll {float(hist[-1]):.5f} "
          f"against {float(h32[-1]):.5f} on the float32 samples; the fitted "
          f"flow's full-data negll through B1 {float(negll):.5f}; launches "
          f"{launches} [{card}]", flush=True)
    check(rel <= BF16_WHITEN_RTOL,
          f"bf16 whitening slice: {rel:.3e} from the plain route")
    return launches


def bf16_hmc(et, TL, gen, device, card):
    """Flow-preconditioned HMC with bf16 chains through B6's bf16 variant:
    ``fused_flow_hmc_sample(dtype=torch.bfloat16)`` on a BASELINE
    pushforward (the leapfrog chain's inverse as transport), 8192 chains,
    ``BF16_HMC`` warmup + samples of L=64, the counters set to 0 just
    before: exactly one bf16 launch a transition. The draws finite, the
    acceptance within 0.3-1.0 (logp in bf16 is coarse: an ulp of 0.5 at
    |logp| ~ 70), moments printed."""
    from enflows_tpu_torch.mcmc.fused_hmc import fused_flow_hmc_sample

    n, dim, steps = LF["chains"], LF["dim"], LF["steps"]
    target = et.mcmc.FlowPushforwardTarget(
        leapfrog_chain(et, dim, gen, device).inverse())
    reset_launches(TL.LAUNCHES_BF16, TL.LAUNCHES)
    t0 = time.perf_counter()
    draws, _, stats = fused_flow_hmc_sample(
        target.whiten, gen, dim=dim, num_chains=n,
        num_warmup=BF16_HMC["warmup"], num_samples=BF16_HMC["samples"],
        num_steps=steps, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TL.LAUNCHES_BF16)
    total = BF16_HMC["warmup"] + BF16_HMC["samples"]
    check(launches == {"leapfrog": total} and not any(TL.LAUNCHES.values()),
          f"bf16 hmc: bf16 launches {launches}, f32 {dict(TL.LAUNCHES)}")
    acc = float(stats.accept_prob.float().mean())
    check(draws.dtype == torch.bfloat16 and bool(torch.isfinite(
        draws.float()).all()) and 0.3 <= acc <= 1.0,
          f"bf16 hmc: acceptance {acc}, dtype {draws.dtype}")
    f = draws.float()
    print(f"[bf16 hmc] {n} chains x d={dim} x L={steps}, "
          f"{BF16_HMC['warmup']} + {BF16_HMC['samples']} transitions on "
          f"bf16 chains: acceptance {acc:.3f}, step size "
          f"{float(stats.step_size):.4f}, draws mean {float(f.mean()):.4f} "
          f"sd {float(f.std()):.4f} (whitened space); {wall:.2f} s; "
          f"launches {launches} [{card}]", flush=True)
    return launches


def bf16_phases(et, EW, C, TL, X, X64, initial_stacks, device, card):
    """Every bf16 phase, each on generators of its own. Returns the rows of
    the kernels line."""
    gen = torch.Generator(device=device).manual_seed(130)
    t0 = time.perf_counter()
    ew2 = phase_bf16_ew(et, EW, 2, 1 << 24, 1 << 22, gen, device, card)
    ew50 = phase_bf16_ew(et, EW, 50, 1 << 17, 1 << 17, gen, device, card)
    b6 = phase_bf16_b6(et, TL, gen, device, card)
    cp = {k: phase_bf16_coupling(et, C, k, 1 << 17, gen, device, card)
          for k in ("affine", "spline")}
    slice_launches = {k: bf16_coupling_slice(et, C, EW, k, initial_stacks[k],
                                             X64, gen, card)
                      for k in ("affine", "spline")}
    ew_launches = bf16_whitening_slice(et, EW, X, gen, card)
    hmc_launches = bf16_hmc(et, TL, gen, device, card)
    print(f"[bf16 time] {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    src = "enflows_tpu_torch/ops/csrc/elementwise.cu"
    pallas = "enflows_tpu/ops/pallas/elementwise.py"
    path = "bf16 whitening slice (d=2, n=2^20; the fit's full-data " \
        "evaluation, n=2^22)"
    rows = []
    for key, name, line in (("fwd", "B1 fused_forward_and_ladj bf16", 442),
                            ("bwd", "B2 fused forward backward bf16", 642),
                            ("negll", "B3 fused_negll_value_and_grad bf16",
                             853)):
        vals = {**ew2[key], **{f"{k}_d50": ew50[key][k] for k in
                               ("ms", "ms_f32_twin", "plain_ms",
                                "bound_ms")}}
        vals["max_abs_err"] = max(ew2[key]["max_abs_err"],
                                  ew50[key]["max_abs_err"])
        rows.append((name, {path: ew_launches[key]}, src,
                     f"{pallas}:{line}", vals))
    csrc = "enflows_tpu_torch/ops/csrc/coupling.cu"
    cpallas = "enflows_tpu/ops/pallas/coupling.py"
    for k in ("affine", "spline"):
        for i, (which, line) in enumerate((("B4 fused_coupling_forward_and_"
                                            "ladj", 678),
                                           ("B5 fused coupling backward",
                                            617))):
            key = ("coupling_fwd", "coupling_bwd")[i]
            rows.append((f"{which} bf16 conditioners ({k} BASELINE)",
                         {f"bf16 coupling slice {k} (d=64, n=2^17)":
                          slice_launches[k][key]}, csrc,
                         f"{cpallas}:{line}", cp[k][i]))
    rows.append((f"B6 fused_leapfrog bf16 (BASELINE {LF['chains']} x "
                 f"{LF['dim']} x {LF['steps']})",
                 {"bf16 hmc (8192 x d=50 x L=64)":
                  hmc_launches["leapfrog"]},
                 "enflows_tpu_torch/ops/csrc/leapfrog.cu",
                 "enflows_tpu/ops/pallas/leapfrog.py:157", b6))
    return rows


# ----------------------------------------------------------------------
# The multi-device layer (enflows_tpu_torch/parallel/) on the one card:
# child processes, one a rank, each under a timeout. [mesh nccl w1]: one
# rank, NCCL on cuda:0, every sharded entry point held to the unsharded one
# on the same generator; [mesh gloo w2]: two ranks sharing cuda:0 over gloo
# (NCCL refuses two ranks on one device), every rank's kernels on the card
# and the cross-rank arithmetic real. The parent builds the library first.

MESH_TIMEOUT = 300           # seconds, each child group
MESH_WHITEN = dict(rows=1 << 22, nbatches=4, epochs_w1=3, epochs_w2=6)
# Antithetic pairs a step: the coupling template's 2^16 pairs a rank keep
# each rank's 2^17 rows on the kernels by the row rule (C-3).
MESH_VI = dict(steps=12, pairs_ew=1 << 16, pairs_coupling_rank=1 << 16)
MESH_NUTS = dict(chains=32, warmup=40, samples=20)
MESH_CLI = dict(rows=1 << 20, nbatches=4, epochs=2)
MESH_EVENT = dict(dim=64, n=1 << 20)


def mesh_counts(*counters):
    """Every launch count, once the card has finished its work."""
    torch.cuda.synchronize()
    return kernel_launches(counters)


def collectives_share(run, steps, step_ms, backend):
    """``run()`` (``steps`` steps) under ``torch.profiler``: (the profiled
    ms a step, the host ms a step inside the ``enflows.parallel.*``
    ranges, the collectives' ms a step, their share, what that is). Under
    NCCL the host only enqueues an asynchronous op, so the collectives'
    time is the device time of the NCCL kernels in the trace, its share
    taken of the unprofiled step ``step_ms``. Under gloo the rank blocks
    in the op (the host copies of a staged op included), so it is the host
    time inside the ranges, its share taken of the profiled wall, which
    the profiler lengthens alike."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    host = sum(e.cpu_time_total for e in prof.key_averages()
               if e.key.startswith("enflows.parallel.")) / 1e3 / steps
    if backend == "gloo":
        return wall, host, host, host / wall, "host ms in the ranges"
    by_name, _ = device_kernel_us(prof)
    nccl = {k: us for k, us in by_name.items() if "nccl" in k.lower()}
    dev = sum(nccl.values()) / 1e3 / steps
    return wall, host, dev, dev / step_ms, (
        f"device ms of the NCCL kernels, {len(nccl)} kernel names in the "
        f"trace, of the unprofiled step")


def mesh_whitening(et, EW, mesh, X, flow, epochs, card, tag, reference):
    """The whitening slice's trainer on ``mesh``: each rank steps on its
    rows of every batch (B3), the history held within ``SLICE_RTOL`` of the
    unsharded fused run and every replicated output equal on every rank.
    Returns the rank's launches and its ms a step."""
    from enflows_tpu_torch.utils import assert_replicated_consistent

    reset_launches(EW.LAUNCHES)
    t0 = time.perf_counter()
    r = et.optimize_whitening(X, flow, nbatches=MESH_WHITEN["nbatches"],
                              nepochs=epochs, mesh=mesh, batch_axis="batch")
    hist = r.negll_history.cpu()
    launches = mesh_counts(EW.LAUNCHES)
    step_ms = (time.perf_counter() - t0) * 1e3 / hist.numel()
    steps = epochs * MESH_WHITEN["nbatches"]
    check(launches == dict(fwd=0, bwd=0, negll=steps),
          f"{tag} whitening: launches {launches}, not {steps} B3")
    assert_replicated_consistent([r.result, r.optimizer_state, hist],
                                 "whitening")
    wall, host, coll, share, what = collectives_share(
        lambda: et.optimize_whitening(X, flow, nbatches=4, nepochs=1,
                                      mesh=mesh, batch_axis="batch"), 4,
        step_ms, mesh.axis("batch").backend)
    rel = None
    if reference:
        ref = et.optimize_whitening(X, flow, nbatches=MESH_WHITEN["nbatches"],
                                    nepochs=epochs).negll_history.cpu()
        rel = rel_diff(hist, ref)
        check(rel <= SLICE_RTOL, f"{tag} whitening: history {rel:.3e} from "
              f"the unsharded fused run")
    print(f"{tag} whitening: flagship d=2, batch {X.shape[0] // 4} "
          f"({X.shape[0] // 4 // mesh.shape['batch']} a rank), {steps} steps:"
          f" launches a rank {launches}; history {hist[-1].item():.5f} last"
          f"{'' if rel is None else f', max rel diff {rel:.3e} from the unsharded fused run'}"
          f"; ms a step {step_ms:.3f}, profiled {wall:.3f} with {host:.3f}"
          f" host ms in enflows.parallel.* ranges; collectives {coll:.3f} "
          f"ms a step, {100 * share:.1f}% ({what}); params equal on every "
          f"rank [{card}]", flush=True)
    return launches, dict(step_ms=step_ms, profiled_ms=wall,
                          collective_ms=coll)


def mesh_vi_run(et, logp, flow, dim, pairs, seed, device, mesh=None,
                reorder=None, **kw):
    """``optimize_elbo`` for MESH_VI's steps of ``pairs`` antithetic pairs
    from a generator seeded ``seed``; with ``reorder``, the single-process
    fused route with each step's rows in another order."""
    from enflows_tpu_torch.train import vi as VI

    key = torch.Generator(device=device).manual_seed(seed)
    if mesh is not None:
        return et.optimize_elbo(logp, flow, dim=dim, batch_size=pairs,
                                nsteps=MESH_VI["steps"], key=key, mesh=mesh,
                                batch_axis="batch", **kw).nelbo_history.cpu()
    if reorder is None:
        return et.optimize_elbo(logp, flow, dim=dim, batch_size=pairs,
                                nsteps=MESH_VI["steps"], key=key,
                                **kw).nelbo_history.cpu()

    def draws(generator, step, batch_size, d, dtype, dev):
        xi = VI._base_draws(generator, step, batch_size, d, dtype, dev)
        return xi[torch.randperm(batch_size, generator=reorder, device=dev)]
    return VI._fit(logp, flow, kw.get("optimizer"), draws, dim=dim,
                   batch_size=pairs, nsteps=MESH_VI["steps"],
                   antithetic=True, key=key, opt_state=None,
                   nelbo_history=None, dtype=torch.float32,
                   use_fused_coupling=None, stl=False).nelbo_history.cpu()


def mesh_vi(et, EW, C, mesh, device, card, tag, reference):
    """Flow-VI on ``mesh``: the default template at d=50 (B1 + B2 a rank a
    step) and the affine coupling template at d=64 (B4 + B5 a rank a step;
    ``MESH_VI['pairs_coupling']`` pairs, so that each rank's rows keep the
    kernels by the row rule at two ranks). Held to the single-process fused
    run on the same draws: elementwise within ``SLICE_RTOL``, coupling by
    the noise rule (the noise: the single-process route on rows reordered
    within each step). Returns {path: launches}."""
    from enflows_tpu_torch.utils import assert_replicated_consistent

    gen = torch.Generator(device=device).manual_seed(60)
    out = {}
    ranks = mesh.shape["batch"]
    for kind in ("elementwise", "affine"):
        d = 50 if kind == "elementwise" else BASELINE["dim"]
        logp = vi_target(et, d, gen, device)
        if kind == "elementwise":
            flow = et.default_flow_template(d, gen)
            pairs, kw = MESH_VI["pairs_ew"], {}
            want = dict(fwd=MESH_VI["steps"], bwd=MESH_VI["steps"])
        else:
            flow = et.coupling_flow_template(
                BASELINE["n_layers"], BASELINE["hidden"], kind=kind)(d, gen)
            pairs = MESH_VI["pairs_coupling_rank"] * ranks
            kw = dict(optimizer=adam)
            want = dict(coupling_fwd=MESH_VI["steps"],
                        coupling_bwd=MESH_VI["steps"])
        reset_launches(EW.LAUNCHES, C.LAUNCHES)
        hist = mesh_vi_run(et, logp, flow, d, pairs, 61, device, mesh, **kw)
        launches = {k: v for k, v in mesh_counts(EW.LAUNCHES,
                                                  C.LAUNCHES).items() if v}
        check(launches == want, f"{tag} vi {kind}: launches a rank "
              f"{launches}, not {want}")
        check(bool(torch.isfinite(hist).all()) and hist[-1] < hist[0],
              f"{tag} vi {kind}: history {hist.tolist()}")
        assert_replicated_consistent(hist, f"vi {kind}")
        rule = "not held on this rank"
        if reference:
            ref = mesh_vi_run(et, logp, flow, d, pairs, 61, device, **kw)
            if kind == "elementwise":
                rel = rel_diff(hist, ref)
                check(rel <= SLICE_RTOL, f"{tag} vi {kind}: {rel:.3e} from "
                      f"the unsharded fused run")
                rule = f"max rel diff {rel:.3e} (limit {SLICE_RTOL:.0e})"
            else:
                others = [mesh_vi_run(
                    et, logp, flow, d, pairs, 61, device,
                    reorder=torch.Generator(device=device).manual_seed(62),
                    **kw)]
                gate = NoiseGate.of(hist, ref, others)
                gate.check(f"{tag} vi {kind}", ref="the unsharded fused run")
                rule = f"against the unsharded fused run {gate}"
        print(f"{tag} vi {kind}: d={d}, {2 * pairs} rows a step "
              f"({2 * pairs // ranks} a rank), {MESH_VI['steps']} steps: "
              f"launches a rank {launches}; nELBO "
              f"{hist[0].item():.4f} -> {hist[-1].item():.4f}; {rule} "
              f"[{card}]", flush=True)
        out[kind] = launches
    return out


def mesh_smc(et, EW, mesh, device, card, tag, cfg):
    """``smc_sample_sharded`` with the default transport: ``cfg`` 'mixture'
    (the 100-D mixture at 32,768 particles, [smc transport]'s gates) or
    '2d' (bench_smc.py's 2-D transport configuration, held against the
    unsharded run on the same generator: log Z within 0.1, the mean within
    0.05, a ladder within 3 temperatures of it). Exactly T (nsteps + 1) B1
    and T nsteps B2 a rank. Returns the rank's launches."""
    from enflows_tpu_torch.parallel import gather_chains
    from enflows_tpu_torch.smc.flow_transport import default_template

    if cfg == "mixture":
        target, dim, n, nsteps, seed = (smc_mixture, SMC["dim"],
                                        SMC["particles"], SMC["nsteps"], 63)
        kw = dict(mutation_steps=SMC["mutation_steps"],
                  leapfrog_steps=SMC["leapfrog_steps"])
    else:
        target, dim, n, nsteps, seed = (smc_gauss_2d, 2, SMC_2D["particles"],
                                        SMC_2D["nsteps"], 64)
        kw = {}
    reset_launches(EW.LAUNCHES)
    t0 = time.perf_counter()
    parts, lw, logz, infos = et.parallel.smc_sample_sharded(
        target, torch.Generator(device=device).manual_seed(seed), mesh,
        dim=dim, num_particles=n, axis_name="batch",
        transport_template_fn=default_template, transport_steps=nsteps, **kw)
    launches = mesh_counts(EW.LAUNCHES)
    wall = time.perf_counter() - t0
    smc_launch_check(f"{tag} smc {cfg}", launches, len(infos), nsteps)
    parts, lw = gather_chains(parts, mesh, "batch"), gather_chains(
        lw, mesh, "batch")
    if cfg == "mixture":
        err, frac = smc_mixture_gates(f"{tag} smc", parts, lw, logz, infos)
        detail = f"log Z error {err:.4f}, mass with x_0 > 0 {frac:.4f}"
    else:
        true_logz = math.log(2 * math.pi * 0.25)
        _, mean, _ = weighted_moments(parts, lw)
        ref = smc_run(et, target, dim, n, torch.Generator(
            device=device).manual_seed(seed), (EW.LAUNCHES,),
            et.smc.make_transport_fitter(et.std_normal_logpdf_sum, target,
                                         nsteps=nsteps))
        check(abs(float(logz) - true_logz) < 0.1 and float(
            (mean - torch.tensor([3.0, -2.0], device=device,
                                 dtype=torch.float64)).abs().max()) < 0.05,
              f"{tag} smc 2d: log Z {float(logz):.4f}, mean {mean.tolist()}")
        check(abs(len(infos) - len(ref[3])) <= 3,
              f"{tag} smc 2d: {len(infos)} temperatures, unsharded "
              f"{len(ref[3])}")
        detail = (f"log Z {float(logz):.4f} (unsharded {float(ref[2]):.4f},"
                  f" truth {true_logz:.4f}), {len(ref[3])} temperatures "
                  f"unsharded")
    print(f"{tag} smc {cfg}: {n} particles x d={dim} ({n // mesh.shape['batch']}"
          f" a rank), default transport nsteps={nsteps}: {len(infos)} "
          f"temperatures in {wall:.3f} s ({wall * 1e3 / len(infos):.1f} ms a "
          f"temperature); launches a rank {launches}; {detail} [{card}]",
          flush=True)
    return launches


def mesh_resampler(et, mesh, device, card, tag):
    """The resampler's two exchanges on the same weights: the same rows."""
    gen = torch.Generator(device=device).manual_seed(65)
    n, dim = SMC["particles"], SMC["dim"]
    lw = 2.0 * torch.randn(n, generator=gen, device=device)
    parts = torch.randn(n, dim, generator=gen, device=device)
    lo, hi = et.parallel.block_range(n, mesh.axis("batch"))
    rows = {m: et.parallel.sharded_systematic_resample(
        torch.Generator(device=device).manual_seed(66), lw[lo:hi],
        parts[lo:hi], mesh.axis("batch"), m) for m in ("gather", "ring")}
    check(torch.equal(rows["gather"], rows["ring"]),
          f"{tag} resampler: ring and gather rows differ")
    print(f"{tag} resampler: {n} x d={dim}, gather and ring give the same "
          f"{hi - lo} rows a rank [{card}]", flush=True)


def mesh_event(et, EW, mesh, device, card, tag):
    """``event_sharded_forward_and_ladj`` of an elementwise chain at
    MESH_EVENT's shape, the rank's columns through B1, within [B1]'s gate
    of the single-process B1 on all columns."""
    gen = torch.Generator(device=device).manual_seed(67)
    d, n = MESH_EVENT["dim"], MESH_EVENT["n"]
    vec = lambda v: torch.full((d,), v, device=device)
    chain = et.compose(
        et.Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0)),
        et.ScaleShift(torch.linspace(0.5, 2.0, d, device=device), vec(0.0)),
        et.invert(et.CenterStretch(vec(0.5), vec(1.0), vec(0.0))))
    x = torch.randn(n, d, generator=gen, device=device)
    dmesh = et.parallel.make_mesh({"dim": mesh.shape["batch"]},
                                  device=device)
    run = et.parallel.event_sharded_forward_and_ladj(chain, dmesh)
    xl = et.parallel.shard_event_batch(x, dmesh)
    reset_launches(EW.LAUNCHES)
    y, ladj = run(xl)
    launches = mesh_counts(EW.LAUNCHES)
    check(launches == dict(fwd=1, bwd=0, negll=0),
          f"{tag} event: launches {launches}")
    with torch.no_grad():
        y1, l1 = EW.fused_forward_and_ladj(chain, x)
    lo, hi = et.parallel.block_range(d, dmesh.axis("dim"))
    ey, el = max_abs(y, y1[:, lo:hi]), max_abs(ladj, l1)
    check(torch.allclose(y, y1[:, lo:hi], rtol=Y_TOL, atol=Y_TOL) and
          torch.allclose(ladj, l1, rtol=LADJ_TOL, atol=LADJ_TOL),
          f"{tag} event: y {ey:.3e}, ladj {el:.3e} from the single B1")
    print(f"{tag} event-sharded forward: d={d}, n={n}, {hi - lo} columns a "
          f"rank through B1: launches a rank {launches}; max abs diff from "
          f"the single-process B1 y {ey:.3e}, ladj {el:.3e} [{card}]",
          flush=True)
    return launches


def mesh_nuts_infer(et, mesh, device, card, tag):
    """``sample_sharded`` NUTS and ``infer(mesh=)`` on the 2-D example
    target, each against the unsharded call on the same generator."""
    logp = et.FlowDistribution(example_2d_flow(et, device)).requires_grad_(
        False).logpdf
    kw = dict(dim=2, num_chains=MESH_NUTS["chains"],
              num_warmup=MESH_NUTS["warmup"],
              num_samples=MESH_NUTS["samples"])
    g = lambda: torch.Generator(device=device).manual_seed(68)
    d1, _, s1 = et.mcmc.sample(logp, g(), device=device, **kw)
    d2, _, s2 = et.parallel.sample_sharded(logp, g(), mesh,
                                           axis_name="batch", **kw)
    e = max_abs(d1, d2)
    check(e <= 1e-5 and float(s1.step_size) == float(s2.step_size),
          f"{tag} nuts: draws {e:.3e} from the unsharded run")
    r1 = et.infer(logp, key=g(), precondition=None, **kw)
    r2 = et.infer(logp, key=g(), precondition=None, mesh=mesh, **kw)
    ei = max_abs(r1.draws, r2.draws)
    check(ei <= 1e-5 and bool(torch.isfinite(r2.draws).all()),
          f"{tag} infer: draws {ei:.3e} from the unsharded call")
    print(f"{tag} nuts: {kw['num_chains']} chains x "
          f"{kw['num_warmup']} + {kw['num_samples']}, max abs diff from the "
          f"unsharded sample {e:.3e}, step size {float(s2.step_size):.4f}; "
          f"infer(mesh=) draws {ei:.3e} from infer(), rhat "
          f"{r2.diagnostics['rhat'].max():.4f} [{card}]", flush=True)


def mesh_child(phase, rank, world, init, outfile, go):
    """One rank of a mesh phase (``python3 chip_smoke.py --mesh-child``):
    join the group, make the data, warm the path up (a whitening epoch on a
    small batch: the kernels' first launches and the group's first
    collectives), write ``outfile``.ready, wait for the file ``go`` (the
    parent starts every phase's ranks together and lets one phase go at a
    time, so that no other work shares the card with its timings), run the
    phase, write its counts to ``outfile``."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import enflows_tpu_torch as et
    from enflows_tpu_torch import parallel as P
    from enflows_tpu_torch.ops import coupling as C
    from enflows_tpu_torch.ops import elementwise as EW
    from enflows_tpu_torch.ops._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    load_library()
    card = nvidia_smi_line()
    backend = "nccl" if phase == "nccl" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init}",
                            world_size=world, rank=rank)
    tag = f"[mesh {backend} w{world} r{rank}]"
    mesh = P.make_mesh({"batch": world}, device=device)
    ref = rank == 0
    out = {"launches": {}, "times": {}}
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    f_true, _ = example_2d(et, gen, device)
    with torch.no_grad():
        X = f_true(torch.randn(MESH_WHITEN["rows"], 2, generator=gen,
                               device=device))
    flow = flagship_flow(et, 2, gen, device)
    et.optimize_whitening(X[:1 << 14], flow, nbatches=4, nepochs=1,
                          mesh=mesh, batch_axis="batch")
    torch.cuda.synchronize()
    P.COLLECTIVES.clear()
    P.STAGED.clear()
    open(outfile + ".ready", "w").close()
    while not os.path.exists(go):
        time.sleep(0.01)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn):
        t = time.perf_counter()
        result = fn()
        seconds[name] = round(time.perf_counter() - t, 1)
        return result

    epochs = MESH_WHITEN["epochs_w1" if world == 1 else "epochs_w2"]
    out["launches"]["whitening"], out["times"]["whitening"] = timed(
        "whitening", lambda: mesh_whitening(et, EW, mesh, X, flow, epochs,
                                            card, tag, ref))
    vi = timed("vi", lambda: mesh_vi(et, EW, C, mesh, device, card, tag,
                                     ref))
    out["launches"].update({f"vi {k}": v for k, v in vi.items()})
    if phase == "nccl":
        out["launches"]["smc 2d"] = timed("smc", lambda: mesh_smc(
            et, EW, mesh, device, card, tag, "2d"))
        timed("nuts+infer", lambda: mesh_nuts_infer(et, mesh, device, card,
                                                    tag))
    else:
        out["launches"]["smc mixture"] = timed("smc", lambda: mesh_smc(
            et, EW, mesh, device, card, tag, "mixture"))
        timed("resampler", lambda: mesh_resampler(et, mesh, device, card,
                                                  tag))
        out["launches"]["event"] = timed("event", lambda: mesh_event(
            et, EW, mesh, device, card, tag))
    out["collectives"] = dict(P.COLLECTIVES)
    out["staged"] = dict(P.STAGED)
    out["seconds"] = time.perf_counter() - t0
    check(sum(P.COLLECTIVES.values()) > 0, f"{tag}: no collective ran")
    if backend == "nccl":
        check(not P.STAGED, f"{tag}: staged under NCCL {dict(P.STAGED)}")
    print(f"{tag} collectives launched {dict(P.COLLECTIVES)}; staged "
          f"through the host (STAGED) {dict(P.STAGED)}; {out['seconds']:.1f} s"
          f" after the warm-up, by part {seconds} [{card}]", flush=True)
    with open(outfile, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def start_mesh_children(phase, world, root):
    """Start the ``world`` ranks of ``phase`` together; returns (processes,
    their output files, the file that lets them go)."""
    init = os.path.join(root, f"{phase}.init")
    go = os.path.join(root, f"{phase}.go")
    outs = [os.path.join(root, f"{phase}.r{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", phase,
         str(r), str(world), init, outs[r], go],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, outs, go


def wait_mesh_ready(groups, deadline):
    """Wait until every rank of ``groups`` has warmed up (its ``.ready``
    file), or one has exited (``wait_mesh_children`` then reports it)."""
    while time.monotonic() < deadline:
        if all(os.path.exists(o + ".ready") for _, outs, _ in groups
               for o in outs):
            return
        if any(p.poll() is not None for procs, _, _ in groups
               for p in procs):
            return
        time.sleep(0.05)
    check(False, "[mesh] ranks not warmed up by the deadline")


def wait_mesh_children(phase, procs, outs, go, deadline):
    """Let the ranks go and wait for them until ``deadline`` (killing every
    one left then), print their output and fail if any failed. Returns
    each rank's counts."""
    open(go, "w").close()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for log in logs:
        print(log.rstrip(), flush=True)
    codes = [p.returncode for p in procs]
    check(codes == [0] * len(procs), f"[mesh {phase} w{len(procs)}] ranks "
          f"exited {codes}")
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


def mesh_cli(et, device, root, card, deadline):
    """``torchrun --nproc_per_node=1 -m enflows_tpu_torch.cli train`` with a
    mesh (NCCL), held to the same command in this process without one;
    the torchrun child runs while this process runs the reference, and
    the mesh phases' ranks warm up beside both."""
    import contextlib
    import io
    import numpy as np
    from enflows_tpu_torch import cli

    gen = torch.Generator(device=device).manual_seed(69)
    f_true, _ = example_2d(et, gen, device)
    with torch.no_grad():
        X = f_true(torch.randn(MESH_CLI["rows"], 2, generator=gen,
                               device=device))
    data = os.path.join(root, "mesh_cli.npz")
    np.savez(data, X=X.cpu().numpy())
    argv = ["train", "--data", data, "--flow.dim=2",
            f"--flow.stages={json.dumps(CLI_STAGES)}",
            f"--train.nbatches={MESH_CLI['nbatches']}",
            f"--train.nepochs={MESH_CLI['epochs']}"]
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
         "--master_addr=127.0.0.1", f"--master_port={port}", "-m",
         "enflows_tpu_torch.cli", *argv, '--mesh.axes={"batch": 1}'],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, "[mesh cli] unsharded run")
        stdout, stderr = p.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    want = buf.getvalue().strip().splitlines()[-1]
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"[mesh cli] torchrun exited {p.returncode}: "
          f"{stderr[-3000:]}")
    got = stdout.strip().splitlines()[-1]
    check(got == want, f"[mesh cli] torchrun printed {got!r}, unsharded "
          f"{want!r}")
    print(f"[mesh cli] torchrun --nproc_per_node=1 -m enflows_tpu_torch.cli "
          f"train --mesh.axes='{{\"batch\": 1}}' (NCCL): {got} as the "
          f"unsharded command, {wall:.1f} s beside the mesh ranks' warm-up "
          f"[{card}]", flush=True)


def mesh_phases(et, device, card):
    """Every mesh rank started together, and the torchrun CLI run while
    they warm up; then [mesh nccl w1] alone on the card, then [mesh gloo
    w2] alone. Returns each path's launches summed over the ranks, and the
    step times."""
    import tempfile

    paths, times = {}, {}
    t_start = time.perf_counter()
    deadline = time.monotonic() + MESH_TIMEOUT
    with tempfile.TemporaryDirectory() as root:
        nccl = start_mesh_children("nccl", 1, root)
        gloo = start_mesh_children("gloo", 2, root)
        try:
            mesh_cli(et, device, root, card, deadline)
            wait_mesh_ready([nccl, gloo], deadline)
            t0 = time.perf_counter()
            results = {"nccl": wait_mesh_children("nccl", *nccl, deadline)}
            print(f"[time] [mesh nccl w1] {time.perf_counter() - t0:.1f} s "
                  f"after its warm-up [{card}]", flush=True)
            t0 = time.perf_counter()
            results["gloo"] = wait_mesh_children("gloo", *gloo, deadline)
            print(f"[time] [mesh gloo w2] {time.perf_counter() - t0:.1f} s "
                  f"after its warm-up [{card}]", flush=True)
        finally:
            for p in nccl[0] + gloo[0]:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for phase, res in results.items():
        world = len(res)
        for r in res:
            for path, counts in r["launches"].items():
                key = f"mesh {phase} w{world} {path}"
                paths.setdefault(key, {})
                for k, v in counts.items():
                    paths[key][k] = paths[key].get(k, 0) + v
        times[phase] = [r["times"] for r in res]
    check(all(r["collectives"] and not r["staged"] for r in results["nccl"]),
          f"[mesh nccl w1] collectives {results['nccl'][0]['collectives']}")
    print(f"[time] mesh phases {time.perf_counter() - t_start:.1f} s "
          f"[{card}]", flush=True)
    return paths, times

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
    if sys.argv[1:2] == ["--examples"]:
        phase_nuts_graph(et, device, smi)
        examples_at_defaults(sys.argv[2:] or list(EXAMPLES),
                             (TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES), smi)
        print(f"[time] chip_smoke.py --examples "
              f"{time.perf_counter() - t_start:.1f} s [{smi}]", flush=True)
        raise SystemExit(0)

    # The phases that only time (profiles, [householder auto], [hmc
    # timing], [nuts timing], [chees timing], [infer timing]) gate nothing
    # and run only with --timing, so that the default run fits its time.
    timing = "--timing" in sys.argv[1:]
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
    b3_examples = phase_b3_examples(et, EW, device, smi)

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
        if timing:
            profile_whitening_steps(k, m, X, fused_step, smi)
    if timing:
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
        if timing:
            profile_coupling_steps(k, initial_stacks[k], X64, smi)

    # bf16: B1-B3, B6 and B4/B5's bf16 variants against their plain
    # versions, then the slices that run them, on generators of their own.
    bf16_rows = bf16_phases(et, EW, C, TL, X, X64, initial_stacks, device,
                            smi)

    # Flow-VI through B1/B2 and B4/B5, then the 1-D example; B2 at d=50
    # first. Each phase draws from generators of its own.
    from enflows_tpu_torch.train import vi as VI
    b2_d50 = phase_b2(et, EW, 50, 1 << 17,
                      torch.Generator(device=device).manual_seed(16), device,
                      smi)
    vi_ew = phase_vi_elementwise(et, EW, C, VI, device, smi)
    vi_c, vi_tiles = phase_vi_coupling(et, EW, C, VI, device, smi)
    phase_coupling_sweep(et, C, torch.Generator(device=device).manual_seed(33),
                         device, VI_TEMPLATE_SWEEP, "vi template sweep", 64)
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
    hmc_example_launches = example_pushforward_hmc(
        (TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES), smi)
    if timing:
        hmc_t = hmc_timing(TL, target.whiten, res.stats.step_size, gen,
                           device, smi)

    # NUTS and ChEES through sample and infer, no kernel on their path; each
    # run with the launch counters set to 0 just before it and read just
    # after. Each phase draws from generators of its own.
    from enflows_tpu_torch.mcmc import nuts as NU
    counters = (TL.LAUNCHES, EW.LAUNCHES, C.LAUNCHES)
    phase_nuts_graph(et, device, smi)
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
    for alg in ("nuts", "chees") if timing else ():
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
        et, EW, C, counters, device, smi, timing)

    # The example scripts, each module's main() as a user runs it (the
    # one-call example ran with the infer phases, the d=8 HMC example with
    # the HMC slice).
    example_paths = example_phases(counters, smi)

    # The CLI (python -m enflows_tpu_torch.cli): train through B3 killed and
    # resumed, the ELBO and infer commands through B1/B2, sample; then the
    # profiler's kernel ranges and the heartbeat.
    cli_paths, cli_times = cli_phases(et, EW, counters, device, smi)

    # The multi-device layer: a rank a child process, NCCL at one rank,
    # then two ranks sharing the card over gloo; the torchrun CLI.
    mesh_paths, _ = mesh_phases(et, device, smi)
    mesh_times = phase_mesh_shapes(et, EW, C, device, smi)

    def mesh_launches(key):
        return {f"{path} (summed over ranks)": n[key]
                for path, n in mesh_paths.items() if n.get(key)}

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
                      **smc_paths[key], **infer_paths(key),
                      **cli_paths[key], **mesh_launches(key)}
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
    # The kernels' times at the infer phases' and the mesh ranks' shapes.
    for key, vals in (("fwd", b1), ("bwd", b2), ("negll", b3)):
        vals["infer_shapes"] = infer_times[key]
        vals["mesh_shapes"] = mesh_times[key]
    b3["cli_train"] = cli_times
    b3["example_shapes"] = b3_examples
    b3["max_abs_err"] = max(b3["max_abs_err"], *(
        t["max_abs_err"] for t in b3_examples.values()))
    rows = [("B1 fused_forward_and_ladj", ew_paths["fwd"], src,
             f"{pallas}:442", b1),
            ("B2 fused forward backward", ew_paths["bwd"], src,
             f"{pallas}:642", b2),
            ("B3 fused_negll_value_and_grad",
             {"whitening slice (d=2, n=2^20)": launches["negll"],
              **infer_paths("negll"), **cli_paths["negll"],
              **{f"example {k}": n["negll"]
                 for k, n in example_paths.items() if n["negll"]},
              **mesh_launches("negll")}, src,
             f"{pallas}:853", b3)]
    csrc = "enflows_tpu_torch/ops/csrc/coupling.cu"
    cpallas = "enflows_tpu/ops/pallas/coupling.py"
    for k in ("affine", "spline"):
        paths = {key: {f"coupling slice {k} (d=64, n=2^17)":
                       coupling_launches[k][key],
                       **{f"vi coupling {k}{' stl' if stl else ''} template "
                          f"(d=64, n=2^17)": n_l[key]
                          for stl, n_l in vi_c[k].items()},
                       # every infer rung and rescue fits a spline template
                       **(infer_paths(key) if k == "spline" else {}),
                       **(mesh_launches(key) if k == "affine" else {})}
                 for key in ("coupling_fwd", "coupling_bwd")}
        t = vi_tiles[k]
        yard = {b: {f"{key}_vi_template": v[key] for key in
                    ("plain_ms", "library_ms", "bound_ms")}
                for b, v in t["yardsticks"].items()}
        # The affine rows carry the mesh ranks' shapes, the spline rows
        # the infer phases'.
        extra = lambda key: {"mesh_shapes": mesh_times[key]} \
            if k == "affine" else {"infer_hold_max_abs_err": infer_hold_err,
                                   "infer_shapes": infer_times[key]}
        rows += [(f"B4 fused_coupling_forward_and_ladj ({k} BASELINE)",
                  paths["coupling_fwd"], csrc, f"{cpallas}:678",
                  {**b4[k], "ms_vi_template": t["b4_ms_vi_template"],
                   "tile_vi_template": t["tile_vi_template"],
                   **yard["b4"], **extra("coupling_fwd")}),
                 (f"B5 fused coupling backward ({k} BASELINE)",
                  paths["coupling_bwd"], csrc, f"{cpallas}:617",
                  {**b5[k], "ms_vi_template": t["ms_vi_template"],
                   "tile_vi_template": t["tile_vi_template"],
                   **yard["b5"], **extra("coupling_bwd")})]
    rows.append((f"B6 fused_leapfrog (BASELINE {LF['chains']} x {d_lf} x "
                 f"{LF['steps']})",
                 {"hmc slice (8192 x d=50 x L=64)": hmc_launches["leapfrog"],
                  "hmc example (256 x d=8 x L=16)":
                  hmc_example_launches["leapfrog"]},
                 "enflows_tpu_torch/ops/csrc/leapfrog.cu",
                 "enflows_tpu/ops/pallas/leapfrog.py:157", b6))
    rows += bf16_rows
    # "ms" is the variant the main path runs; B4/B5 add the other beside it,
    # and the VI template's tile; B2 its time at d=50, n=2^17.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "ms_without_b5_rows", "ms_recomputing",
            "ms_vi_template", "tile_vi_template", "plain_ms_vi_template",
            "library_ms_vi_template", "bound_ms_vi_template", "ms_d50",
            "plain_ms_d50", "bound_ms_d50", "ms_smc_fit", "plain_ms_smc_fit",
            "bound_ms_smc_fit", "ms_smc_apply", "plain_ms_smc_apply",
            "bound_ms_smc_apply", "infer_hold_max_abs_err", "infer_shapes",
            "cli_train", "example_shapes", "mesh_shapes", "ms_f32_twin",
            "ms_f32_twin_d50", "ms_bf16_storage")
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
    if sys.argv[1:2] == ["--mesh-child"]:
        a = sys.argv[2:]
        mesh_child(a[0], int(a[1]), int(a[2]), a[3], a[4], a[5])
    else:
        main()
