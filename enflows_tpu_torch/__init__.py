"""enflows_tpu_torch: the PyTorch / CUDA port of enflows_tpu.

It holds the whitening main path: the bijector algebra (ScaleShift,
CenterStretch/CenterContract, Johnson/JohnsonInv, Householder,
Chain/compose/invert), the standard-normal base density, the
maximum-likelihood whitening trainer and the fused chain kernels B1-B3
(``ops/csrc/elementwise.cu``); and the coupling-flow training path: affine
and rational-quadratic-spline couplings with MLP conditioners, Permute, the
elementwise spline, and the fused coupling-stack kernels B4/B5
(``ops/csrc/coupling.cu``); and flow-preconditioned HMC: batch-first HMC
with Stan warmup, flow-preconditioned and declared-pushforward targets,
convergence diagnostics, the fused leapfrog kernel B6
(``ops/csrc/leapfrog.cu``) and ``infer``'s HMC routes; and flow-VI:
``optimize_elbo`` with the standard and sticking-the-landing estimators
(through B1/B2 or B4/B5 on the card) and ``infer``'s two transport
templates; and tempered SMC (``smc``): the adaptive-tempering ladder,
systematic resampling, ensemble-preconditioned HMC mutations and learned
annealing transports (fitted and applied through B1/B2 on the card), with
``infer``'s SMC route; and ``infer``'s default path: the
``precondition="auto"`` ladder with its SMC rescue, ``data=`` and
``refine_rounds``. The kernels are written in CUDA C++ for Hopper and
built at first use. The package imports ``torch`` and never ``jax``;
``interop`` carries weights over from the JAX package without importing
it.
"""

from . import bijectors, distributions, mcmc, ops, smc, train
from .bijectors import (
    AffineCoupling, Bijector, Chain, CenterContract, CenterStretch,
    ElementwiseRQSpline, Householder, Identity, Johnson, JohnsonInv,
    MLPConditioner, Permute, RQSplineCoupling, ScaleShift, compose,
    coupling_stack, forward_and_ladj, init_affine_coupling,
    init_elementwise_rq_spline, init_rq_spline_coupling, invert,
    spline_coupling_stack, sum_ladjs,
)
from .distributions import (
    FlowDistribution, std_normal_logpdf, std_normal_logpdf_sum,
)
from .infer import (InferenceResult, coupling_flow_template,
                    default_flow_template, infer, summarize_draws)
from .train import (VIResult, WhiteningResult, mvnormal_negll, neg_elbo,
                    neg_elbo_stl, optimize_elbo, optimize_whitening)

__version__ = "0.1.0"
