"""enflows_tpu_torch: the PyTorch / CUDA port of enflows_tpu.

This slice holds the whitening main path: the bijector algebra
(ScaleShift, CenterStretch/CenterContract, Johnson/JohnsonInv, Householder,
Chain/compose/invert), the standard-normal base density, the
maximum-likelihood whitening trainer and the fused chain kernels B1-B3,
written in CUDA C++ for Hopper (``ops/csrc/elementwise.cu``) and built at
first use. The package imports ``torch`` and never ``jax``; ``interop``
carries weights over from the JAX package without importing it.
"""

from . import bijectors, distributions, ops, train
from .bijectors import (
    Bijector, Chain, CenterContract, CenterStretch, Householder, Identity,
    Johnson, JohnsonInv, ScaleShift, compose, forward_and_ladj, invert,
    sum_ladjs,
)
from .distributions import (
    FlowDistribution, std_normal_logpdf, std_normal_logpdf_sum,
)
from .train import WhiteningResult, mvnormal_negll, optimize_whitening

__version__ = "0.1.0"
