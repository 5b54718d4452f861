from .vi import VIResult, neg_elbo, neg_elbo_stl, optimize_elbo
from .whitening import (
    WhiteningResult, default_optimizer, make_train_step, mvnormal_negll,
    mvnormal_negll_coupling, mvnormal_negll_fused, mvnormal_negll_grad,
    optimize_whitening,
)

__all__ = [
    "VIResult", "WhiteningResult", "default_optimizer", "make_train_step",
    "mvnormal_negll", "mvnormal_negll_coupling", "mvnormal_negll_fused",
    "mvnormal_negll_grad", "neg_elbo", "neg_elbo_stl", "optimize_elbo",
    "optimize_whitening",
]
