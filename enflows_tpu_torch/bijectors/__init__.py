from .base import (
    Bijector, Chain, Identity, compose, invert, forward_and_ladj, sum_ladjs,
)
from .scale_shift import ScaleShift
from .center_stretch import CenterStretch, CenterContract
from .johnson import (
    Johnson, JohnsonInv, johnson_deriv, johnson_inv_deriv, johnson_inv_ladj,
    johnson_ladj,
)
from .householder import (
    Householder, householder_chain, householder_chain_dense,
    householder_matrix,
)
from .coupling import (
    AffineCoupling, MLPConditioner, Permute, coupling_stack,
    init_affine_coupling,
)
from .spline import (
    ElementwiseRQSpline, RQSplineCoupling, init_elementwise_rq_spline,
    init_rq_spline_coupling, rq_spline, spline_coupling_stack,
)

__all__ = [
    "Bijector", "Chain", "Identity", "compose", "invert",
    "forward_and_ladj", "sum_ladjs",
    "ScaleShift", "CenterStretch", "CenterContract", "Johnson", "JohnsonInv",
    "johnson_ladj", "johnson_inv_ladj", "johnson_deriv", "johnson_inv_deriv",
    "Householder", "householder_chain", "householder_chain_dense",
    "householder_matrix",
    "AffineCoupling", "MLPConditioner", "Permute", "coupling_stack",
    "init_affine_coupling",
    "ElementwiseRQSpline", "RQSplineCoupling", "init_elementwise_rq_spline",
    "init_rq_spline_coupling", "rq_spline", "spline_coupling_stack",
]
