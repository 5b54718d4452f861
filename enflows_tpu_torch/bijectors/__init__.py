from .base import (
    Bijector, Chain, Identity, compose, invert, forward_and_ladj, sum_ladjs,
)
from .scale_shift import ScaleShift
from .center_stretch import CenterStretch, CenterContract
from .johnson import Johnson, JohnsonInv
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
    "Householder", "householder_chain", "householder_chain_dense",
    "householder_matrix",
    "AffineCoupling", "MLPConditioner", "Permute", "coupling_stack",
    "init_affine_coupling",
    "ElementwiseRQSpline", "RQSplineCoupling", "init_elementwise_rq_spline",
    "init_rq_spline_coupling", "rq_spline", "spline_coupling_stack",
]
