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

__all__ = [
    "Bijector", "Chain", "Identity", "compose", "invert",
    "forward_and_ladj", "sum_ladjs",
    "ScaleShift", "CenterStretch", "CenterContract", "Johnson", "JohnsonInv",
    "Householder", "householder_chain", "householder_chain_dense",
    "householder_matrix",
]
