"""Hand-written CUDA kernels for Hopper and their wrappers.

`elementwise`: the fused whole-chain forward+ladj (B1), its backward (B2)
and the single-pass whitening loss+grad (B3), with their plain versions.
"""
from .elementwise import (
    LAUNCHES, forward_and_ladj_plain, fused_forward_and_ladj,
    fused_negll_value_and_grad, is_fusible_chain, negll_plain,
    negll_value_and_grad_plain,
)

__all__ = [
    "LAUNCHES", "forward_and_ladj_plain", "fused_forward_and_ladj",
    "fused_negll_value_and_grad", "is_fusible_chain", "negll_plain",
    "negll_value_and_grad_plain",
]
