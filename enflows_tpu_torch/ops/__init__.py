"""Hand-written CUDA kernels for Hopper and their wrappers.

`elementwise`: the fused whole-chain forward+ladj (B1), its backward (B2)
and the single-pass whitening loss+grad (B3), with their plain versions.
`coupling`: the fused coupling-stack forward+ladj (B4) and its backward (B5),
with the plan, the plain version and the dispatch predicate. `leapfrog`: the
fused leapfrog+logprob kernel (B6), its plain version, predicate and the HMC
transition built on it. Each module keeps its own launch counters,
``LAUNCHES``.
"""
from . import coupling, elementwise, leapfrog
from .coupling import (
    coupling_forward_plain, fused_coupling_forward_and_ladj,
    is_fusible_coupling_stack,
)
from .elementwise import (
    LAUNCHES, forward_and_ladj_plain, fused_forward_and_ladj,
    fused_negll_value_and_grad, is_fusible_chain, negll_plain,
    negll_value_and_grad_plain,
)
from .leapfrog import (
    fused_flow_hmc_step, fused_leapfrog, is_fusible_leapfrog, leapfrog_plain,
)

__all__ = [
    "coupling", "elementwise", "coupling_forward_plain",
    "fused_coupling_forward_and_ladj", "is_fusible_coupling_stack",
    "LAUNCHES", "forward_and_ladj_plain", "fused_forward_and_ladj",
    "fused_negll_value_and_grad", "is_fusible_chain", "negll_plain",
    "negll_value_and_grad_plain", "leapfrog", "fused_flow_hmc_step",
    "fused_leapfrog", "is_fusible_leapfrog", "leapfrog_plain",
]
