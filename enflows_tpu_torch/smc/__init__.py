"""Tempered SMC with learned annealing transports.

Counterpart of ``enflows_tpu/smc/``.
"""
from .smc import (
    SMCState, SMCInfo, SMCKernels, smc_sample, systematic_resample, log_ess,
    build_smc_kernels, make_smc_ladder,
    make_compute_next_beta, make_reweight_resample_mutate, make_tempered,
)
from .flow_transport import make_transport_fitter, default_template

__all__ = [
    "SMCState", "SMCInfo", "SMCKernels", "smc_sample",
    "systematic_resample", "log_ess", "build_smc_kernels", "make_smc_ladder",
    "make_compute_next_beta", "make_reweight_resample_mutate",
    "make_tempered",
    "make_transport_fitter", "default_template",
]
