"""MCMC: batch-first HMC, multinomial NUTS and ChEES-HMC with Stan warmup,
flow-preconditioned targets, the fused-leapfrog sampler (kernel B6) and
convergence diagnostics.

Counterpart of ``enflows_tpu/mcmc/``.
"""
from .hmc import (HMCInfo, HMCState, hmc_kernel, hmc_transition, init_state,
                  kinetic_energy, leapfrog, sample_momentum, value_and_grad)
from .nuts import NUTSInfo, nuts_kernel, nuts_transition
from .chees import (ChEESSampleStats, ChEESWarmupResult, chees_sample,
                    chees_warmup, hmc_proposal_kernel, run_chains_chees)
from .logdensity import (FlowPushforwardTarget, PreconditionedTarget,
                         flow_preconditioned, per_sample)
from .sample import (SampleStats, WarmupResult, run_chains, sample,
                     window_adaptation)
from .adaptation import (
    DualAveragingState, WelfordState, build_schedule, da_init, da_update,
    welford_init, welford_update, welford_update_batch, welford_variance,
)
from .fused_hmc import FusedHMCStats, fused_flow_hmc_sample
from .diagnostics import (
    bfmi, bulk_ess, ess, ess_per_dim, pareto_khat, rank_normalized_rhat,
    rank_normalized_rhat_per_dim, split_rhat, split_rhat_per_dim, tail_ess,
)

__all__ = [
    "HMCInfo", "HMCState", "hmc_kernel", "hmc_transition", "init_state",
    "kinetic_energy", "leapfrog", "sample_momentum", "value_and_grad",
    "NUTSInfo", "nuts_kernel", "nuts_transition",
    "ChEESSampleStats", "ChEESWarmupResult", "chees_sample", "chees_warmup",
    "hmc_proposal_kernel", "run_chains_chees",
    "FlowPushforwardTarget", "PreconditionedTarget", "flow_preconditioned",
    "per_sample",
    "SampleStats", "WarmupResult", "run_chains", "sample",
    "window_adaptation",
    "DualAveragingState", "WelfordState", "build_schedule", "da_init",
    "da_update", "welford_init", "welford_update", "welford_update_batch",
    "welford_variance",
    "FusedHMCStats", "fused_flow_hmc_sample",
    "bfmi", "bulk_ess", "ess", "ess_per_dim", "pareto_khat",
    "rank_normalized_rhat", "rank_normalized_rhat_per_dim", "split_rhat",
    "split_rhat_per_dim", "tail_ess",
]
