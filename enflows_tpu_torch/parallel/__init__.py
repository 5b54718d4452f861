"""Multi-device layer: process groups and meshes, named collectives, the
distributed resampler, sharded SMC (with data-parallel learned
transports), sharded NUTS/HMC/ChEES and event-dimension sharding.

Counterpart of ``enflows_tpu/parallel/``, one process per rank over
``torch.distributed``: NCCL where the ranks' tensors lie on cards, gloo on
the CPU (or with CUDA tensors where asked, ops gloo cannot run on the
device staged through the host and counted in ``STAGED``). The trainers,
``infer`` and the CLI take a mesh from here (``mesh=``).
"""
from .mesh import (Axis, Mesh, block_range, distributed_init, gather_chains,
                   local_device, make_mesh, shard_chains)
from .collectives import (COLLECTIVES, STAGED, all_gather, axis_index,
                          broadcast_from_zero, pmax, pmean, psum,
                          psum_flat, psum_scatter, ring_shift)
from .resample import sharded_systematic_resample
from .smc_sharded import (build_sharded_smc_step, make_sharded_smc_ladder,
                          make_sharded_smc_step, smc_sample_sharded)
from .mcmc_sharded import sample_sharded
from .event_sharded import (event_sharded_forward_and_ladj,
                            event_sharded_negll_fn, local_chain,
                            shard_event_batch)

__all__ = [
    "Axis", "Mesh", "block_range", "distributed_init", "gather_chains",
    "local_device", "make_mesh", "shard_chains",
    "COLLECTIVES", "STAGED", "all_gather", "axis_index",
    "broadcast_from_zero", "pmax", "pmean", "psum", "psum_flat",
    "psum_scatter", "ring_shift",
    "sharded_systematic_resample",
    "build_sharded_smc_step", "make_sharded_smc_ladder",
    "make_sharded_smc_step", "smc_sample_sharded", "sample_sharded",
    "event_sharded_forward_and_ladj", "event_sharded_negll_fn",
    "local_chain", "shard_event_batch",
]
