"""MCMC with the chains axis sharded over a mesh.

PyTorch counterpart of ``enflows_tpu/parallel/mcmc_sharded.py``. Each rank
runs its block of the chains through the batch-first kernels of ``mcmc``;
the warmup's consensus (the acceptance mean for dual averaging, the
Welford moments of the mass matrix, ChEES's cross-chain means) is taken by
explicit all-reduces over the chains axis at every transition, so every
rank holds the same step size and mass matrix.

RNG contract: every rank passes the same generator and draws each random
tensor at the global chain count, keeping its block (``mcmc.hmc.Rows``):
chain c follows the trajectory it follows in the single-process
``mcmc.sample``, whatever the mesh. NUTS runs each rank's own lockstep
leaves (a rank whose chains have all stopped does not run the deeper
doublings of another rank's); at the end of each transition one all-reduce
of the doublings drawn lets the others draw the ones they skipped
(``mcmc.nuts._catch_up``). Collectives sit only at transition boundaries,
which every rank reaches equally often.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..mcmc.chees import chees_sample
from ..mcmc.hmc import Rows, hmc_kernel, init_state, initial_positions
from ..mcmc.nuts import nuts_kernel
from ..mcmc.sample import run_chains, window_adaptation
from ..utils.profiling import annotate
from .mesh import Mesh, block_range


def sample_sharded(logdensity_fn: Callable, key: torch.Generator, mesh: Mesh,
                   *, dim: int, num_chains: int = 64,
                   axis_name: str = "chains", algorithm: str = "nuts",
                   implementation: str = "auto", num_warmup: int = 500,
                   num_samples: int = 1000, max_depth: int = 10,
                   num_steps: int = 32, initial_step_size: float = 0.1,
                   target_accept: float = 0.8, dtype=torch.float32,
                   initial_position=None, metrics=None):
    """``mcmc.sample`` with the chains axis sharded over ``mesh``
    (``enflows_tpu/parallel/mcmc_sharded.py:92-148``).

    Every rank passes the same arguments: ``key`` a generator on the rank's
    device seeded the same, ``initial_position`` (optional) the global
    (num_chains, dim) start. ``num_chains`` must divide over the axis.
    Returns this rank's (samples (n_local, num_samples, dim), final states,
    stats): per-chain statistics are the rank's block, ``step_size`` and
    ``inv_mass_diag`` replicated.

    ``implementation`` ("auto", "shard_map" or "spmd") is accepted for
    JAX's signature: JAX lowers its consensus either as explicit
    ``shard_map`` collectives or by sharding propagation; here all three
    take the same explicit-collective path. ``algorithm``: 'nuts', 'hmc' or
    'chees' (its cross-chain means all-reduced). ``metrics`` streams this
    rank's records, as ``mcmc.sample``'s."""
    if implementation not in ("auto", "shard_map", "spmd"):
        raise ValueError(f"unknown implementation {implementation!r}")
    if algorithm not in ("nuts", "hmc", "chees"):
        raise ValueError(f"algorithm must be 'nuts', 'hmc' or 'chees', got "
                         f"{algorithm!r}")
    axis = mesh.axis(axis_name)
    if num_chains % axis.size:
        raise ValueError(f"num_chains {num_chains} must divide over "
                         f"{axis.size} shards")
    lo, hi = block_range(num_chains, axis)
    gen = Rows(key, lo, hi, num_chains)
    device = key.device
    if initial_position is not None:
        q0 = torch.as_tensor(initial_position, dtype=dtype,
                             device=device)[lo:hi]
    else:
        q0 = initial_positions(None, gen, num_chains, dim, dtype, device)
    if algorithm == "chees":
        return chees_sample(logdensity_fn, gen, dim=dim, num_chains=hi - lo,
                            num_warmup=num_warmup, num_samples=num_samples,
                            initial_position=q0,
                            initial_step_size=initial_step_size,
                            dtype=dtype, device=device, axis=axis)
    if algorithm == "nuts":
        kernel = nuts_kernel(logdensity_fn, max_depth=max_depth, axis=axis)
    else:
        kernel = hmc_kernel(logdensity_fn, num_steps=num_steps)
    with annotate("enflows.mcmc.warmup"):
        warm = window_adaptation(kernel, init_state(logdensity_fn, q0), gen,
                                 num_warmup,
                                 initial_step_size=initial_step_size,
                                 target_accept=target_accept,
                                 metrics=metrics, axis=axis)
    with annotate("enflows.mcmc.sampling"):
        return run_chains(kernel, warm.states, gen, num_samples,
                          warm.step_size, warm.inv_mass_diag,
                          metrics=metrics)
