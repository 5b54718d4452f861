"""A dry run of every sharded path over an initialized world of n ranks.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:60-209``): each
rank runs, at a tiny size and on its device, a data-parallel whitening
train step, one sharded SMC temperature step (and one with a learned
transport), a short sharded ladder, a data-parallel STL-VI step on a
spline coupling transport, the trainers under a mesh (the fused routes
asked for: B3 and B4 + B5 on the card, their plain versions on the CPU)
and sharded NUTS, and checks that each gives finite, replicated results.

    torchrun --nproc_per_node=N -m enflows_tpu_torch.parallel.dryrun [--cpu]
"""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from ..utils.debugging import assert_replicated_consistent
from . import (build_sharded_smc_step, distributed_init,
               make_mesh, sample_sharded, shard_chains, smc_sample_sharded)


def _flagship_flow(dim: int, dtype, device):
    """The flagship elementwise chain at identity-ish parameters."""
    from .. import CenterStretch, Johnson, ScaleShift, compose, invert
    vec = lambda v: torch.full((dim,), v, dtype=dtype, device=device)
    return compose(invert(CenterStretch(vec(0.0), vec(1.0), vec(0.0))),
                   Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0)),
                   ScaleShift(vec(1.0), vec(0.0)))


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the dry run on this rank of an initialized world of
    ``n_devices`` ranks (a world of one needs no group); returns the
    summary line."""
    from .. import spline_coupling_stack, coupling_stack
    from ..distributions import std_normal_logpdf_sum
    from ..smc import SMCState
    from ..smc.flow_transport import default_template
    from ..train import (mvnormal_negll_grad, neg_elbo_stl,
                         optimize_elbo, optimize_whitening)
    from ..train.whitening import averaged, make_train_step
    from ..ops.elementwise import _grads_by_name

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                         f"{world} ranks")
    mesh = make_mesh({"chains": n_devices}, device=device)
    axis = mesh.axis("chains")
    dev = mesh.device
    f32 = torch.float32
    dim = 2
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    # A data-parallel training step: the rank's block of the batch, the
    # loss and gradients averaged, the same update on every rank.
    flow = _flagship_flow(dim, f32, dev)
    opt = torch.optim.Adagrad(list(flow.parameters()), lr=0.1,
                              initial_accumulator_value=0.1)
    X = torch.randn(8 * n_devices, dim, generator=gen(1), device=dev)
    negll = make_train_step(opt, averaged(mvnormal_negll_grad, axis))(
        flow, shard_chains(X, mesh))
    assert bool(torch.isfinite(negll)), "train step produced a non-finite loss"
    assert_replicated_consistent(flow, "dryrun.flow", axis)

    # One sharded SMC temperature step, then one with a learned transport.
    def log_target(q):
        return -0.5 * ((q - 1.0) ** 2).sum(-1)

    step = build_sharded_smc_step(std_normal_logpdf_sum, log_target, mesh,
                                  mutation_steps=1, leapfrog_steps=2)
    n_part = 8 * n_devices
    zero = torch.zeros((), dtype=f32, device=dev)
    state = SMCState(
        particles=shard_chains(torch.randn(n_part, dim, generator=gen(2),
                                           device=dev), mesh),
        log_weights=torch.zeros(8, dtype=f32, device=dev), beta=zero,
        log_z=zero, step_size=torch.full((), 0.2, device=dev))
    state, _ = step(gen(3), state)
    assert float(state.beta) > 0.0, "SMC tempering did not advance"
    assert bool(torch.isfinite(state.log_z))
    tstep = build_sharded_smc_step(std_normal_logpdf_sum, log_target, mesh,
                                   mutation_steps=1, leapfrog_steps=2,
                                   transport_steps=3)
    tstate, _ = tstep(gen(4), state._replace(beta=zero, log_z=zero),
                      default_template(state.particles))
    assert float(tstate.beta) > 0.0 and bool(torch.isfinite(tstate.log_z))
    assert_replicated_consistent([tstate.beta, tstate.log_z,
                                  tstate.step_size], "dryrun.smc", axis)

    # The whole ladder through smc_sample_sharded.
    _, _, lz, infos = smc_sample_sharded(
        log_target, gen(5), mesh, dim=dim, num_particles=8 * n_devices,
        mutation_steps=1, leapfrog_steps=2, max_temps=3)
    assert bool(torch.isfinite(lz)) and len(infos) >= 1

    # A data-parallel STL-VI step on a spline coupling transport.
    sflow = spline_coupling_stack(gen(7), dim, n_layers=2, hidden=(8,),
                                  n_bins=4, device=dev)
    s_opt = torch.optim.Adam(list(sflow.parameters()), lr=1e-3)
    xi = shard_chains(torch.randn(8 * n_devices, dim, generator=gen(8),
                                  device=dev), mesh)

    def stl_value_and_grad(fl, x):
        with torch.enable_grad():
            v = neg_elbo_stl(fl, lambda z: -0.5 * (z * z).sum(-1), x)
            return v.detach(), _grads_by_name(fl, [v])

    s_nelbo = make_train_step(s_opt, averaged(stl_value_and_grad, axis))(
        sflow, xi)
    assert bool(torch.isfinite(s_nelbo)), "spline STL-VI step non-finite"

    # The trainers under a mesh, their fused routes asked for.
    Xw = 1.5 * torch.randn(16 * n_devices, dim, generator=gen(9),
                           device=dev)
    rw = optimize_whitening(Xw, _flagship_flow(dim, f32, dev),
                            nbatches=2, nepochs=1, use_fused=True, mesh=mesh,
                            batch_axis="chains")
    assert bool(torch.isfinite(rw.negll_history).all())
    rv = optimize_elbo(lambda z: -0.5 * (z * z).sum(-1),
                       coupling_stack(gen(10), dim, n_layers=2, hidden=(8,),
                                      device=dev),
                       lambda p: torch.optim.Adam(p, lr=1e-3), dim=dim,
                       batch_size=4 * n_devices, nsteps=2, key=gen(11),
                       use_fused_coupling=True, mesh=mesh,
                       batch_axis="chains")
    assert bool(torch.isfinite(rv.nelbo_history).all())
    assert_replicated_consistent([rw.result, rv.result], "dryrun.trainers",
                                 axis)

    # Sharded NUTS, consensus collectives at every warmup transition.
    draws, _, mstats = sample_sharded(
        log_target, gen(6), mesh, dim=dim, num_chains=2 * n_devices,
        num_warmup=24, num_samples=4, algorithm="nuts", dtype=f32)
    assert tuple(draws.shape) == (2, 4, dim)
    assert bool(torch.isfinite(mstats.step_size))
    assert_replicated_consistent([mstats.step_size, mstats.inv_mass_diag],
                                 "dryrun.nuts", axis)
    return (f"dryrun_multichip({n_devices}): train negll={float(negll):.4f}, "
            f"fused-sharded negll={float(rw.negll_history[-1]):.4f}, "
            f"smc beta={float(state.beta):.4f}, "
            f"transport-smc beta={float(tstate.beta):.4f}, "
            f"ladder temps={len(infos)}, "
            f"spline-stl nelbo={float(s_nelbo):.4f}, "
            f"nuts eps={float(mstats.step_size):.4f} OK")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    distributed_init(backend="gloo" if cpu else None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(dryrun_multichip(world, device="cpu" if cpu else None), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
