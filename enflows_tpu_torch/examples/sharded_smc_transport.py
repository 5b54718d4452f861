"""Sharded tempered SMC with learned annealing transports.

Counterpart of ``examples/sharded_smc_transport.py``: the particles are
sharded over the ranks of a mesh, the Annealed-Flow-Transport objective is
fitted data-parallel at every temperature (gradients all-reduced, the flow
replicated; on the card through kernels B1 + B2), with AFT-corrected
incremental weights, the distributed systematic resampler and HMC
mutations with cross-rank step-size consensus. The target is a 2-D
bimodal mixture: tempering with transports crosses the density gap, the
mode balance comes out near 50/50 and log Z near its truth, 0.

Run, one process a rank (each on ``cuda:{LOCAL_RANK}``, NCCL; with
``--cpu``, gloo on the CPU):

    torchrun --nproc_per_node=N -m enflows_tpu_torch.examples.sharded_smc_transport [--cpu] [--particles 8192]
"""
from __future__ import annotations

import argparse
import math
import sys

import torch
import torch.distributed as dist

from enflows_tpu_torch.parallel import (distributed_init, gather_chains,
                                        make_mesh, smc_sample_sharded)
from enflows_tpu_torch.smc.flow_transport import default_template
from enflows_tpu_torch.utils import MetricsLogger

DIM, SEP, S2 = 2, 3.0, 0.3


def log_target(q: torch.Tensor) -> torch.Tensor:
    """Equal-weight mixture of N(+SEP e1, S2 I) and N(-SEP e1, S2 I),
    normalized, (n, 2) -> (n,)."""
    shift = torch.tensor([SEP, 0.0], dtype=q.dtype, device=q.device)
    la = -0.5 * ((q - shift) ** 2).sum(-1) / S2
    lb = -0.5 * ((q + shift) ** 2).sum(-1) / S2
    return torch.logaddexp(la, lb) - math.log(2.0) \
        - DIM * 0.5 * math.log(2 * math.pi * S2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--particles", type=int, default=8192)
    parser.add_argument("--transport-steps", type=int, default=50)
    args = parser.parse_args(argv)
    distributed_init(backend="gloo" if args.cpu else None)
    mesh = make_mesh(device="cpu" if args.cpu else None)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if rank0:
        print(f"mesh: {mesh.shape} on {mesh.device}")

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    with MetricsLogger(None) as metrics:
        particles, log_w, log_z, infos = smc_sample_sharded(
            log_target, gen, mesh, dim=DIM, num_particles=args.particles,
            transport_template_fn=default_template,
            transport_steps=args.transport_steps, metrics=metrics)
        if rank0:
            for rec in metrics.history:
                print(f"  t={rec['step']:2d} beta={rec['beta']:.3f} "
                      f"ess={rec['ess']:8.0f} accept={rec['accept']:.2f} "
                      f"logZ={rec['log_z']:+.3f}")

    # The weighted mode balance over every rank's particles.
    w = torch.softmax(gather_chains(log_w, mesh).double(), 0)
    x = gather_chains(particles, mesh)
    right = float(w[x[:, 0] > 0].sum())
    if rank0:
        print(f"temperatures: {len(infos)}")
        print(f"log Z: {float(log_z):+.4f}  (target is normalized: truth 0)")
        print(f"mode balance: {right:.3f} right / {1 - right:.3f} left "
              f"(truth 0.5)")
    assert abs(float(log_z)) < 0.1, "log Z off"
    assert 0.4 < right < 0.6, "mode collapse"
    if rank0:
        print("OK")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
