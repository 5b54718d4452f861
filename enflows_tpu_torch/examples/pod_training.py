"""Data-parallel, preemption-safe flow training.

Counterpart of ``examples/pod_training.py``: a coupling-stack whitening
fit whose batches are sharded over the ranks of a mesh (each rank steps on
its block, through kernels B4 + B5 on the card where the row rule holds
them, the loss and gradients averaged in one all-reduce, the parameters
replicated), run in checkpointed chunks (``checkpoint_every=``), so that
the same call after a kill resumes from the last chunk; a second call here
finds the final checkpoint and returns the identical flow.

Run, one process a rank (each on ``cuda:{LOCAL_RANK}``, NCCL; with
``--cpu``, gloo on the CPU):

    torchrun --nproc_per_node=N -m enflows_tpu_torch.examples.pod_training [--cpu] [--samples 65536] [--epochs 12]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

import enflows_tpu_torch as et
from enflows_tpu_torch.parallel import distributed_init, make_mesh
from enflows_tpu_torch.train import mvnormal_negll, optimize_whitening


def _shared_tempdir() -> str:
    """A temporary directory made by rank 0, its name sent to every rank."""
    name = [tempfile.mkdtemp() if not dist.is_initialized()
            or dist.get_rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(name, src=0)
    return name[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--samples", type=int, default=1 << 16)
    parser.add_argument("--epochs", type=int, default=12)
    args = parser.parse_args(argv)
    distributed_init(backend="gloo" if args.cpu else None)
    mesh = make_mesh({"batch": dist.get_world_size()
                      if dist.is_initialized() else 1},
                     device="cpu" if args.cpu else None)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    dev, dim = mesh.device, 8
    if rank0:
        print(f"ranks: {mesh.shape['batch']} on {dev}; mesh {mesh.shape}")

    # Correlated, nonlinearly warped training data, the same on every rank.
    gen = torch.Generator(device=dev).manual_seed(0)
    A = 0.3 * torch.randn(dim, dim, generator=gen, device=dev) \
        + torch.eye(dim, device=dev)
    Z = torch.randn(args.samples, dim, generator=gen, device=dev)
    X = torch.tanh(Z @ A.T) * 2.0 + 0.1 * Z
    flow = et.coupling_stack(gen, dim, n_layers=4, hidden=(64, 64),
                             device=dev)
    adam = lambda p: torch.optim.Adam(p, lr=1e-3)

    ckpts = _shared_tempdir()
    try:
        kw = dict(nbatches=8, nepochs=args.epochs, mesh=mesh,
                  batch_axis="batch", checkpoint_every=4, ckpt_dir=ckpts)
        res = optimize_whitening(X, flow, adam, **kw)
        if rank0:
            print(f"trained: negll {float(res.negll_history[0]):.3f} -> "
                  f"{float(res.negll_history[-1]):.3f}")
        # A "preempted" restart: the same call resumes from the last
        # checkpoint (here the final one) instead of retraining.
        res2 = optimize_whitening(X, flow, adam, **kw)
        same = all(torch.equal(a, b) for a, b in zip(
            res.result.state_dict().values(),
            res2.result.state_dict().values()))
        if rank0:
            print(f"resume-from-checkpoint returns the identical flow: "
                  f"{same}")
    finally:
        if dist.is_initialized():
            dist.barrier()
        if rank0:
            shutil.rmtree(ckpts, ignore_errors=True)

    with torch.no_grad():
        Y = res.result(X)
        cov = torch.cov(Y.T.double())
        negll = float(mvnormal_negll(res.result, X))
    off = float((cov - torch.eye(dim, dtype=cov.dtype,
                                 device=dev)).abs().max())
    if rank0:
        print(f"whitened cov deviation from I: {off:.3f}")
    assert off < 0.35, "whitening failed"
    assert same, "resume was not bit-identical"
    if rank0:
        print(f"final full-data negll: {negll:.3f} - OK")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
