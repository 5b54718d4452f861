"""Thin CLI: config-driven train / sample / infer runs on the card.

PyTorch counterpart of ``enflows_tpu/cli.py``:

    python -m enflows_tpu_torch.cli train --config run.toml --train.nepochs=20

parses a TOML/JSON config (``utils.config``) and ``--section.key=value``
overrides, and dispatches. ``--target mod:attr`` (or ``file.py:attr``)
names a per-sample log density, (dim,) -> scalar, written in torch, which
the CLI batches with ``mcmc.per_sample``; ``--data`` an (n, dim) .npz/.npy
array for the whitening objective. Everything runs on the card; ``--cpu``
runs it on the CPU. The printed lines are the JAX CLI's.

``--mesh.axes='{"batch": N}'`` trains the whitening objective data-parallel
over the mesh's first axis, N ranks, one process a rank started by
``torchrun`` (each on ``cuda:{LOCAL_RANK}``, NCCL; with ``--cpu``, gloo);
``sample`` and ``infer`` refuse a mesh:

    torchrun --nproc_per_node=N -m enflows_tpu_torch.cli train \
        --mesh.axes='{"batch": N}' ...
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _optimizer(cfg):
    """The optimizer factory of ``train.optimizer`` at
    ``train.learning_rate``: optax's adagrad (initial accumulator 0.1; torch
    adds its eps outside the square root, see
    ``train.whitening.default_optimizer``), adam or sgd."""
    lr = cfg.train.learning_rate
    return {"adagrad": lambda p: torch.optim.Adagrad(
                p, lr=lr, initial_accumulator_value=0.1),
            "adam": lambda p: torch.optim.Adam(p, lr=lr),
            "sgd": lambda p: torch.optim.SGD(p, lr=lr)}[cfg.train.optimizer]


def _checkpointing(cfg) -> dict:
    """The trainers' preemption-safe keywords: chunks checkpointed under
    ``<checkpoint_dir>/train`` (the final snapshot keeps its own step
    numbering in ``checkpoint_dir``)."""
    if not cfg.train.checkpoint_every:
        return {}
    return dict(checkpoint_every=cfg.train.checkpoint_every,
                ckpt_dir=os.path.join(cfg.checkpoint_dir, "train")
                if cfg.checkpoint_dir else None)


def _demo_data(cfg, gen, dtype, device):
    """The reference 1-D example's ground truth pushed over 10^5 draws."""
    from . import CenterStretch, Johnson, compose

    vec = lambda v: torch.full((cfg.flow.dim,), v, dtype=dtype,
                               device=device)
    truth = compose(CenterStretch(vec(4.0), vec(1.0), vec(0.0)),
                    Johnson(vec(10.0), vec(3.5), vec(10.0), vec(1.0)))
    with torch.no_grad():
        return truth(torch.randn(10**5, cfg.flow.dim, generator=gen,
                                 dtype=dtype, device=device))


def cmd_train(cfg, device, mesh=None):
    from .distributions import std_normal_logpdf_sum
    from .train import optimize_elbo, optimize_whitening
    from .utils import MetricsLogger, build_flow, save_checkpoint
    from .utils.config import load_array

    dtype = getattr(torch, cfg.flow.dtype)
    flow = build_flow(cfg.flow, device)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
    log = MetricsLogger(cfg.metrics_path) if cfg.metrics_path else None
    if cfg.train.objective == "whitening":
        if cfg.data_path:
            X = torch.as_tensor(load_array(cfg.data_path)).to(
                device=device, dtype=dtype)
            if X.dim() != 2 or X.shape[1] != cfg.flow.dim:
                raise ValueError(
                    f"data {cfg.data_path}: shape {tuple(X.shape)} does not "
                    f"match (n, flow.dim={cfg.flow.dim})")
        else:
            X = _demo_data(cfg, gen, dtype, device)
        res = optimize_whitening(X, flow, _optimizer(cfg),
                                 nbatches=cfg.train.nbatches,
                                 nepochs=cfg.train.nepochs, metrics=log,
                                 **_checkpointing(cfg),
                                 **({} if mesh is None else dict(
                                     mesh=mesh,
                                     batch_axis=mesh.axis_names[0])))
        hist = res.negll_history
    else:
        res = optimize_elbo(std_normal_logpdf_sum, flow, _optimizer(cfg),
                            dim=cfg.flow.dim,
                            batch_size=cfg.train.batch_size,
                            nsteps=cfg.train.nsteps,
                            antithetic=cfg.train.antithetic, key=gen,
                            dtype=dtype, stl=cfg.train.stl, metrics=log,
                            **_checkpointing(cfg))
        hist = res.nelbo_history
    if log is not None:
        log.close()
    if cfg.checkpoint_dir:
        save_checkpoint(cfg.checkpoint_dir,
                        {"flow": res.result.state_dict(),
                         "opt_state": res.optimizer_state},
                        step=len(hist))
    print(f"final loss: {float(hist[-50:].mean()):.4f}")
    return 0


def _target(cfg):
    """The batched form of the ``--target`` log density, or None."""
    from .mcmc import per_sample
    from .utils.config import resolve_target

    return per_sample(resolve_target(cfg.target)) if cfg.target else None


def cmd_sample(cfg, device):
    from .mcmc import ess_per_dim, sample, split_rhat_per_dim
    from .smc import smc_sample
    from .utils import MetricsLogger

    dim = cfg.flow.dim
    log = MetricsLogger(cfg.metrics_path) if cfg.metrics_path else None
    logp = _target(cfg) or (lambda q: -0.5 * (q * q).sum(-1))
    gen = torch.Generator(device=device).manual_seed(cfg.sampler.seed)
    if cfg.sampler.algorithm == "smc":
        _, _, logz, infos = smc_sample(
            logp, gen, dim=dim, num_particles=cfg.sampler.num_particles,
            mutation_steps=cfg.sampler.mutation_steps,
            ess_target=cfg.sampler.ess_target, metrics=log)
        print(f"SMC: {len(infos)} temperatures, logZ={float(logz):.4f}")
    else:
        samples, _, stats = sample(
            logp, gen, dim=dim, num_chains=cfg.sampler.num_chains,
            num_warmup=cfg.sampler.num_warmup,
            num_samples=cfg.sampler.num_samples,
            algorithm=cfg.sampler.algorithm,
            max_depth=cfg.sampler.max_depth,
            num_steps=cfg.sampler.num_steps,
            target_accept=cfg.sampler.target_accept,
            metrics=log if cfg.sampler.algorithm != "chees" else None,
            device=device)
        print(f"{cfg.sampler.algorithm}: rhat="
              f"{split_rhat_per_dim(samples).max():.4f} "
              f"ess_min={ess_per_dim(samples).min():.0f} "
              f"accept={float(stats.accept_prob.mean()):.3f}")
    if log is not None:
        log.close()
    return 0


def _demo_target(dim, dtype, device):
    """A warped demo target: the pushforward of N(0, I) through ScaleShift,
    a Householder reflection (dim > 1, its row drawn from a generator seeded
    0) and JohnsonInv."""
    from . import FlowDistribution, Householder, JohnsonInv, ScaleShift
    from . import compose

    vec = lambda v: torch.full((dim,), v, dtype=dtype, device=device)
    stages = [ScaleShift(vec(1.3), vec(2.5))]
    if dim > 1:
        gen = torch.Generator(device=device).manual_seed(0)
        stages.append(Householder(torch.randn(dim, generator=gen, dtype=dtype,
                                              device=device)))
    stages.append(JohnsonInv(vec(0.5), vec(2.0), vec(0.0), vec(1.0)))
    return FlowDistribution(compose(*stages)).requires_grad_(False).logpdf


def cmd_infer(cfg, device):
    """``infer``: fit a transport, sample the preconditioned target and print
    the diagnostics. The target is ``--target``'s, else a warped demo."""
    from . import infer

    dim = cfg.flow.dim
    dt = getattr(torch, cfg.flow.dtype)
    logp = _target(cfg) or _demo_target(dim, dt, device)
    gen = torch.Generator(device=device).manual_seed(cfg.sampler.seed)
    if cfg.sampler.algorithm == "smc":
        res = infer(logp, dim=dim, key=gen, method="smc", precondition=None,
                    num_particles=cfg.sampler.num_particles, dtype=dt)
    else:
        res = infer(logp, dim=dim, key=gen, method=cfg.sampler.algorithm,
                    num_chains=cfg.sampler.num_chains,
                    num_warmup=cfg.sampler.num_warmup,
                    num_samples=cfg.sampler.num_samples,
                    precondition_kind=cfg.sampler.precondition_kind,
                    vi_steps=cfg.train.nsteps, dtype=dt)
    d = res.diagnostics
    if "precondition_family" in d:
        print(f"precondition: family={d['precondition_family']} "
              f"khat={d['precondition_khat']:.2f} "
              f"coverage_gap={d['precondition_coverage_gap']:.2f}")
    if "log_z" in d:
        print(f"smc: logZ={d['log_z']:.4f} "
              f"weight_ess={d['weight_ess']:.0f} "
              f"mean={np.round(d['mean'], 3)}")
    else:
        print(f"{cfg.sampler.algorithm}: rhat={d['rhat'].max():.4f} "
              f"min_bulk_ess={d['min_bulk_ess']:.0f} "
              f"tail_ess={d['tail_ess'].min():.0f} "
              f"divergences={d['divergences']} "
              f"mean={np.round(d['mean'], 3)}")
    return 0


def main(argv=None):
    from .utils import load_config
    from .utils.config import mesh_from_config

    parser = argparse.ArgumentParser(prog="enflows_tpu_torch")
    parser.add_argument("command", choices=["train", "sample", "infer"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--target", default=None, metavar="MOD:ATTR",
                        help="user log-density spec: 'module:attr' or "
                             "'path/to/file.py:attr' ((dim,) -> scalar)")
    parser.add_argument("--data", default=None, metavar="PATH",
                        help="training data .npz/.npy of shape (n, dim) "
                             "for the whitening objective")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    if args.target:
        cfg.target = args.target
    if args.data:
        cfg.data_path = args.data
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("enflows_tpu_torch.cli: no CUDA card "
                         "(torch.cuda.is_available() is False); pass --cpu "
                         "to run on the CPU")
    from .parallel import local_device
    device = local_device(cpu=args.cpu)
    # As in JAX, the mesh reaches the whitening trainer only.
    if args.command == "train":
        return cmd_train(cfg, device, mesh_from_config(cfg, device))
    if cfg.mesh.axes:
        raise SystemExit(f"enflows_tpu_torch.cli: --mesh.axes shards the "
                         f"train command only; {args.command} runs in one "
                         f"process")
    return {"sample": cmd_sample, "infer": cmd_infer}[args.command](
        cfg, device)


if __name__ == "__main__":
    sys.exit(main())
