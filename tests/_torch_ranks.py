"""Ranks of the port's multi-device tests: gloo processes on the CPU.

The launcher ``run_ranks(task, world, outdir, spec)`` saves ``spec`` (a
dict of numpy arrays and numbers) to ``outdir``, starts ``world``
processes of this file, each joining one gloo group through a ``file://``
init in ``outdir`` with one thread, waits for them under a timeout of its
own, and returns each rank's outputs (``outdir/out.r{rank}.pt``, a dict).
A rank runs ``TASKS[task](spec, rank, world, out)``; it imports neither JAX
nor the JAX package: the tests compute JAX's side in their own process and
hand its draws over in ``spec``.

    python tests/_torch_ranks.py <task> <outdir> <world> <rank>
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(task: str, world: int, outdir, spec=None, timeout=120,
              expect_ok=True, kill=None):
    """Run ``task`` on ``world`` ranks; returns [outputs of rank r]. With
    ``expect_ok`` False, returns the exit codes instead. ``kill``: a
    callable (procs, outdir) polled while the ranks run, which may kill
    some of them (fault injection)."""
    import torch
    outdir = str(outdir)
    os.makedirs(outdir, exist_ok=True)
    torch.save(spec or {}, os.path.join(outdir, "spec.pt"))
    init = os.path.join(outdir, "init")
    if os.path.exists(init):
        os.remove(init)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, outdir,
         str(world), str(r)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if kill is not None:
                kill(procs, outdir)
            if time.monotonic() > deadline:
                raise AssertionError(f"{task}: ranks timed out after "
                                     f"{timeout} s\n" + _errors(procs))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if not expect_ok:
        return codes
    if any(codes):
        raise AssertionError(f"{task}: ranks exited {codes}\n"
                             + _errors(procs))
    return [torch.load(os.path.join(outdir, f"out.r{r}.pt"),
                       weights_only=False) for r in range(world)]


def _errors(procs) -> str:
    return "\n".join(f"--- rank {r} ---\n"
                     + p.stderr.read().decode(errors="replace")[-3000:]
                     for r, p in enumerate(procs) if p.stderr)


# ------------------------------------------------------------------
# The ranks' side.

def _t(a):
    import numpy as np
    import torch
    return torch.from_numpy(np.array(a))


class _Draws:
    """The SMC draw hooks fed with given draws: ``_resample_uniform``
    takes the next uniform, ``_mutation_draws`` the next (noise, u), both
    at the global particle count, each rank keeping its block."""

    ORIGINAL = None

    def __init__(self, u0s, noises, us):
        from enflows_tpu_torch.smc import smc as TS
        if _Draws.ORIGINAL is None:
            _Draws.ORIGINAL = (TS._resample_uniform, TS._mutation_draws)
        self.u0s, self.mut = list(u0s), list(zip(noises, us))
        TS._resample_uniform = self.uniform
        TS._mutation_draws = self.mutation

    @staticmethod
    def restore():
        from enflows_tpu_torch.smc import smc as TS
        TS._resample_uniform, TS._mutation_draws = _Draws.ORIGINAL

    def uniform(self, generator, dtype, device):
        import torch
        return torch.tensor(self.u0s.pop(0), dtype=dtype, device=device)

    def mutation(self, generator, q):
        noise, u = self.mut.pop(0)
        return (_t(noise)[generator.start:generator.stop],
                _t(u)[generator.start:generator.stop])


def _smc_state(x, lw, beta, log_z, step_size, lo, hi):
    import torch
    from enflows_tpu_torch.smc import SMCState
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    return SMCState(_t(x)[lo:hi], _t(lw)[lo:hi], f(beta), f(log_z),
                    f(step_size))


def task_basics(spec, rank, world, out):
    """Collectives, meshes, the resampler, the replication check, sharded
    SMC steps and ladders given JAX's draws, and the sharded samplers
    against the single-process port on the same generator."""
    import numpy as np
    import torch
    import enflows_tpu_torch as et
    from enflows_tpu_torch import parallel as P
    from enflows_tpu_torch.smc import smc as TS
    from enflows_tpu_torch.smc.flow_transport import (default_template,
                                                      make_transport_fitter)
    from enflows_tpu_torch.utils import assert_replicated_consistent

    mesh = P.make_mesh({"chains": world})
    ax = mesh.axis("chains")
    x = _t(spec["x"][rank])
    out["psum"], out["pmean"], out["pmax"] = (P.psum(x, ax),
                                              P.pmean(x, ax), P.pmax(x, ax))
    out["all_gather"] = P.all_gather(x, ax)
    out["all_gather_untiled"] = P.all_gather(x[None], ax, tiled=False)
    out["psum_scatter"] = P.psum_scatter(_t(spec["y"][rank]), ax)
    out["broadcast"] = P.broadcast_from_zero(x, ax)
    out["ring"] = P.ring_shift(x, ax)
    out["axis_index"] = P.axis_index(ax)
    two = P.make_mesh({"hosts": 2, "chains": world // 2})
    out["two_shape"] = two.shape
    out["two_psum"] = P.psum(x, two.axis("chains"))
    try:
        P.make_mesh({"chains": world + 1})
        out["bad_mesh_raises"] = False
    except ValueError:
        out["bad_mesh_raises"] = True
    assert_replicated_consistent(out["psum"], "psum")
    try:
        assert_replicated_consistent(x, "x")
        out["diverging_caught"] = False
    except AssertionError:
        out["diverging_caught"] = True

    # The resampler, both exchanges, given JAX's uniform.
    n = spec["lw"].shape[0]
    lo, hi = P.block_range(n, ax)
    res = {}
    for method in ("gather", "ring"):
        _Draws([spec["u0"]], [], [])
        res[method] = P.sharded_systematic_resample(
            None, _t(spec["lw"])[lo:hi], _t(spec["parts"])[lo:hi], ax,
            method)
    out["resample"] = res

    # Sharded SMC steps given JAX's draws.
    out["steps"] = []
    for case in spec["steps"]:
        n = case["x"].shape[0]
        lo, hi = P.block_range(n, ax)
        _Draws([case["u0"]], case["noise"], case["u"])
        step = P.build_sharded_smc_step(
            et.std_normal_logpdf_sum, _TARGETS[case["target"]], mesh,
            mutation_steps=len(case["noise"]), leapfrog_steps=case["L"],
            resample_threshold=case["threshold"],
            transport_steps=case["transport_steps"])
        state = _smc_state(case["x"], case["lw"], case["beta"], 0.1, 0.3,
                           lo, hi)
        args = (default_template(state.particles),) \
            if case["transport_steps"] else ()
        new, info = step(None, state, *args)
        out["steps"].append((new, info))

    # Short ladders given JAX's draws (JAX's start as the base sampler).
    out["ladders"] = []
    for case in spec["ladders"]:
        n = case["x0"].shape[0]
        _Draws(case["u0s"], case["noise"], case["u"])
        kw = dict(transport_template_fn=default_template,
                  transport_steps=case["transport_steps"]) \
            if case["transport_steps"] else {}
        parts, lw, lz, infos = P.smc_sample_sharded(
            _TARGETS[case["target"]], torch.Generator(), mesh, dim=2,
            num_particles=n, log_base=et.std_normal_logpdf_sum,
            base_sampler=lambda g, n, x0=case["x0"]: _t(x0),
            mutation_steps=case["mutation_steps"], dtype=torch.float64,
            **kw)
        out["ladders"].append((parts, lw, lz, [i.beta for i in infos]))
    _Draws.restore()

    # The same generator: the sharded ladders and samplers against the
    # single-process port.
    gauss = _TARGETS["gauss2"]
    kw = dict(dim=2, num_particles=512, dtype=torch.float64)
    n_local = 512 // world
    cmp = {}
    for transport in (False, True):
        fit = make_transport_fitter(et.std_normal_logpdf_sum, gauss,
                                    nsteps=30) if transport else None
        p1, lw1, lz1, i1 = TS.smc_sample(gauss, torch.Generator()
                                         .manual_seed(4),
                                         fit_transport=fit, **kw)
        tkw = dict(transport_template_fn=default_template,
                   transport_steps=30) if transport else {}
        p2, lw2, lz2, i2 = P.smc_sample_sharded(
            gauss, torch.Generator().manual_seed(4), mesh, **kw, **tkw)
        lo = rank * n_local
        cmp[transport] = dict(
            betas=(np.array([float(i.beta) for i in i1]),
                   np.array([float(i.beta) for i in i2])),
            log_z=(float(lz1), float(lz2)),
            parts=(p1[lo:lo + n_local].numpy(), p2.numpy()),
            lw=(lw1[lo:lo + n_local].numpy(), lw2.numpy()),
            replicated=[lz2, i2[-1].beta, i2[-1].log_z])
        assert_replicated_consistent(cmp[transport]["replicated"],
                                     "smc ladder")
    out["smc_vs_port"] = cmp

    def logp(q):
        return -0.5 * ((q - torch.tensor([0.5, -0.5], dtype=q.dtype))
                       ** 2).sum(-1)

    mc = {}
    for alg, warm in (("nuts", 60), ("hmc", 5)):
        kw = dict(dim=2, num_chains=16, num_warmup=warm, num_samples=20,
                  dtype=torch.float64, algorithm=alg)
        d1, _, s1 = et.mcmc.sample(logp, torch.Generator().manual_seed(7),
                                   device="cpu", **kw)
        d2, _, s2 = P.sample_sharded(logp, torch.Generator().manual_seed(7),
                                     mesh, implementation="shard_map", **kw)
        k = 16 // world
        mc[alg] = dict(draws=(d1[rank * k:(rank + 1) * k].numpy(),
                              d2.numpy()),
                       step=(float(s1.step_size), float(s2.step_size)),
                       inv_mass=(s1.inv_mass_diag.numpy(),
                                 s2.inv_mass_diag.numpy()))
        assert_replicated_consistent([s2.step_size, s2.inv_mass_diag],
                                     f"{alg} adaptation")
    cov = torch.tensor([[2.0, 1.2], [1.2, 1.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)
    d3, _, s3 = P.sample_sharded(
        lambda q: -0.5 * ((q @ prec) * q).sum(-1),
        torch.Generator().manual_seed(5), mesh, dim=2, num_chains=64,
        num_warmup=300, num_samples=300, dtype=torch.float64,
        algorithm="chees")
    assert_replicated_consistent([s3.step_size, s3.trajectory_length,
                                  s3.inv_mass_diag], "chees adaptation")
    mc["chees"] = dict(draws=P.gather_chains(d3, mesh).numpy(),
                       step=float(s3.step_size),
                       traj=float(s3.trajectory_length))
    out["mcmc"] = mc


def _gauss2(q):
    import torch
    d = q - torch.tensor([1.5, -1.0], dtype=q.dtype)
    return -0.5 * (d * d).sum(-1) / 0.25


def _mix2(q):
    import math
    import torch
    a = -0.5 * ((q - 1.5) ** 2).sum(-1) + math.log(0.3)
    b = -0.5 * ((q + 1.0) ** 2 / 0.5).sum(-1) + math.log(0.7)
    return torch.logaddexp(a, b)


_TARGETS = {"gauss2": _gauss2, "mix2": _mix2}


def task_train(spec, rank, world, out):
    """The trainers under a mesh (JAX's VI draws injected), event
    sharding, checkpoint shard files, ``infer(mesh=)`` against the
    single-process call and the dry run."""
    import torch
    import enflows_tpu_torch as et
    from enflows_tpu_torch import parallel as P
    from enflows_tpu_torch.parallel.dryrun import dryrun_multichip
    from enflows_tpu_torch.train import vi as VI
    from enflows_tpu_torch.utils import (Shard, assert_replicated_consistent,
                                         restore_checkpoint, save_checkpoint)

    mesh = P.make_mesh({"batch": world}, device="cpu")
    base_draws = VI._base_draws
    for stl in (False, True):
        log = et.utils.MetricsLogger(None) if stl else None
        r = et.optimize_whitening(_t(spec["X"]), spec["white_flow"],
                                  nbatches=4, nepochs=2, mesh=mesh,
                                  metrics=log)
        assert_replicated_consistent([r.result, r.optimizer_state,
                                      r.negll_history], "whitening")
        out[f"whitening{'_metrics' if stl else ''}"] = (
            r.negll_history, r.result.state_dict(),
            log.history if log else None)
        draws = spec["vi_draws"]
        VI._base_draws = lambda g, i, b, d, dtype, device: _t(draws[i])
        v = et.optimize_elbo(_gauss2, spec["vi_flow"], dim=2,
                             batch_size=draws[0].shape[0],
                             nsteps=len(draws), key=torch.Generator(),
                             dtype=torch.float64, stl=stl, mesh=mesh)
        assert_replicated_consistent([v.result, v.optimizer_state,
                                      v.nelbo_history], "vi")
        out[f"vi{'_stl' if stl else ''}"] = (v.nelbo_history,
                                            v.result.state_dict())
    VI._base_draws = base_draws

    # Event sharding: the forward over "dim", the negll on a 2-D mesh.
    dmesh = P.make_mesh({"dim": world}, device="cpu")
    chain, x = spec["event_chain"], _t(spec["event_x"])
    run = P.event_sharded_forward_and_ladj(chain, dmesh)
    out["event"] = run(P.shard_event_batch(x, dmesh))
    mesh2 = P.make_mesh({"batch": 2, "dim": world // 2}, device="cpu")
    fn = P.event_sharded_negll_fn(mesh2)
    out["event_negll"] = fn(P.local_chain(chain, mesh2),
                            P.shard_event_batch(x, mesh2,
                                                batch_axis="batch"))

    # Checkpoint shard files, and a restore of another world's files.
    ax = mesh.axis("batch")
    chains = _t(spec["chains"])
    lo, hi = P.block_range(chains.shape[0], ax)
    state = {"flow": spec["white_flow"].state_dict(), "step": 7,
             "chains": Shard(chains[lo:hi], lo, chains.shape[0])}
    like = {"flow": spec["white_flow"].state_dict(), "step": 0,
            "chains": Shard(torch.zeros(hi - lo, 3), lo, chains.shape[0])}
    save_checkpoint(spec["ckpt_dir"], state, step=3)
    out["ckpt_files"] = sorted(os.listdir(spec["ckpt_dir"]))
    out["ckpt"] = restore_checkpoint(spec["ckpt_dir"], like, step=3)
    if spec.get("other_ckpt_dir"):
        out["ckpt_other"] = restore_checkpoint(spec["other_ckpt_dir"], like,
                                               step=3)

    # infer(mesh=) against the single-process call on the same generator.
    cmesh = P.make_mesh({"chains": world}, device="cpu")
    kw = dict(dim=2, num_chains=8, num_warmup=40, num_samples=20,
              precondition_kind="elementwise", vi_steps=20, vi_batch=32,
              dtype=torch.float64, device="cpu")
    res = {}
    for m in (None, cmesh):
        res[m is None] = et.infer(_gauss2, key=torch.Generator()
                                  .manual_seed(3), mesh=m, **kw)
    k = 8 // world
    out["infer"] = (res[True].draws[rank * k:(rank + 1) * k],
                    res[False].draws, res[True].diagnostics,
                    res[False].diagnostics)
    smc = {}
    for m in (None, cmesh):
        smc[m is None] = et.infer(_gauss2, key=torch.Generator()
                                  .manual_seed(4), dim=2, method="smc",
                                  precondition=None, num_particles=512,
                                  mesh=m, dtype=torch.float64, device="cpu")
    out["infer_smc"] = (smc[True].diagnostics, smc[False].diagnostics)
    out["dryrun"] = dryrun_multichip(world, device="cpu")
    with et.utils.MetricsLogger(os.path.join(spec["ckpt_dir"],
                                             "m.jsonl")) as log:
        log.log(0, rank=rank)
        out["metrics_path"] = log.path


class _CrashAt:
    """A metrics sink whose rank ``rank`` exits the process at ``step``: a
    preemption in the middle of a run."""

    def __init__(self, rank, step):
        self.rank, self.step = rank, step

    def log(self, step, **metrics):
        import torch.distributed as dist
        if dist.get_rank() == self.rank and step == self.step:
            os._exit(17)


def task_resume(spec, rank, world, out):
    """Data-parallel whitening in checkpointed chunks; phase "crash": rank
    1 dies in the third chunk; phase "resume" and "full": the run to its
    end (resuming from the checkpoints, or from nothing)."""
    import enflows_tpu_torch as et
    from enflows_tpu_torch import parallel as P

    mesh = P.make_mesh({"batch": world}, device="cpu")
    metrics = _CrashAt(1, 9) if spec["phase"] == "crash" else None
    r = et.optimize_whitening(_t(spec["X"]), spec["white_flow"], nbatches=4,
                              nepochs=4, mesh=mesh, metrics=metrics,
                              checkpoint_every=1, ckpt_dir=spec["ckpt_dir"])
    out["run"] = (r.negll_history, r.result.state_dict(),
                  r.optimizer_state)


def task_heartbeat(spec, rank, world, out):
    """Both ranks probe once; then rank 1 stops taking part (a dead peer)
    and rank 0's heartbeat must report False at its deadline."""
    import time
    import torch
    from enflows_tpu_torch.utils import heartbeat

    out["first"] = heartbeat(30.0, device="cpu")
    if rank == 1:
        time.sleep(spec["sleep"])
        os._exit(0)
    t0 = time.monotonic()
    out["dead"] = heartbeat(spec["timeout"], device="cpu")
    out["seconds"] = time.monotonic() - t0
    torch.save(out, os.path.join(spec["outdir"], f"out.r{rank}.pt"))
    os._exit(0)


TASKS = {"basics": task_basics, "train": task_train, "resume": task_resume,
         "heartbeat": task_heartbeat}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_module(argv, world, timeout=120, cwd=ROOT):
    """``python -m argv...`` on ``world`` ranks with the environment
    ``torchrun`` gives them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT on 127.0.0.1); returns each rank's standard output."""
    env = _env()
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=cwd,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode:
                raise AssertionError(f"{argv}: exit {p.returncode}\n"
                                     f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def main(argv) -> int:
    task, outdir, world, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "init"),
        world_size=world, rank=rank)
    spec = torch.load(os.path.join(outdir, "spec.pt"), weights_only=False)
    out: dict = {}
    TASKS[task](spec, rank, world, out)
    torch.save(out, os.path.join(outdir, f"out.r{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main(sys.argv[1:]))
