"""The trainers, ``infer``, the run utilities, the CLI and the examples of
the port under a mesh, on the CPU.

2 and 4 gloo ranks (``_torch_ranks``, one thread each, a timeout each),
held in float64 against the JAX package on a mesh of the same size (its
8-device CPU mesh): the sharded whitening and VI histories and fitted
parameters within tests/test_parallel.py:422-505's bounds (histories rtol
2e-5 / atol 2e-6, parameters 2e-4; the optimizers' eps placement, 5e-7 a
step, is inside them), JAX's VI draws handed to the ranks through
``train.vi._base_draws``; the event-sharded forward, negll and gradients
at tests/test_event_sharding.py's bounds. Against the single-process port
on the same generator: ``infer(mesh=)``'s draws and diagnostics. Then the
counterparts of tests/test_multiprocess.py's scenarios: checkpoint shard
files across world sizes, a rank killed and the run resumed bit for bit,
the dry run, the heartbeat detecting a dead peer; the CLI and the two
examples under ``torchrun``'s environment. Every replicated output is
checked bit for bit across the ranks inside the ranks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import enflows_tpu as ef
from enflows_tpu import parallel as JP
from enflows_tpu.train import mvnormal_negll as j_negll
from enflows_tpu.train import optimize_elbo as j_optimize_elbo
from enflows_tpu.train import optimize_whitening as j_optimize_whitening

import enflows_tpu_torch as et
from enflows_tpu_torch import parallel as TP
from enflows_tpu_torch.interop import from_jax
from _torch_ranks import run_module, run_ranks

DT = jnp.float64
WORLDS = [2, 4]
_CKPT_DIRS = {}


def _flagship():
    from __graft_entry__ import _flagship_flow
    return _flagship_flow(2, DT)


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    return np.sinh(0.8 * z) * np.array([1.5, 0.7]) + np.array([0.3, -0.2])


def _jgauss2(z):
    d = z - jnp.asarray([1.5, -1.0], DT)
    return -0.5 * jnp.sum(d * d, axis=-1) / 0.25


def _event_chain(dim):
    return ef.compose(
        ef.Johnson(gamma=jnp.zeros(dim, DT), delta=jnp.full(dim, 5.0, DT),
                   xi=jnp.zeros(dim, DT), lam=jnp.full(dim, 5.0, DT)),
        ef.ScaleShift(a=jnp.linspace(0.5, 2.0, dim, dtype=DT),
                      b=jnp.zeros(dim, DT)),
        ef.invert(ef.CenterStretch(a=jnp.full(dim, 0.5, DT),
                                   b=jnp.ones(dim, DT),
                                   c=jnp.zeros(dim, DT))))


VI_KEY = jax.random.PRNGKey(21)
VI_STEPS, VI_BATCH = 6, 32


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"w{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    root = tmp_path_factory.mktemp(f"train{world}")
    _CKPT_DIRS[world] = str(root / "ckpt")
    other = _CKPT_DIRS.get(2) if world == 4 else None
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(VI_KEY, i),
                                          (VI_BATCH, 2), DT))
             for i in range(VI_STEPS)]
    spec = {"X": _data(), "white_flow": from_jax(_flagship(), device="cpu"),
            "vi_flow": from_jax(_flagship(), device="cpu"),
            "vi_draws": draws, "event_chain": from_jax(_event_chain(8),
                                                       device="cpu"),
            "event_x": np.random.default_rng(2).normal(size=(32, 8)),
            "chains": np.random.default_rng(3).normal(size=(16, 3)),
            "ckpt_dir": _CKPT_DIRS[world], "other_ckpt_dir": other}
    outs = run_ranks("train", world, root, spec, timeout=120)
    return world, spec, outs


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return JP.make_mesh(axes, devices=jax.devices()[:n])


def _params_close(jflow, state, rtol, atol=0.0):
    ref = from_jax(jflow, device="cpu").state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------------
# The trainers under a mesh, against JAX's.

@pytest.mark.parametrize("metrics", [False, True])
def test_whitening_under_a_mesh_matches_jax(ranks, metrics):
    """With ``metrics=``, each rank logs one record a step (not one a
    shard), the history's values."""
    world, spec, outs = ranks
    rj = j_optimize_whitening(jnp.asarray(spec["X"]), _flagship(),
                              optax.adagrad(0.1), nbatches=4, nepochs=2,
                              mesh=_jmesh({"batch": world}))
    for out in outs:
        hist, state, records = out["whitening_metrics" if metrics
                                   else "whitening"]
        np.testing.assert_allclose(hist.numpy(),
                                   np.asarray(rj.negll_history), rtol=2e-5,
                                   atol=2e-6)
        _params_close(rj.result, state, 2e-4)
        if metrics:
            assert [r["step"] for r in records] == list(range(8))
            np.testing.assert_array_equal([r["negll"] for r in records],
                                          hist.numpy())


@pytest.mark.parametrize("stl", [False, True])
def test_vi_under_a_mesh_matches_jax(ranks, stl):
    world, spec, outs = ranks
    rj = j_optimize_elbo(_jgauss2, _flagship(), optax.adagrad(0.1), dim=2,
                         batch_size=VI_BATCH, nsteps=VI_STEPS, key=VI_KEY,
                         dtype=DT, stl=stl, mesh=_jmesh({"batch": world}))
    for out in outs:
        hist, state = out["vi_stl" if stl else "vi"]
        np.testing.assert_allclose(hist.numpy(),
                                   np.asarray(rj.nelbo_history), rtol=2e-5,
                                   atol=2e-6)
        _params_close(rj.result, state, 2e-4)


def test_trainers_refuse_a_batch_that_does_not_divide(ranks):
    mesh = TP.make_mesh({"batch": 1}, device="cpu")
    flow = et.ScaleShift(torch.ones(2), torch.zeros(2))
    X = torch.zeros(8, 2)
    r = et.optimize_whitening(X, flow, nbatches=2, nepochs=1, mesh=mesh)
    assert r.negll_history.shape == (2,)
    with pytest.raises(KeyError, match="no axis"):
        et.optimize_whitening(X, flow, nbatches=2, nepochs=1, mesh=mesh,
                              batch_axis="chains")
    with pytest.raises(ValueError, match="divide"):
        TP.block_range(7, TP.make_mesh(device="cpu").axis("chains")
                       .__class__("b", 2, 0, None, [0, 1]))


# ------------------------------------------------------------------
# Event sharding against JAX's.

def test_event_sharded_forward_matches_jax(ranks):
    world, spec, outs = ranks
    mesh = _jmesh({"dim": world})
    chain = _event_chain(8)
    x = jnp.asarray(spec["event_x"])
    y, ladj = JP.event_sharded_forward_and_ladj(chain, mesh)(
        JP.shard_event_batch(x, mesh))
    cols = 8 // world
    for r, out in enumerate(outs):
        ty, tl = out["event"]
        np.testing.assert_allclose(
            ty.numpy(), np.asarray(y)[:, r * cols:(r + 1) * cols],
            rtol=1e-12)
        np.testing.assert_allclose(tl.numpy(), np.asarray(ladj), rtol=1e-12)


def test_event_sharded_negll_and_grads_match_jax(ranks):
    """The 2-D (batch x dim) mesh: loss and this rank's slice of every
    parameter gradient against JAX's unsharded negll's, as
    tests/test_event_sharding.py:46-73 holds JAX's own."""
    world, spec, outs = ranks
    chain = _event_chain(8)
    x = jnp.asarray(spec["event_x"])
    negll, grads = jax.value_and_grad(j_negll)(chain, x)
    ref = from_jax(jax.tree.map(lambda g: g, grads), device="cpu")
    cols = 8 // (world // 2)
    for r, out in enumerate(outs):
        t_negll, t_grads = out["event_negll"]
        np.testing.assert_allclose(float(t_negll), float(negll), rtol=1e-12)
        j = r % (world // 2)                   # the rank's "dim" coordinate
        for name, g in ref.state_dict().items():
            np.testing.assert_allclose(
                t_grads[name].numpy(), g.numpy()[j * cols:(j + 1) * cols],
                rtol=1e-10, atol=1e-12, err_msg=name)


def test_event_sharding_refuses_mixing_stages():
    mesh = TP.make_mesh({"dim": 1}, axis_name="dim", device="cpu")
    hh = et.Chain.of(et.Householder(torch.randn(2, 8, dtype=torch.float64)))
    with pytest.raises(ValueError, match="mixes event dims"):
        TP.event_sharded_forward_and_ladj(hh, mesh)
    stack = et.coupling_stack(torch.Generator(), 4, n_layers=2, hidden=(4,),
                              device="cpu")
    with pytest.raises(ValueError, match="mixes event dims"):
        TP.local_chain(stack, mesh)


# ------------------------------------------------------------------
# Checkpoints, infer, the dry run.

def test_checkpoint_shard_files_round_trip(ranks):
    """Each rank writes its block to its own file, rank 0 the replicated
    rest; a restore reassembles the rank's rows, also from the files of a
    run on another number of ranks, and in one process all of them."""
    world, spec, outs = ranks
    n_local = 16 // world
    for r, out in enumerate(outs):
        assert out["ckpt_files"] == ["step_3.pt"] + [
            f"step_3.shards.r{i}.pt" for i in range(world)]
        got = out["ckpt"]
        assert got["step"] == 7
        np.testing.assert_array_equal(
            got["chains"].local.numpy(),
            spec["chains"][r * n_local:(r + 1) * n_local])
        for k, v in spec["white_flow"].state_dict().items():
            assert torch.equal(got["flow"][k], v)
        if world == 4:
            np.testing.assert_array_equal(
                out["ckpt_other"]["chains"].local.numpy(),
                spec["chains"][r * n_local:(r + 1) * n_local])
    like = {"flow": spec["white_flow"].state_dict(), "step": 0,
            "chains": et.utils.Shard(torch.zeros(16, 3), 0, 16)}
    whole = et.utils.restore_checkpoint(spec["ckpt_dir"], like, step=3)
    np.testing.assert_array_equal(whole["chains"].local.numpy(),
                                  spec["chains"])
    assert et.utils.latest_step(spec["ckpt_dir"]) == 3


def test_infer_under_a_mesh_follows_the_single_process_call(ranks):
    world, spec, outs = ranks
    for out in outs:
        single, sharded, d1, d2 = out["infer"]
        np.testing.assert_allclose(sharded.numpy(), single.numpy(),
                                   atol=1e-6)
        for k in ("mean", "sd"):
            np.testing.assert_allclose(d2[k], d1[k], atol=1e-6, err_msg=k)
        # Rank-normalized R-hat ranks |x - median|: draws that agree to
        # 1e-13 can swap near-ties there, which moves it by ~1/n.
        np.testing.assert_allclose(d2["rhat"], d1["rhat"], atol=0.02)
        assert d2["precondition_family"] == d1["precondition_family"]
        s1, s2 = out["infer_smc"]
        for k in ("mean", "sd", "log_z", "weight_ess"):
            np.testing.assert_allclose(s2[k], s1[k], rtol=1e-6, err_msg=k)
        assert abs(s2["log_z"] - np.log(2 * np.pi * 0.25)) < 0.15


def test_dryrun_multichip(ranks):
    world, spec, outs = ranks
    for out in outs:
        assert out["dryrun"].startswith(f"dryrun_multichip({world})")
        assert out["dryrun"].endswith("OK")
    assert len({out["dryrun"] for out in outs}) == 1


def test_metrics_files_are_per_rank(ranks):
    """With more than one rank each writes ``{root}.r{rank}{ext}``, as each
    JAX process writes ``{root}.p{i}{ext}``."""
    import json
    world, spec, outs = ranks
    for r, out in enumerate(outs):
        assert out["metrics_path"] == os.path.join(spec["ckpt_dir"],
                                                   f"m.r{r}.jsonl")
        with open(out["metrics_path"]) as f:
            assert json.loads(f.readline())["rank"] == r


# ------------------------------------------------------------------
# tests/test_multiprocess.py's scenarios.

def test_kill_one_rank_and_resume(tmp_path):
    """Rank 1 dies in the third of four checkpointed chunks; the same call
    on fresh ranks resumes from the last chunk and ends bit-identical to
    an uninterrupted run."""
    spec = {"X": _data(), "white_flow": from_jax(_flagship(), device="cpu"),
            "ckpt_dir": str(tmp_path / "ck")}

    def kill_rest(procs, outdir):
        if any(p.poll() is not None for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()

    codes = run_ranks("resume", 2, tmp_path / "crash",
                      {**spec, "phase": "crash"}, expect_ok=False,
                      kill=kill_rest)
    assert codes[1] == 17 and codes[0] != 0, codes
    assert et.utils.latest_step(os.path.join(spec["ckpt_dir"])) == 2
    resumed = run_ranks("resume", 2, tmp_path / "resume",
                        {**spec, "phase": "resume"})
    full = run_ranks("resume", 2, tmp_path / "full",
                     {**spec, "phase": "full",
                      "ckpt_dir": str(tmp_path / "ck_full")})
    for a, b in zip(resumed, full):
        (ha, fa, oa), (hb, fb, ob) = a["run"], b["run"]
        assert torch.equal(ha, hb)
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


def test_heartbeat_detects_a_dead_peer(tmp_path):
    codes = run_ranks("heartbeat", 2, tmp_path,
                      {"timeout": 2.0, "sleep": 5.0, "outdir": str(tmp_path)},
                      expect_ok=False, timeout=60)
    assert codes == [0, 0], codes
    out = torch.load(tmp_path / "out.r0.pt")
    assert out["first"] is True
    assert out["dead"] is False and out["seconds"] < 5.0


def test_cli_trains_under_a_mesh(tmp_path):
    """``torchrun``'s environment, two ranks, the whitening objective on
    the mesh: the final loss and the saved flow are the single-process
    run's (the means of the ranks' means, f32 rounding apart)."""
    from enflows_tpu_torch import cli
    args = ["train", "--cpu", "--flow.dim=1", "--train.nepochs=3",
            "--train.nbatches=10"]
    single = tmp_path / "single"
    rc = cli.main(args + [f"--checkpoint_dir={single}"])
    assert rc == 0
    outs = run_module(["enflows_tpu_torch.cli", *args,
                       '--mesh.axes={"batch": 2}',
                       f"--checkpoint_dir={tmp_path / 'mesh'}"], 2)
    assert all("final loss:" in o for o in outs) and outs[0] == outs[1]
    a = torch.load(single / "step_30.pt")["flow"]
    b = torch.load(tmp_path / "mesh" / "step_30.pt")["flow"]
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("example,args", [
    ("sharded_smc_transport", ["--particles=2048",
                               "--transport-steps=20"]),
    ("pod_training", ["--samples=4096", "--epochs=8"]),
])
def test_examples_run_on_two_ranks(example, args):
    outs = run_module([f"enflows_tpu_torch.examples.{example}", "--cpu",
                       *args], 2, timeout=120)
    assert outs[0].rstrip().endswith("OK"), outs[0]
