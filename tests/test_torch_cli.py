"""``python -m enflows_tpu_torch.cli`` against ``python -m enflows_tpu.cli``
(tests/test_utils.py:179-290, :445-470), on the CPU (``--cpu``).

Each command's printed line is read in the JAX CLI's format. Where the run
is deterministic (whitening on given data, an SMC run whose target is the
base up to a constant) its numbers are held to JAX's; elsewhere (the
samplers' and VI's draws come from other generators) to the same
statistical gates.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from enflows_tpu import cli as jax_cli
import enflows_tpu_torch as et
from enflows_tpu_torch import cli
from enflows_tpu_torch import utils as TU

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"(-?\d+\.\d+)"


def _run(capsys, main, argv):
    """(return code, printed lines) of one CLI call."""
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


def _both(capsys, argv):
    """The port's lines (with ``--cpu``) and JAX's, for the same flags."""
    rc_t, out_t = _run(capsys, cli.main, argv + ["--cpu"])
    rc_j, out_j = _run(capsys, jax_cli.main, argv)
    assert rc_t == rc_j == 0
    return out_t, out_j


def _match(pattern, lines):
    """The numbers of the one line of ``lines`` that ``pattern`` matches."""
    hits = [re.fullmatch(pattern, line) for line in lines]
    hits = [h for h in hits if h]
    assert len(hits) == 1, (pattern, lines)
    return [float(g) for g in hits[0].groups()]


def _data_file(tmp_path):
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(4000, 2)) * [2.0, 0.5] + [1.0, -1.0]).astype(
        np.float32)
    path = tmp_path / "data.npz"
    np.savez(path, X=X)
    return str(path)


LOSS = r"final loss: " + NUM


@pytest.mark.parametrize("stages", ['["scale_shift"]', "default"])
def test_cli_train_user_data_matches_jax(tmp_path, capsys, stages):
    """Whitening on an .npz file is deterministic: the final loss (the mean
    of the last 50 steps' negll, f32) equals JAX's to the Adagrad eps's
    reach (optax inside the square root, torch outside)."""
    argv = ["train", "--data", _data_file(tmp_path), "--flow.dim=2",
            "--train.nepochs=2", "--train.nbatches=4"]
    if stages != "default":
        argv.append(f"--flow.stages={stages}")
    out_t, out_j = _both(capsys, argv)
    (got,), (want,) = _match(LOSS, out_t), _match(LOSS, out_j)
    assert abs(got - want) <= 2e-4, (out_t, out_j)


def test_cli_train_checkpoints_and_metrics(tmp_path, capsys):
    """``--train.checkpoint_every`` checkpoints the chunks under
    ``<checkpoint_dir>/train``; the final snapshot is JAX's ``{"flow",
    "opt_state"}`` at step ``len(history)``; the metrics file has a record
    a step; the run equals the library call bit for bit."""
    ck, mp = tmp_path / "ck", tmp_path / "m.jsonl"
    data = _data_file(tmp_path)
    rc, out = _run(capsys, cli.main, [
        "train", "--cpu", "--data", data, "--flow.dim=2",
        "--train.nbatches=4", "--train.nepochs=4",
        "--train.checkpoint_every=2", f"--checkpoint_dir={ck}",
        f"--metrics_path={mp}"])
    assert rc == 0 and _match(LOSS, out)
    assert TU.latest_step(str(ck / "train")) == 2
    assert TU.latest_step(str(ck)) == 16
    cfg = TU.load_config(None, ["--flow.dim=2"])
    flow = TU.build_flow(cfg.flow, device="cpu")
    like = {"flow": flow.state_dict(), "opt_state": None}
    final = TU.restore_checkpoint(str(ck), like, step=16)
    assert set(final) == {"flow", "opt_state"}
    recs = [json.loads(line) for line in open(mp)]
    assert [r["step"] for r in recs] == list(range(16))
    res = et.optimize_whitening(
        torch.from_numpy(np.load(data)["X"]), flow, cli._optimizer(cfg),
        nbatches=4, nepochs=4)
    assert [r["negll"] for r in recs] == res.negll_history.tolist()
    for k, v in res.result.state_dict().items():
        assert torch.equal(final["flow"][k], v), k


def test_cli_train_elbo_matches_jax(capsys):
    """The ELBO objective against the standard normal: both fits end near
    an nELBO of 0 (the draws differ, so does the last digit)."""
    out_t, out_j = _both(capsys, ["train", "--train.objective=elbo",
                                  "--flow.dim=1", "--train.nsteps=50"])
    for lines in (out_t, out_j):
        (loss,) = _match(LOSS, lines)
        assert abs(loss) < 0.05, lines


def test_cli_sample_smc_matches_jax(capsys):
    """The demo target is the base up to its normalizer: one temperature,
    log Z = log 2 pi exactly, the same line in both packages."""
    out_t, out_j = _both(capsys, ["sample", "--sampler.algorithm=smc",
                                  "--flow.dim=2",
                                  "--sampler.num_particles=1024"])
    assert out_t == out_j == ["SMC: 1 temperatures, logZ=1.8379"]


def test_cli_sample_hmc_matches_jax(capsys):
    out_t, out_j = _both(capsys, [
        "sample", "--sampler.algorithm=hmc", "--flow.dim=2",
        "--sampler.num_warmup=100", "--sampler.num_samples=100",
        "--sampler.num_chains=4"])
    pat = r"hmc: rhat=" + NUM + r" ess_min=(\d+) accept=" + NUM
    for lines in (out_t, out_j):
        rhat, ess, accept = _match(pat, lines)
        assert rhat < 1.5 and ess > 5 and 0.5 < accept <= 1.0, lines


def _targets(tmp_path):
    """The same Gaussian target N((1.5, -0.5), 0.25 I), unnormalized, as a
    torch file for the port and a jax file for JAX."""
    body = ("def logp(q):\n"
            "    mean = {mod}.asarray([1.5, -0.5], dtype=q.dtype)\n"
            "    return -0.5 * (((q - mean) ** 2) / 0.25).sum()\n")
    port = tmp_path / "target_torch.py"
    port.write_text("import torch\n" + body.format(mod="torch"))
    ref = tmp_path / "target_jax.py"
    ref.write_text("import jax.numpy as jnp\n" + body.format(mod="jnp"))
    return f"{port}:logp", f"{ref}:logp"


SMC_LINE = (r"smc: logZ=" + NUM + r" weight_ess=(\d+) mean=\[\s*" + NUM
            + r"\s+" + NUM + r"\]")


def test_cli_infer_smc_matches_jax(tmp_path, capsys):
    """``infer --sampler.algorithm=smc`` on a user target: both estimate log
    Z = log(2 pi 0.25) and the mean."""
    port, ref = _targets(tmp_path)
    flags = ["infer", "--sampler.algorithm=smc", "--flow.dim=2",
             "--sampler.num_particles=1024"]
    _, out_t = _run(capsys, cli.main, flags + ["--target", port, "--cpu"])
    _, out_j = _run(capsys, jax_cli.main, flags + ["--target", ref])
    for lines in (out_t, out_j):
        logz, ess, m0, m1 = _match(SMC_LINE, lines)
        assert abs(logz - np.log(2 * np.pi * 0.25)) < 0.1, lines
        assert abs(m0 - 1.5) < 0.1 and abs(m1 + 0.5) < 0.1, lines
        assert ess > 100


PRE_LINE = (r"precondition: family=(\w+) khat=" + NUM + r" coverage_gap="
            + NUM)
MCMC_LINE = (r"(\w+): rhat=" + NUM + r" min_bulk_ess=(\d+) tail_ess=(\d+) "
             r"divergences=(\d+) mean=\[\s*" + NUM + r"\s+" + NUM + r"\]")


def test_cli_infer_elementwise_matches_jax(capsys):
    """``infer --sampler.precondition_kind=elementwise`` on the demo target:
    the precondition and sampler lines in JAX's format, the family pinned
    in both. (The demo's Householder row is drawn from each package's own
    generator, so the targets, and their means, differ.)"""
    flags = ["infer", "--flow.dim=2",
             "--sampler.precondition_kind=elementwise",
             "--sampler.num_warmup=100", "--sampler.num_samples=100",
             "--sampler.num_chains=4", "--train.nsteps=100"]
    out_t, out_j = _both(capsys, flags)
    for lines in (out_t, out_j):
        assert len(lines) == 2, lines
        assert re.fullmatch(PRE_LINE, lines[0]), lines
        assert lines[0].startswith("precondition: family=elementwise ")
        m = re.fullmatch(MCMC_LINE, lines[1])
        assert m and m.group(1) == "nuts", lines
        assert float(m.group(2)) < 1.2, lines


def test_cli_user_target_end_to_end(tmp_path, capsys):
    """tests/test_utils.py:221-255: the CLI infers and samples a density
    defined outside the repo (here in torch), the printed mean the
    target's."""
    port, _ = _targets(tmp_path)
    rc, out = _run(capsys, cli.main, [
        "infer", "--cpu", "--target", port, "--flow.dim=2",
        "--sampler.algorithm=chees", "--sampler.num_warmup=150",
        "--sampler.num_samples=150", "--sampler.num_chains=8",
        "--train.nsteps=150"])
    assert rc == 0
    vals = re.fullmatch(MCMC_LINE, out[-1])
    assert vals and vals.group(1) == "chees", out
    assert abs(float(vals.group(6)) - 1.5) < 0.2, out
    assert abs(float(vals.group(7)) + 0.5) < 0.2, out
    rc, out = _run(capsys, cli.main, [
        "sample", "--cpu", "--target", port, "--flow.dim=2",
        "--sampler.algorithm=nuts", "--sampler.num_warmup=100",
        "--sampler.num_samples=100", "--sampler.num_chains=4"])
    assert rc == 0 and out[-1].startswith("nuts: rhat=")


def test_cli_precondition_kind_flag(tmp_path, capsys):
    """tests/test_utils.py:445-470's second half: the family flag reaches
    ``infer`` and is reported."""
    port, _ = _targets(tmp_path)
    rc, out = _run(capsys, cli.main, [
        "infer", "--cpu", "--target", port, "--flow.dim=2",
        "--sampler.precondition_kind=affine", "--sampler.num_warmup=100",
        "--sampler.num_samples=100", "--sampler.num_chains=4",
        "--train.nsteps=100"])
    assert rc == 0 and "family=affine" in out[0], out


def test_cli_needs_the_card_unless_asked_for_the_cpu():
    """Without ``--cpu`` the CLI runs on the card, and fails where there is
    none. A mesh runs since ROADMAP A.10: one of one rank here (two ranks
    under torchrun: tests/test_torch_parallel_train.py); one that asks for
    more ranks than the process has raises."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="pass --cpu"):
            cli.main(["train", "--flow.dim=1", "--train.nepochs=1",
                      "--train.nbatches=10"])
    assert cli.main(["train", "--cpu", "--flow.dim=1", "--train.nepochs=1",
                     "--train.nbatches=10", '--mesh.axes={"batch": 1}']) == 0
    with pytest.raises(ValueError, match="do not cover"):
        cli.main(["train", "--cpu", '--mesh.axes={"chains": 2}'])


def test_cli_mesh_is_for_train_only():
    """As in JAX, the mesh reaches the whitening trainer only: ``sample`` and
    ``infer`` with ``--mesh.axes`` refuse, rather than join a process group
    and run the whole job on every rank."""
    for command in ("sample", "infer"):
        with pytest.raises(SystemExit, match="train command only"):
            cli.main([command, "--cpu", '--mesh.axes={"chains": 1}'])


def test_cli_module_entry_point(tmp_path):
    """``python -m enflows_tpu_torch.cli`` from another directory, without
    importing JAX."""
    code = ("import runpy, sys; sys.argv = ['cli', 'train', '--cpu', "
            "'--flow.dim=1', '--train.nepochs=1', '--train.nbatches=10']; "
            "runpy.run_module('enflows_tpu_torch.cli', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code + "\n"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.fullmatch(LOSS, proc.stdout.strip().splitlines()[-1])
    check = ("import sys, runpy; sys.argv = ['cli', 'sample', '--cpu', "
             "'--sampler.algorithm=smc', '--flow.dim=2', "
             "'--sampler.num_particles=256']\n"
             "try:\n    runpy.run_module('enflows_tpu_torch.cli', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n    assert not e.code, e.code\n"
             "bad = [m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'enflows_tpu.'))]\n"
             "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", check], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "SMC: 1 temperatures, logZ=1.8379"


def leapfrog_turns(step_size, inv_mass_diag, num_steps=32):
    """Each coordinate's rotation, in turns, over ``num_steps`` leapfrog
    steps on a standard Gaussian: num_steps * arccos(1 - eps^2 w / 2) / 2 pi
    (w the inverse mass). Near an integer the trajectory ends where it
    started, and the chains barely move; nan where the steps are
    unstable (eps^2 w > 4)."""
    c = 1.0 - 0.5 * float(step_size) ** 2 * np.asarray(inv_mass_diag,
                                                       np.float64)
    return num_steps * np.where(np.abs(c) <= 1.0, np.arccos(
        np.clip(c, -1.0, 1.0)), np.nan) / (2 * np.pi)


def hmc_cli_run(package, seed):
    """``cli sample --sampler.algorithm=hmc --flow.dim=2`` with 4 chains of
    100 + 100 transitions, as each package's CLI runs it (the port on the
    CPU), returning (rhat, ess_min, accept, step size, inverse mass, turns
    per coordinate)."""
    if package == "jax":
        import jax
        import jax.numpy as jnp
        from enflows_tpu import mcmc as M
        key = jax.random.PRNGKey(seed)
        logp = lambda q: -0.5 * jnp.sum(q * q)
        extra = {}
    else:
        M = et.mcmc
        key = torch.Generator().manual_seed(seed)
        logp = lambda q: -0.5 * (q * q).sum(-1)
        extra = dict(device="cpu")
    samples, _, stats = M.sample(logp, key, dim=2, num_chains=4,
                                 num_warmup=100, num_samples=100,
                                 algorithm="hmc", max_depth=10, num_steps=32,
                                 target_accept=0.8, **extra)
    eps = float(np.asarray(stats.step_size))
    w = np.asarray(stats.inv_mass_diag, np.float64)
    return (float(M.split_rhat_per_dim(samples).max()),
            float(M.ess_per_dim(samples).min()),
            float(np.mean(np.asarray(stats.accept_prob))), eps, w,
            leapfrog_turns(eps, w))


@pytest.mark.parametrize("package,seed,stalls", [
    ("jax", 0, False), ("jax", 8, True), ("torch", 0, False),
    ("torch", 4, True)])
def test_cli_hmc_stalls_where_its_steps_turn_whole(package, seed, stalls):
    """The CLI's HMC (32 fixed leapfrog steps) stalls in both packages on
    the seeds where a coordinate's 32 steps at the adapted step size and
    inverse mass turn within 0.05 of a whole number of times, and mixes
    elsewhere (``python -m tests.test_torch_cli hmc`` reads 20 seeds)."""
    rhat, ess, accept, _, _, turns = hmc_cli_run(package, seed)
    near = float(np.min(np.abs(turns - np.round(turns)))) < 0.05
    assert near == stalls and (rhat > 2.0) == stalls, (rhat, turns)
    assert 0.5 < accept <= 1.0


if __name__ == "__main__":
    # python -m tests.test_torch_cli hmc [seeds]   (~1 s a seed on one core)
    # The CLI's HMC line over generator seeds in both packages, with the
    # adapted step size and each coordinate's turns over the 32 steps.
    import jax
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["hmc"]:
        nseeds = int(sys.argv[2]) if len(sys.argv) > 2 else 10
        for package in ("jax", "torch"):
            for seed in range(nseeds):
                rhat, ess, acc, eps, w, turns = hmc_cli_run(package, seed)
                print(f"{package} seed {seed}: rhat={rhat:.4f} "
                      f"ess_min={ess:.0f} accept={acc:.3f} "
                      f"step_size={eps:.4f} inv_mass={np.round(w, 4)} "
                      f"turns={np.round(turns, 3)}", flush=True)
