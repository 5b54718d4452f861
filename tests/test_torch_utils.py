"""The port's run utilities against the JAX package's (tests/test_utils.py,
tests/test_resilience.py): checkpoint round trips (generator and optimizer
state included), ``run_checkpointed``'s crash-resume equivalence, the
heartbeat and its rescue save, chunked trainers bit-identical to unchunked
ones, a SIGKILLed trainer process resumed bit-identically, metrics streams
from both trainers, ``sample`` and ``smc_sample``, configs and
``build_flow``, named profiler ranges in a CPU trace, and the NaN guards.

Where a run is deterministic the port is held to JAX on the same numpy
inputs in float64: Adagrad with eps=0 on both sides (optax puts its eps
inside the square root, torch outside), so the histories agree to 1e-10
relative; VI is given JAX's own draws through ``train.vi._base_draws``.
"""
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import enflows_tpu as ef
from enflows_tpu import mcmc as JM
from enflows_tpu import smc as JS
from enflows_tpu import utils as JU
from enflows_tpu.train import optimize_elbo as jax_optimize_elbo
from enflows_tpu.train import optimize_whitening as jax_optimize_whitening
import enflows_tpu_torch as et
from enflows_tpu_torch import utils as TU
from enflows_tpu_torch.interop import from_jax
from enflows_tpu_torch.train import vi as VI
from enflows_tpu_torch.utils import resilience as TR

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T64 = torch.float64
F64 = jnp.float64
RTOL = 1e-10


def _adagrad(lr=0.1):
    return lambda p: torch.optim.Adagrad(p, lr=lr,
                                         initial_accumulator_value=0.1,
                                         eps=0.0)


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return 2.0 * rng.normal(size=(n, 2)) + 1.0


def _scale_shift():
    return et.ScaleShift(torch.ones(2, dtype=T64), torch.zeros(2, dtype=T64))


def _jax_scale_shift():
    return ef.ScaleShift(a=jnp.ones(2, F64), b=jnp.zeros(2, F64))


def _leaves_equal(a, b):
    la, lb = TU.tree_leaves(a), TU.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert x == y


def _flat_state(state):
    """Every leaf of a nested state, dict values in key order."""
    if isinstance(state, dict):
        return [v for k in sorted(state, key=str)
                for v in _flat_state(state[k])]
    if isinstance(state, (list, tuple)):
        return [v for item in state for v in _flat_state(item)]
    return [state]


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_utils.py:18-120).

class _Pair(NamedTuple):
    a: torch.Tensor
    b: int


def _stepped(opt_cls, flow, **kw):
    opt = opt_cls(flow.parameters(), **kw)
    X = torch.from_numpy(_data(64))
    for _ in range(2):
        opt.zero_grad()
        et.mvnormal_negll(flow, X).backward()
        opt.step()
    return opt


def test_checkpoint_round_trip(tmp_path):
    flow = et.compose(et.CenterStretch(torch.tensor([1.0], dtype=T64),
                                       torch.tensor([2.0], dtype=T64),
                                       torch.tensor([0.5], dtype=T64)),
                      _scale_shift())
    ada = _stepped(torch.optim.Adagrad, flow, lr=0.1,
                   initial_accumulator_value=0.1)
    adam = _stepped(torch.optim.Adam, flow, lr=0.01)
    gen = torch.Generator().manual_seed(7)
    torch.randn(5, generator=gen)
    state = {"flow": flow.state_dict(), "adagrad": ada.state_dict(),
             "adam": adam.state_dict(), "generator": gen.get_state(),
             "step": 42, "lr": 0.1, "tag": "run", "none": None,
             "pair": _Pair(torch.arange(3), 4), "array": np.arange(4.0),
             "list": [torch.tensor(1.5), (2, 3)]}
    path = str(tmp_path / "ckpt")
    assert TU.save_checkpoint(path, state, step=42).endswith("step_42.pt")
    assert TU.latest_step(path) == 42
    restored = TU.restore_checkpoint(path, state, step=42)
    assert isinstance(restored["pair"], _Pair)
    assert isinstance(restored["array"], np.ndarray)
    np.testing.assert_array_equal(restored["array"], state["array"])
    assert restored["list"][1] == (2, 3)
    _leaves_equal([v for k, v in state.items() if k != "array"],
                  [v for k, v in restored.items() if k != "array"])
    # The restored optimizer and generator continue exactly as the live
    # ones do.
    twin = et.compose(et.CenterStretch(torch.zeros(1, dtype=T64),
                                       torch.ones(1, dtype=T64),
                                       torch.zeros(1, dtype=T64)),
                      _scale_shift())
    twin.load_state_dict(restored["flow"])
    opt2 = torch.optim.Adam(twin.parameters(), lr=0.01)
    opt2.load_state_dict(restored["adam"])
    for f, o in ((flow, adam), (twin, opt2)):
        o.zero_grad()
        et.mvnormal_negll(f, torch.from_numpy(_data(64))).backward()
        o.step()
    _leaves_equal(list(flow.parameters()), list(twin.parameters()))
    gen2 = torch.Generator()
    gen2.set_state(restored["generator"])
    assert torch.equal(torch.randn(5, generator=gen),
                       torch.randn(5, generator=gen2))


class _Opaque:
    pass


def test_checkpoint_restore_is_weights_only(tmp_path):
    """Checkpoints load with ``weights_only=True``: a pickled object that
    is not plain state is refused."""
    path = str(tmp_path / "ck")
    TU.save_checkpoint(path, {"x": _Opaque()}, step=1)
    with pytest.raises(Exception, match="[Ww]eights only"):
        TU.restore_checkpoint(path, {"x": None}, step=1)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that dies half way leaves the previous step as the latest;
    the temporary file is not named step_*."""
    path = str(tmp_path / "ck")
    TU.save_checkpoint(path, {"x": torch.ones(3)}, step=1)
    real_save = torch.save

    def dies_half_way(obj, f, *a, **kw):
        f.write(b"half a checkpoint")
        raise KeyboardInterrupt("killed")

    monkeypatch.setattr(torch, "save", dies_half_way)
    with pytest.raises(KeyboardInterrupt):
        TU.save_checkpoint(path, {"x": torch.zeros(3)}, step=2)
    monkeypatch.setattr(torch, "save", real_save)
    assert TU.latest_step(path) == 1
    assert not os.path.exists(os.path.join(path, "step_2.pt"))
    assert any(n.endswith(".tmp") for n in os.listdir(path))
    got = TU.restore_checkpoint(path, {"x": torch.zeros(3)}, step=1)
    assert torch.equal(got["x"], torch.ones(3))


def test_checkpoint_orbax_waits_for_a10(tmp_path):
    """``use_orbax=True`` raised naming ROADMAP A.10 until A.10 was ported
    (the test keeps its name); A.10 ported the per-rank shard files, and
    Orbax, a JAX library, has no counterpart: it still raises, saying so."""
    with pytest.raises(NotImplementedError, match="no counterpart"):
        TU.save_checkpoint(str(tmp_path), {}, use_orbax=True)
    with pytest.raises(NotImplementedError, match="no counterpart"):
        TU.restore_checkpoint(str(tmp_path), {}, use_orbax=True)


def test_checkpoint_resume_training(tmp_path):
    """Save half way, restore, continue: bit-identical to the
    uninterrupted run, and held to JAX's (tests/test_utils.py:98-120)."""
    X = torch.from_numpy(_data(1000))
    full = et.optimize_whitening(X, _scale_shift(), _adagrad(),
                                 nbatches=10, nepochs=10)
    half = et.optimize_whitening(X, _scale_shift(), _adagrad(),
                                 nbatches=10, nepochs=5)
    path = str(tmp_path / "ck")
    TU.save_checkpoint(path, {"flow": half.result.state_dict(),
                              "opt": half.optimizer_state}, step=5)
    like = {"flow": _scale_shift().state_dict(),
            "opt": _adagrad()(list(_scale_shift().parameters()))
            .state_dict()}
    restored = TU.restore_checkpoint(path, like, step=5)
    flow = _scale_shift()
    flow.load_state_dict(restored["flow"])
    resumed = et.optimize_whitening(X, flow, _adagrad(), nbatches=10,
                                    nepochs=5, opt_state=restored["opt"])
    _leaves_equal(list(full.result.parameters()),
                  list(resumed.result.parameters()))
    jres = jax_optimize_whitening(jnp.asarray(X.numpy()), _jax_scale_shift(),
                                  optax.adagrad(0.1, eps=0.0), nbatches=10,
                                  nepochs=10)
    np.testing.assert_allclose(resumed.result.a.detach().numpy(),
                               np.asarray(jres.result.a), rtol=RTOL)
    np.testing.assert_allclose(resumed.result.b.detach().numpy(),
                               np.asarray(jres.result.b), rtol=RTOL)


# ---------------------------------------------------------------------------
# Metrics (tests/test_utils.py:123-145, :318-370).

def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with TU.MetricsLogger(path) as log:
        log.log(0, negll=1.5, accept=0.8)
        log.log(1, negll=torch.tensor(1.2, dtype=T64))
        log.log(2, vec=torch.arange(3), scalar=np.float32(0.25))
    lines = [json.loads(line) for line in open(path)]
    assert [sorted(rec) for rec in lines[:2]] == [
        ["accept", "negll", "step", "time"], ["negll", "step", "time"]]
    assert lines[0]["negll"] == 1.5 and lines[1]["negll"] == 1.2
    assert lines[2]["vec"] == [0, 1, 2] and lines[2]["scalar"] == 0.25
    assert len(log.history) == 3


def test_metrics_logger_reads_tensors_when_it_writes(tmp_path):
    """0-d tensors stay pending, unread, until ``flush_every`` records
    gather; then they are written as numbers of their dtype's kind."""
    path = str(tmp_path / "m.jsonl")
    log = TU.MetricsLogger(path, flush_every=3)
    log.log(0, loss=torch.tensor(0.5), flag=torch.tensor(True))
    log.log(1, loss=torch.tensor(0.25), count=torch.tensor(7))
    assert open(path).read() == ""
    assert isinstance(log._pending[0]["loss"], torch.Tensor)
    log.log(2, loss=torch.tensor(0.125, dtype=T64))
    recs = [json.loads(line) for line in open(path)]
    assert [r["loss"] for r in recs] == [0.5, 0.25, 0.125]
    assert recs[0]["flag"] is True and recs[1]["count"] == 7
    assert isinstance(recs[1]["count"], int)
    log.log(3, loss=torch.tensor(1.0))
    assert len(log.history) == 4      # reading history writes the rest
    log.close()
    assert len(open(path).read().splitlines()) == 4


def test_metrics_stream_from_whitening_matches_jax(tmp_path):
    X = _data(400)
    path = str(tmp_path / "train.jsonl")
    with TU.MetricsLogger(path) as log:
        res = et.optimize_whitening(torch.from_numpy(X), _scale_shift(),
                                    _adagrad(), nbatches=4, nepochs=3,
                                    metrics=log)
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == list(range(12))
    # The stream is the history, bit for bit.
    assert [r["negll"] for r in recs] == res.negll_history.tolist()
    jlog = JU.MetricsLogger(None)
    jres = jax_optimize_whitening(jnp.asarray(X), _jax_scale_shift(),
                                  optax.adagrad(0.1, eps=0.0), nbatches=4,
                                  nepochs=3, metrics=jlog)
    jax.block_until_ready(jres.result)
    jax.effects_barrier()
    jrecs = sorted(jlog.history, key=lambda r: r["step"])
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    np.testing.assert_allclose([r["negll"] for r in recs],
                               [r["negll"] for r in jrecs], rtol=RTOL)


def _jax_draws(monkeypatch, key, dtype=F64):
    def draws(generator, step, batch_size, dim, dt, device):
        x = jax.random.normal(jax.random.fold_in(key, step),
                              (batch_size, dim), dtype=dtype)
        return torch.from_numpy(np.array(x)).to(device)
    monkeypatch.setattr(VI, "_base_draws", draws)


def _tlogp(z):
    return -0.5 * (((z - 1.0) / 1.5) ** 2).sum(-1)


def _jlogp(z):
    return -0.5 * jnp.sum(((z - 1.0) / 1.5) ** 2, axis=-1)


def test_metrics_stream_from_vi_matches_jax(monkeypatch):
    key = jax.random.PRNGKey(5)
    _jax_draws(monkeypatch, key)
    log = TU.MetricsLogger(None)
    res = et.optimize_elbo(_tlogp, _scale_shift(), _adagrad(0.05), dim=2,
                           batch_size=32, nsteps=7, key=torch.Generator(),
                           dtype=T64, metrics=log)
    assert [r["step"] for r in log.history] == list(range(7))
    assert [r["nelbo"] for r in log.history] == res.nelbo_history.tolist()
    jlog = JU.MetricsLogger(None)
    jres = jax_optimize_elbo(_jlogp, _jax_scale_shift(),
                             optax.adagrad(0.05, eps=0.0), dim=2,
                             batch_size=32, nsteps=7, key=key, dtype=F64,
                             metrics=jlog)
    jax.block_until_ready(jres.result)
    jax.effects_barrier()
    jrecs = sorted(jlog.history, key=lambda r: r["step"])
    assert [sorted(r) for r in log.history] == [sorted(r) for r in jrecs]
    np.testing.assert_allclose([r["nelbo"] for r in log.history],
                               [r["nelbo"] for r in jrecs], rtol=RTOL)


def test_metrics_stream_from_sampler():
    """JAX's per-transition fields and counts; the sampling records are the
    returned statistics' chain means and sums, bit for bit."""
    log = TU.MetricsLogger(None)
    draws, _, stats = et.mcmc.sample(
        lambda q: -0.5 * (q * q).sum(-1), torch.Generator().manual_seed(0),
        dim=2, num_chains=4, num_warmup=30, num_samples=20,
        algorithm="hmc", device="cpu", metrics=log)
    jlog = JU.MetricsLogger(None)
    jdraws, _, _ = JM.sample(lambda q: -0.5 * jnp.sum(q * q),
                             jax.random.PRNGKey(0), dim=2, num_chains=4,
                             num_warmup=30, num_samples=20, algorithm="hmc",
                             metrics=jlog)
    jax.block_until_ready(jdraws)
    jax.effects_barrier()
    for hist in (log.history, jlog.history):
        warm = [r for r in hist if "warmup_accept" in r]
        samp = [r for r in hist if "accept" in r]
        assert len(warm) == 30 and len(samp) == 20
        assert all(0.0 <= r["warmup_accept"] <= 1.0 for r in warm)
        assert all(r["warmup_step_size"] > 0 for r in warm)
    assert [sorted(r) for r in log.history] == \
        [sorted(r) for r in sorted(jlog.history, key=lambda r: (
            "accept" in r, r["step"]))]
    samp = [r for r in log.history if "accept" in r]
    assert [r["accept"] for r in samp] == \
        stats.accept_prob.mean(1).tolist()
    assert [r["divergences"] for r in samp] == \
        stats.divergent.sum(1).tolist()
    assert log.history[0]["warmup_step_size"] == pytest.approx(0.1)


def test_metrics_stream_from_smc():
    log = TU.MetricsLogger(None)
    _, _, logz, infos = et.smc.smc_sample(
        lambda q: -0.5 * ((q - 1.0) ** 2).sum(-1),
        torch.Generator().manual_seed(0), dim=2, num_particles=512,
        metrics=log, dtype=T64)
    assert len(log.history) == len(infos) > 1
    assert log.history[-1]["beta"] == 1.0
    assert log.history[-1]["log_z"] == float(logz)
    assert [r["beta"] for r in log.history] == [float(i.beta) for i in infos]
    assert all(isinstance(r["resampled"], bool) for r in log.history)


def test_metrics_stream_from_smc_matches_jax_on_one_temperature():
    """A target that differs from the base by a constant ends in one
    temperature; its record (all but the mutations' acceptance) is
    deterministic and equals JAX's."""
    log = TU.MetricsLogger(None)
    et.smc.smc_sample(lambda q: -0.5 * (q * q).sum(-1),
                      torch.Generator().manual_seed(0), dim=2,
                      num_particles=256, metrics=log, dtype=T64)
    jlog = JU.MetricsLogger(None)
    JS.smc_sample(lambda q: -0.5 * jnp.sum(q * q), jax.random.PRNGKey(0),
                  dim=2, num_particles=256, metrics=jlog, dtype=F64)
    (rec,), (jrec,) = log.history, jlog.history
    assert sorted(rec) == sorted(jrec)
    assert rec["step"] == jrec["step"] == 0
    assert rec["beta"] == jrec["beta"] == 1.0
    assert rec["resampled"] is jrec["resampled"] is False
    np.testing.assert_allclose([rec["ess"], rec["log_z"]],
                               [jrec["ess"], jrec["log_z"]], rtol=1e-12)


# ---------------------------------------------------------------------------
# run_checkpointed and the heartbeat (tests/test_resilience.py:22-141).

def _make_step():
    """A deterministic step on plain state: the flow's parameters and the
    Adagrad accumulators, one full-batch step on fixed data."""
    X = torch.from_numpy(_data(512))

    def step(state, i):
        a = torch.nn.Parameter(state["a"].clone())
        b = torch.nn.Parameter(state["b"].clone())
        negll = et.mvnormal_negll(et.ScaleShift(a, b), X)
        ga, gb = torch.autograd.grad(negll, [a, b])
        acc_a, acc_b = state["acc_a"] + ga * ga, state["acc_b"] + gb * gb
        return {"a": (a - 0.1 * ga / acc_a.sqrt()).detach(),
                "b": (b - 0.1 * gb / acc_b.sqrt()).detach(),
                "acc_a": acc_a, "acc_b": acc_b, "i": i + 1}

    z = lambda v: torch.full((2,), v, dtype=T64)
    return step, {"a": z(1.0), "b": z(0.0), "acc_a": z(0.1),
                  "acc_b": z(0.1), "i": 0}


def test_crash_resume_equivalence(tmp_path):
    step, state0 = _make_step()
    ckpt = str(tmp_path / "ck")
    full, start = TU.run_checkpointed(step, state0, 40, ckpt_dir=None)
    assert start == 0
    crashed = state0
    for i in range(25):
        crashed = step(crashed, i)
        if (i + 1) % 10 == 0:
            TU.save_checkpoint(ckpt, crashed, step=i + 1)
    resumed, start = TU.run_checkpointed(step, state0, 40, ckpt_dir=ckpt,
                                         checkpoint_every=10, resume=True)
    assert start == 20
    _leaves_equal(full, resumed)
    assert TU.latest_step(ckpt) == 40


def test_heartbeat():
    assert TU.heartbeat(30.0, device="cpu")
    # The default device is the card: without one the probe fails.
    assert TU.heartbeat(30.0) is torch.cuda.is_available()


def test_heartbeat_times_out_on_hung_probe():
    t0 = time.time()
    assert TU.heartbeat(0.5, _probe=lambda: threading.Event().wait()) \
        is False
    elapsed = time.time() - t0
    assert 0.4 <= elapsed < 5.0, f"deadline not honored: {elapsed:.2f}s"


def test_heartbeat_false_on_wrong_sum():
    assert TU.heartbeat(5.0, _probe=lambda: False) is False


def test_heartbeat_all_reduce_in_a_process_group(tmp_path):
    """Under an initialized ``torch.distributed`` group the probe is an
    ``all_reduce`` checked against the world size (1 here, gloo)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert TR._default_probe("cpu")
        assert TU.heartbeat(30.0, device="cpu")
    finally:
        dist.destroy_process_group()


def test_run_checkpointed_heartbeat_failure_then_resume(tmp_path):
    step, state0 = _make_step()
    ckpt = str(tmp_path / "ck")
    full, _ = TU.run_checkpointed(step, state0, 30, ckpt_dir=None)
    calls = {"n": 0}

    def failing_after_two(timeout_s):
        calls["n"] += 1
        return calls["n"] <= 2          # probes at steps 5, 10 ok; 15 dead

    with pytest.raises(TU.HeartbeatTimeout, match="after step 15"):
        TU.run_checkpointed(step, state0, 30, ckpt_dir=ckpt,
                            checkpoint_every=100, heartbeat_every=5,
                            _heartbeat_fn=failing_after_two)
    assert TU.latest_step(ckpt) == 15
    # The restarted run probes the state's device (the CPU) with the
    # default heartbeat.
    resumed, start = TU.run_checkpointed(step, state0, 30, ckpt_dir=ckpt,
                                         checkpoint_every=100, resume=True,
                                         heartbeat_every=5)
    assert start == 15
    _leaves_equal(full, resumed)


def test_rescue_checkpoint_hang_still_raises(tmp_path, monkeypatch):
    step, state0 = _make_step()
    monkeypatch.setattr(TR, "save_checkpoint",
                        lambda *a, **kw: threading.Event().wait())
    t0 = time.time()
    with pytest.raises(TU.HeartbeatTimeout, match="NOT saved"):
        TU.run_checkpointed(step, state0, 10, ckpt_dir=str(tmp_path),
                            checkpoint_every=100, heartbeat_every=5,
                            heartbeat_timeout_s=0.5,
                            _heartbeat_fn=lambda t: False)
    assert time.time() - t0 < 10.0, "failure path hung past the deadline"


# ---------------------------------------------------------------------------
# NaN guards (tests/test_resilience.py:144-160).

def test_nan_guard_catches():
    guarded = TU.nan_guard(torch.log, "log_out")
    np.testing.assert_allclose(guarded(torch.tensor([1.0, 2.0])).numpy(),
                               np.log([1.0, 2.0]), rtol=1e-6)
    with pytest.raises(ValueError, match="non-finite values in log_out"):
        guarded(torch.tensor([-1.0]))
    ratio = TU.nan_guard(lambda x: (x, x / x), "ratio")
    with pytest.raises(ValueError, match=r"ratio \(leaf 1\)"):
        ratio(torch.tensor([0.0]))


def test_assert_finite_walks_nested_state():
    TU.assert_finite({"a": [torch.ones(2), torch.arange(3)], "n": 3,
                      "m": _scale_shift()}, "state")
    with pytest.raises(ValueError, match=r"flow \(leaf 1\)"):
        TU.assert_finite(et.ScaleShift(torch.ones(2),
                                       torch.tensor([0.0, float("inf")])),
                         "flow")


# ---------------------------------------------------------------------------
# The trainers' chunks and resume (tests/test_resilience.py:163-300).

def _whitening(X, ckpt=None, every=None, metrics=None):
    return et.optimize_whitening(torch.from_numpy(X), _scale_shift(),
                                 _adagrad(0.05), nbatches=4, nepochs=6,
                                 checkpoint_every=every, ckpt_dir=ckpt,
                                 metrics=metrics)


def _elbo(seed, ckpt=None, every=None, metrics=None):
    return et.optimize_elbo(_tlogp, _scale_shift(), _adagrad(0.05), dim=2,
                            batch_size=64, nsteps=9,
                            key=torch.Generator().manual_seed(seed),
                            dtype=T64, checkpoint_every=every, ckpt_dir=ckpt,
                            metrics=metrics)


def _same_result(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.nn.Module):
            _leaves_equal(list(x.parameters()), list(y.parameters()))
        elif isinstance(x, dict):
            _leaves_equal(_flat_state(x), _flat_state(y))
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("with_dir", [False, True])
@pytest.mark.parametrize("trainer", ["whitening", "elbo"])
def test_trainer_checkpoint_chunking_matches_unchunked(trainer, with_dir,
                                                        tmp_path):
    """``checkpoint_every`` does not change the math: chunked runs, with
    and without a ``ckpt_dir``, equal the unchunked run bit for bit
    (result, optimizer state, history); the whitening history is JAX's
    chunked one to 1e-10."""
    ckpt = str(tmp_path / "ck") if with_dir else None
    if trainer == "whitening":
        X = _data(2048)
        a, b = _whitening(X), _whitening(X, ckpt, every=2)
        jb = jax_optimize_whitening(jnp.asarray(X), _jax_scale_shift(),
                                    optax.adagrad(0.05, eps=0.0),
                                    nbatches=4, nepochs=6,
                                    checkpoint_every=2)
        np.testing.assert_allclose(b.negll_history.numpy(),
                                   np.asarray(jb.negll_history), rtol=RTOL)
    else:
        a, b = _elbo(3), _elbo(3, ckpt, every=4)
    _same_result(a, b)
    if with_dir:
        assert TU.latest_step(ckpt) == 3


class _Crash(Exception):
    pass


class _CrashingLog(TU.MetricsLogger):
    """A stream that raises at step ``at``: the run dies there, after the
    checkpoints of the chunks before it."""

    def __init__(self, at):
        super().__init__(None)
        self.at = at

    def log(self, step, **metrics):
        if step == self.at:
            raise _Crash(step)
        super().log(step, **metrics)


@pytest.mark.parametrize("trainer", ["whitening", "elbo"])
def test_trainer_crash_resume_bit_equivalence(trainer, tmp_path):
    """A run that dies mid-chunk, called again the same way, resumes from
    its last checkpoint and ends bit-identical to an uninterrupted run:
    for VI the generator's state is restored with the flow and the
    optimizer, so the resumed steps draw what the uninterrupted run
    drew."""
    ckpt = str(tmp_path / "ck")
    if trainer == "whitening":
        X = _data(2048)
        run = lambda **kw: _whitening(X, every=2, **kw)
        crash_at, last = 17, 2          # in epoch 4: chunks of 2 epochs
    else:
        run = lambda **kw: _elbo(11, every=2, **kw)
        crash_at, last = 5, 2           # in step 5: chunks of 2 steps
    ref = run()
    with pytest.raises(_Crash):
        run(ckpt=ckpt, metrics=_CrashingLog(crash_at))
    assert TU.latest_step(ckpt) == last
    _same_result(ref, run(ckpt=ckpt))


_KILL_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["ENFLOWS_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import enflows_tpu_torch as et

ckpt_dir, out_path = sys.argv[1], sys.argv[2]
T = torch.float64
rng = np.random.default_rng(0)
X = torch.from_numpy(2.0 * rng.normal(size=(32768, 2)) + 1.0)
v = lambda val: torch.full((2,), val, dtype=T)
flow = et.compose(et.Johnson(v(0.0), v(5.0), v(0.0), v(5.0)),
                  et.ScaleShift(v(1.0), v(0.0)))
opt = lambda p: torch.optim.Adagrad(p, lr=0.05, initial_accumulator_value=0.1)
res = et.optimize_whitening(X, flow, opt, nbatches=8, nepochs=20,
                            checkpoint_every=2, ckpt_dir=ckpt_dir or None)
np.savez(out_path, hist=res.negll_history.numpy(),
         *[p.detach().numpy() for p in res.result.parameters()])
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not bad, bad
"""


def test_trainer_kill_resume_bit_equivalence(tmp_path):
    """A trainer process SIGKILLed once its first checkpoint lands resumes,
    called again the same way, to a bit-identical result
    (tests/test_resilience.py:163-265, torch only, in a few seconds)."""
    import shutil

    script = tmp_path / "train_child.py"
    script.write_text(_KILL_CHILD)
    env = dict(os.environ, ENFLOWS_REPO=ROOT)

    def run_child(ckpt, out, wait=True):
        p = subprocess.Popen([sys.executable, str(script), ckpt, str(out)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        if wait:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode(errors="replace")[-2000:]
        return p

    out_ref = tmp_path / "ref.npz"
    run_child("", out_ref)
    ckpt_dir = tmp_path / "ck"
    out_res = tmp_path / "resumed.npz"
    for _ in range(3):
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        if out_res.exists():
            out_res.unlink()
        p = run_child(str(ckpt_dir), out_res, wait=False)
        deadline = time.time() + 300
        while time.time() < deadline:
            if TU.latest_step(str(ckpt_dir)) is not None:
                break
            if p.poll() is not None:
                _, err = p.communicate()
                raise AssertionError("child finished before any checkpoint:"
                                     "\n" + err.decode(errors="replace"))
            time.sleep(0.005)
        else:
            raise AssertionError("no checkpoint appeared within deadline")
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
        if not out_res.exists():
            break                       # the kill landed mid-run
    else:
        raise AssertionError("child completed before every kill attempt")
    killed_at = TU.latest_step(str(ckpt_dir))
    assert killed_at < 10, killed_at
    run_child(str(ckpt_dir), out_res)
    ref, got = np.load(out_ref), np.load(out_res)
    assert set(ref.files) == set(got.files)
    for k in ref.files:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


# ---------------------------------------------------------------------------
# Configs and build_flow (tests/test_utils.py:148-176, :263-290).

def _write_config(tmp_path, fmt):
    data = {"flow": {"dim": 2, "stages": ["scale_shift", "householder"]},
            "train": {"nepochs": 3}, "checkpoint_dir": "ck"}
    if fmt == "json":
        p = tmp_path / "cfg.json"
        p.write_text(json.dumps(data))
    else:
        p = tmp_path / "cfg.toml"
        p.write_text('checkpoint_dir = "ck"\n[flow]\ndim = 2\n'
                     'stages = ["scale_shift", "householder"]\n'
                     '[train]\nnepochs = 3\n')
    return str(p)


@pytest.mark.parametrize("fmt", ["json", "toml"])
def test_config_load_and_overrides_match_jax(tmp_path, fmt):
    path = _write_config(tmp_path, fmt)
    ov = ["--train.learning_rate=0.5", "--sampler.num_chains=4",
          "--sampler.precondition_kind=spline", "--metrics_path=m.jsonl"]
    cfg = TU.load_config(path, ov)
    assert cfg.flow.dim == 2 and cfg.train.nepochs == 3
    assert cfg.train.learning_rate == 0.5 and cfg.sampler.num_chains == 4
    assert cfg.checkpoint_dir == "ck" and cfg.metrics_path == "m.jsonl"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JU.load_config(path, ov))
    assert dataclasses.asdict(TU.load_config()) == dataclasses.asdict(
        JU.load_config())
    with pytest.raises(ValueError):
        TU.load_config(path, ["--no.such.key=1"])
    with pytest.raises(ValueError):
        TU.load_config(path, ["--train.nepochs"])


BUILD_CASES = {
    "default_1d": ["--flow.dim=1"],
    "default_3d": ["--flow.dim=3"],
    "householder": ["--flow.dim=2",
                    '--flow.stages=["scale_shift", "householder", '
                    '"center_stretch", "johnson"]',
                    "--flow.householder_reflections=3"],
    "coupling_spline": ["--flow.dim=4",
                        '--flow.stages=["coupling", "reverse", '
                        '"spline_coupling"]',
                        "--flow.coupling_hidden=[8]",
                        "--flow.coupling_bins=4"],
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_flow_matches_jax(case):
    """The port's stages are JAX's (types in order, every deterministic
    parameter equal); with JAX's random weights carried across by
    ``interop``, the forward pass and ladj equal JAX's to 1e-12."""
    ov = BUILD_CASES[case] + ["--flow.dtype=float64"]
    jflow = JU.build_flow(JU.load_config(None, ov).flow)
    tflow = TU.build_flow(TU.load_config(None, ov).flow, device="cpu")
    carried = from_jax(jflow, device="cpu")
    assert [type(s).__name__ for s in tflow.stages] == \
        [type(s).__name__ for s in carried.stages]
    assert all(p.dtype == T64 and p.device.type == "cpu"
               for p in tflow.parameters())
    for s, c in zip(tflow.stages, carried.stages):
        if not isinstance(s, (et.Householder, et.AffineCoupling,
                              et.RQSplineCoupling)):
            _leaves_equal(list(s.parameters()), list(c.parameters()))
    assert tflow.state_dict().keys() == carried.state_dict().keys()
    tflow.load_state_dict(carried.state_dict())
    dim = jflow.stages[0].a.shape[0] if hasattr(jflow.stages[0], "a") \
        else TU.load_config(None, ov).flow.dim
    x = np.random.default_rng(1).normal(size=(6, dim))
    jy, jl = jflow.forward_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        ty, tl = tflow.forward_and_ladj(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12,
                               atol=1e-12)


def test_build_flow_identity_init():
    """tests/test_utils.py:158-176: a finite round trip, and zero-init
    couplings exactly the identity up to the reversal."""
    flow = TU.build_flow(TU.load_config(None, ["--flow.dim=3"]).flow,
                         device="cpu")
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, ladj = flow.forward_and_ladj(x)
        assert y.shape == (5, 3) and ladj.shape == (5,)
        np.testing.assert_allclose(flow.inverse()(y).numpy(), x.numpy(),
                                   atol=1e-4)
        cflow = TU.build_flow(TU.load_config(
            None, BUILD_CASES["coupling_spline"]).flow, device="cpu")
        x = torch.randn(6, 4, generator=torch.Generator().manual_seed(1))
        y, ladj = cflow.forward_and_ladj(x)
        np.testing.assert_allclose(cflow.inverse()(y).numpy(), x.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(ladj.numpy(), 0.0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown stage kind"):
        TU.build_flow(TU.FlowConfig(stages=["nope"]), device="cpu")


def test_mesh_config_waits_for_a10():
    """``MeshConfig`` builds a mesh since ROADMAP A.10 (the name is the
    one the test had while it raised): none for ``axes = {}``, a mesh of
    the world for axes that cover it, a ``ValueError`` for axes that do
    not (two ranks asked of one process)."""
    from enflows_tpu_torch.utils.config import mesh_from_config

    assert mesh_from_config(TU.load_config(), "cpu") is None
    mesh = mesh_from_config(TU.load_config(
        None, ['--mesh.axes={"batch": 1}']), "cpu")
    assert mesh.shape == {"batch": 1} and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="do not cover"):
        mesh_from_config(TU.load_config(
            None, ['--mesh.axes={"chains": 2}']), "cpu")


def test_resolve_target_and_load_array(tmp_path):
    from enflows_tpu_torch.utils.config import load_array, resolve_target

    fn = resolve_target("numpy:linalg.norm")
    assert fn([3.0, 4.0]) == 5.0
    mod = tmp_path / "mytarget.py"
    mod.write_text("def logp(q):\n    return -0.5 * (q * q).sum()\n"
                   "scale = 2.0\n")
    assert float(resolve_target(f"{mod}:logp")(torch.ones(2))) == -1.0
    with pytest.raises(ValueError):
        resolve_target("no_colon_spec")
    with pytest.raises(TypeError):
        resolve_target(f"{mod}:scale")
    X = np.arange(6.0).reshape(3, 2)
    np.savez(tmp_path / "a.npz", other=X + 1, X=X)
    np.save(tmp_path / "b.npy", X)
    np.testing.assert_array_equal(load_array(str(tmp_path / "a.npz")), X)
    np.testing.assert_array_equal(load_array(str(tmp_path / "b.npy")), X)


# ---------------------------------------------------------------------------
# Profiling (tests/test_utils.py:224-240, :371-444).

def test_profiling_utils(tmp_path):
    with TU.trace(None) as prof:
        assert prof is None
    with TU.trace(str(tmp_path / "prof")):
        with TU.annotate("test_region"):
            torch.ones(8) * 2
    (path,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert "test_region" in open(path).read()
    timer = TU.StepTimer().start()
    x = torch.ones(8)
    for _ in range(5):
        x = x * 2
        timer.tick()
    assert timer.rate(sync_on=x) > 0 and timer.rate() > 0


def _tiny_runs():
    gen = lambda: torch.Generator().manual_seed(0)
    gauss = lambda q: -0.5 * ((q - 1.0) ** 2).sum(-1)
    X = torch.from_numpy(_data(256))
    return {
        "whitening": (lambda: et.optimize_whitening(
            X, _scale_shift(), nbatches=2, nepochs=2),
            ["enflows.train.whitening"]),
        "vi": (lambda: et.optimize_elbo(
            _tlogp, _scale_shift(), dim=2, batch_size=8, nsteps=2,
            key=gen(), dtype=T64), ["enflows.train.vi"]),
        "smc": (lambda: et.smc.smc_sample(gauss, gen(), dim=2,
                                          num_particles=128),
                ["enflows.smc.ladder", "enflows.smc.tempering",
                 "enflows.smc.resample", "enflows.smc.mutate"]),
        "nuts": (lambda: et.mcmc.sample(gauss, gen(), dim=2, num_chains=4,
                                        num_warmup=3, num_samples=2,
                                        device="cpu"),
                 ["enflows.mcmc.warmup", "enflows.mcmc.sampling",
                  "enflows.mcmc.nuts_transition"]),
        "chees": (lambda: et.mcmc.sample(gauss, gen(), dim=2, num_chains=4,
                                         num_warmup=3, num_samples=2,
                                         algorithm="chees", device="cpu"),
                  ["enflows.mcmc.chees_warmup",
                   "enflows.mcmc.chees_sampling"]),
    }


@pytest.mark.parametrize("run", ["whitening", "vi", "smc", "nuts", "chees"])
def test_trace_shows_named_ranges(tmp_path, run):
    """A captured trace carries JAX's scope names on the port's stages."""
    fn, names = _tiny_runs()[run]
    logdir = str(tmp_path / "prof")
    with TU.trace(logdir):
        fn()
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    events = json.load(open(path))["traceEvents"]
    seen = {e.get("name") for e in events}
    for name in names:
        assert name in seen, f"missing {name} in the captured trace"


# ---------------------------------------------------------------------------
# No JAX in the new modules (tests/test_torch_mcmc.py:518).

NEW_MODULES = ("utils/__init__.py", "utils/checkpoint.py", "utils/config.py",
               "utils/debugging.py", "utils/metrics.py",
               "utils/profiling.py", "utils/pytree.py",
               "utils/resilience.py", "cli.py",
               "distributions/johnson_su.py", "bijectors/johnson.py")


def test_new_modules_import_no_jax():
    code = ("import sys; import enflows_tpu_torch.utils, "
            "enflows_tpu_torch.cli, enflows_tpu_torch.distributions; "
            "bad = [m for m in sys.modules if m in ('jax', 'triton', "
            "'enflows_tpu') or m.startswith(('jax.', 'enflows_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    for rel in NEW_MODULES:
        src = open(os.path.join(ROOT, "enflows_tpu_torch", rel)).read()
        assert "import jax" not in src and "from jax" not in src, rel
        assert "enflows_tpu." not in src.replace("enflows_tpu_torch", ""), \
            rel
