"""Failure detection and recovery: a checkpointed step loop and a liveness
probe with a real deadline.

PyTorch counterpart of ``enflows_tpu/utils/resilience.py``.
``run_checkpointed`` resumes from the latest checkpoint after a crash (a
resumed run is bit-identical to an uninterrupted one when the step is
deterministic given its state and index), and ``run_chunked`` drives a
trainer's loop through it in chunks. ``heartbeat`` runs a probe on
the device in a watchdog thread and reports a hang as False at its
deadline instead of blocking.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .profiling import synchronize
from .pytree import tree_leaves


class HeartbeatTimeout(RuntimeError):
    """The liveness probe did not complete within its deadline: a device is
    dead or hung. The raiser has already tried to save the latest state;
    restart the job and ``run_checkpointed`` resumes from it."""


def _state_device(state) -> torch.device:
    """The device of the first tensor leaf of ``state``, else the card."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cuda")


def run_checkpointed(step_fn: Callable, state: Any, num_steps: int, *,
                     ckpt_dir: Optional[str] = None,
                     checkpoint_every: int = 100,
                     resume: bool = True,
                     on_step: Optional[Callable] = None,
                     heartbeat_every: Optional[int] = None,
                     heartbeat_timeout_s: float = 60.0,
                     _heartbeat_fn: Optional[Callable] = None):
    """Run ``state = step_fn(state, i)`` for i in [0, num_steps), saving
    every ``checkpoint_every`` steps and at the end, and resuming from the
    latest saved step if ``resume`` and a checkpoint exists
    (``enflows_tpu/utils/resilience.py:30-93``). ``state`` is what
    ``save_checkpoint`` takes; on resume the restored state (laid out as
    ``state``) is what ``step_fn`` receives.

    ``heartbeat_every``: every N steps, run :func:`heartbeat` on the device
    of ``state``'s first tensor with the deadline ``heartbeat_timeout_s``.
    On failure the last completed step is saved under its own deadline and
    :class:`HeartbeatTimeout` raised. ``_heartbeat_fn(timeout_s) -> bool``
    replaces the probe (fault injection in tests).

    Returns (state, start_step_used).
    """
    device = _state_device(state)
    hb = _heartbeat_fn if _heartbeat_fn is not None else \
        lambda timeout_s: heartbeat(timeout_s, device=device)
    start = 0
    if ckpt_dir and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, state, step=last)
            start = last
    for i in range(start, num_steps):
        state = step_fn(state, i)
        done = i + 1
        if ckpt_dir and (done % checkpoint_every == 0 or done == num_steps):
            save_checkpoint(ckpt_dir, state, step=done)
        if heartbeat_every and done % heartbeat_every == 0:
            if not hb(heartbeat_timeout_s):
                rescued = False
                if ckpt_dir:
                    # The save waits for the device, which may be the hung
                    # part, so it runs under its own deadline too.
                    rescued = _run_with_deadline(
                        lambda: save_checkpoint(ckpt_dir, state, step=done),
                        heartbeat_timeout_s)
                raise HeartbeatTimeout(
                    f"liveness probe failed/timed out after step {done} "
                    f"(deadline {heartbeat_timeout_s}s); rescue checkpoint "
                    + ("saved" if rescued else
                       "NOT saved (state unready within deadline - resume "
                       "from the last periodic checkpoint)"))
        if on_step is not None:
            on_step(i, state)
    return state, start


class _LiveState:
    """What a chunked trainer hands ``run_checkpointed``: the live modules'
    ``state_dict()`` s, the history buffer and, for VI, the draws'
    generator state. ``sync`` loads a state that ``run_checkpointed``
    restored into the live objects."""

    def __init__(self, flow, opt, history, generator=None):
        self.flow, self.opt = flow, opt
        self.history, self.generator = history, generator
        self.current = self.advanced()

    def advanced(self) -> dict:
        """The live state, after a chunk."""
        self.current = {"flow": self.flow.state_dict(),
                        "opt_state": self.opt.state_dict(),
                        "history": self.history}
        if self.generator is not None:
            self.current["generator"] = self.generator.get_state()
        return self.current

    def sync(self, state) -> None:
        if state is self.current:
            return
        self.flow.load_state_dict(state["flow"])
        self.opt.load_state_dict(state["opt_state"])
        self.history.copy_(state["history"])
        if self.generator is not None:
            self.generator.set_state(state["generator"])
        self.current = state


def run_chunked(run: Callable, flow: torch.nn.Module,
                opt: torch.optim.Optimizer, history: torch.Tensor,
                units: int, steps_per_unit: int, *,
                every: Optional[int] = None, ckpt_dir: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A trainer's loop: ``run(u0, u1)`` (the losses of units [u0, u1), 0-d
    tensors, ``steps_per_unit`` a unit) over units [0, ``units``) in chunks
    of ``every`` units through ``run_checkpointed``, each chunk's losses
    copied into ``history`` at their steps. Each chunk's end saves the
    flow's and the optimizer's ``state_dict()``, the history and the
    ``generator``'s state under ``ckpt_dir``, and a run called again the
    same way resumes from the last one. ``every`` None is one chunk (one a
    unit with a ``ckpt_dir``, as the JAX trainers' default). Returns
    ``history``."""
    chunk = int(every or (1 if ckpt_dir else max(units, 1)))
    live = _LiveState(flow, opt, history, generator)

    def chunk_fn(state, ci):
        live.sync(state)
        u0, u1 = ci * chunk, min(units, (ci + 1) * chunk)
        losses = run(u0, u1)
        if losses:
            history[u0 * steps_per_unit:u1 * steps_per_unit] = \
                torch.stack(losses)
        return live.advanced()

    state, _ = run_checkpointed(chunk_fn, live.current, -(-units // chunk),
                                ckpt_dir=ckpt_dir, checkpoint_every=1)
    live.sync(state)
    return history


def _run_with_deadline(fn: Callable[[], None], timeout_s: float) -> bool:
    """Run ``fn()`` in a daemon thread, waiting at most ``timeout_s``.
    True iff it completed without raising. A timed-out thread is left
    parked: a hang inside the runtime cannot be cancelled."""
    result: dict = {}

    def _work():
        try:
            fn()
            result["ok"] = True
        except Exception:
            result["ok"] = False

    th = threading.Thread(target=_work, daemon=True, name="enflows-rescue")
    th.start()
    th.join(timeout_s)
    return (not th.is_alive()) and result.get("ok", False)


def _default_probe(device) -> bool:
    """A one-element sum on ``device``, waited for, checked against the
    world size: 1 on one device, or the size of the initialized
    ``torch.distributed`` group, whose ``all_reduce`` it then runs. May
    block indefinitely on a dead device; always called under the
    watchdog."""
    device = torch.device(device)
    x = torch.ones(1, dtype=torch.float32, device=device)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(x)
        expected = dist.get_world_size()
    else:
        expected = 1
    total = x.sum()
    synchronize(total)
    return float(total) == float(expected)


def heartbeat(timeout_s: float = 60.0, *, device="cuda",
              _probe: Optional[Callable] = None) -> bool:
    """Liveness probe with a real deadline
    (``enflows_tpu/utils/resilience.py:154-182``): the probe (by default a
    one-element sum on ``device``, the card unless the caller asks for the
    CPU) runs in a watchdog thread, and this returns False once
    ``timeout_s`` elapses without it completing, whatever hangs. A wrong
    value, or a probe that raises, also gives False."""
    probe = _probe if _probe is not None else \
        lambda: _default_probe(device)
    result: dict = {}

    def _work():
        try:
            result["ok"] = bool(probe())
        except Exception:
            result["ok"] = False

    th = threading.Thread(target=_work, daemon=True,
                          name="enflows-heartbeat")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        return False
    return result.get("ok", False)
