"""Run utilities for one device: checkpoint/resume, the checkpointed step
loop and its heartbeat, metrics streams, profiler ranges, NaN guards and
run configs.

Counterpart of ``enflows_tpu/utils/``; the multi-device pieces (sharded
checkpoints, ``use_orbax``, ``assert_replicated_consistent``) wait for
ROADMAP A.10, and the compilation cache has no counterpart.
"""
from .pytree import param_dtype, tree_leaves
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step
from .metrics import MetricsLogger
from .config import (
    FlowConfig, TrainConfig, SamplerConfig, MeshConfig, RunConfig,
    load_config, build_flow,
)
from .profiling import trace, annotate, StepTimer
from .resilience import (HeartbeatTimeout, run_checkpointed, run_chunked,
                         heartbeat)
from .debugging import nan_guard, assert_finite

__all__ = [
    "param_dtype", "tree_leaves",
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "MetricsLogger",
    "FlowConfig", "TrainConfig", "SamplerConfig", "MeshConfig", "RunConfig",
    "load_config", "build_flow",
    "trace", "annotate", "StepTimer",
    "HeartbeatTimeout", "run_checkpointed", "run_chunked", "heartbeat",
    "nan_guard", "assert_finite",
]
