"""Run utilities: checkpoint/resume (with per-rank shard files), the
checkpointed step loop and its heartbeat (an all-reduce across the ranks),
metrics streams (a file a rank), profiler ranges, NaN guards, the
cross-rank replication check and run configs.

Counterpart of ``enflows_tpu/utils/``; ``use_orbax`` and the compilation
cache have no counterpart.
"""
from .pytree import param_dtype, tree_leaves
from .checkpoint import (Shard, save_checkpoint, restore_checkpoint,
                         latest_step)
from .metrics import MetricsLogger
from .config import (
    FlowConfig, TrainConfig, SamplerConfig, MeshConfig, RunConfig,
    load_config, build_flow,
)
from .profiling import trace, annotate, StepTimer
from .resilience import (HeartbeatTimeout, run_checkpointed, run_chunked,
                         heartbeat)
from .debugging import (nan_guard, assert_finite,
                        assert_replicated_consistent)

__all__ = [
    "param_dtype", "tree_leaves",
    "Shard", "save_checkpoint", "restore_checkpoint", "latest_step",
    "MetricsLogger",
    "FlowConfig", "TrainConfig", "SamplerConfig", "MeshConfig", "RunConfig",
    "load_config", "build_flow",
    "trace", "annotate", "StepTimer",
    "HeartbeatTimeout", "run_checkpointed", "run_chunked", "heartbeat",
    "nan_guard", "assert_finite", "assert_replicated_consistent",
]
