"""Numerical-safety guards.

PyTorch counterpart of ``enflows_tpu/utils/debugging.py`` for one device:
``assert_finite`` raises ``ValueError`` on NaN/Inf in any floating leaf, as
JAX's ``checkify`` error surfaces; ``nan_guard`` wraps a function so that
its outputs are checked. Each check reads one flag a floating leaf back to
the host. ``assert_replicated_consistent`` compares shards across devices
and waits for the multi-device port (ROADMAP A.10).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .pytree import tree_leaves


def assert_finite(x: Any, name: str = "value") -> None:
    """Raise ``ValueError`` naming ``name`` and the leaf's index if a
    floating tensor leaf of ``x`` holds NaN or Inf."""
    for i, leaf in enumerate(tree_leaves(x)):
        if isinstance(leaf, torch.Tensor) and (
                leaf.is_floating_point() or leaf.is_complex()):
            if not bool(torch.isfinite(leaf).all()):
                raise ValueError(f"non-finite values in {name} (leaf {i})")


def nan_guard(fn: Callable, name: str = "output") -> Callable:
    """``fn`` with every output leaf checked by ``assert_finite``."""

    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name)
        return out

    return checked
