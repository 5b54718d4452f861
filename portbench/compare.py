"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the reference works out, and is held to a limit
of its own, set in the cell's file from measured readings (PERF.md)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Check(NamedTuple):
    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return (self.limit is not None and math.isfinite(self.value)
                and self.value <= self.limit)


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float64; inf where got holds a
    non-finite value."""
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def leaf_gaps(got_norms, ref_norms, ref_grad_norms) -> torch.Tensor:
    """Relative gap between per-leaf norms: |got - ref| over the larger of
    the leaf's reference norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's read 0: they move
    by round-off alone. A non-finite norm reads inf."""
    got = torch.as_tensor(got_norms, dtype=torch.float64)
    ref = torch.as_tensor(ref_norms, dtype=torch.float64)
    rg = torch.as_tensor(ref_grad_norms, dtype=torch.float64)
    keep = rg >= 1e-3 * rg.median()
    gaps = (got - ref).abs() / torch.maximum(ref, ref[keep].median())
    gaps[~torch.isfinite(got)] = math.inf
    return torch.where(keep, gaps, torch.zeros_like(gaps))


def leaf_diff_gaps(got, ref, ref_grad_norms) -> torch.Tensor:
    """Per leaf, the norm of the difference |got - ref| over the larger of
    the leaf's reference norm and the median leaf's, the same leaves left
    out as in ``leaf_gaps``."""
    norms = torch.stack([r.double().norm() for r in ref]).cpu()
    diffs = torch.stack([(g.double() - r.double()).norm()
                         for g, r in zip(got, ref)]).cpu()
    rg = torch.as_tensor(ref_grad_norms, dtype=torch.float64)
    keep = rg >= 1e-3 * rg.median()
    gaps = diffs / torch.maximum(norms, norms[keep].median())
    gaps[~torch.isfinite(diffs)] = math.inf
    return torch.where(keep, gaps, torch.zeros_like(gaps))
