"""The card's published peaks, and the operations and bytes a call needs,
computed from the configuration's shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates, at the 700 W
power limit. The roofline of a call is the larger of its operations over
the TF32 tensor-core rate and its bytes over the memory rate, each input
and output counted once. Only the conditioner products are counted as
operations: they are all of a coupling stack's tensor-core work, and the
highest rate float32 with TF32 products allows bounds every precision the
configuration allows.
"""
from __future__ import annotations

from .inputs import conditioner_sizes

TF32_FLOP_PER_S = 495e12        # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12       # HBM3
F32_BYTES = 4


def conditioner_layers(cfg: dict) -> list[tuple[int, int]]:
    """(fan_in, fan_out) of every conditioner layer of the stack."""
    sizes = conditioner_sizes(cfg)
    return list(zip(sizes[:-1], sizes[1:])) * cfg["n_layers"]


def forward_flops_per_row(cfg: dict) -> int:
    """Multiply-add FLOPs of one row's conditioner products (h @ W)."""
    return 2 * sum(k * n for k, n in conditioner_layers(cfg))


def weight_bytes(cfg: dict) -> int:
    """Bytes of every conditioner W and b, float32."""
    return F32_BYTES * sum(k * n + n for k, n in conditioner_layers(cfg))


def b4_flops(cfg: dict, rows: int) -> int:
    """The forward of the stack over ``rows`` rows."""
    return forward_flops_per_row(cfg) * rows


def b4_bytes(cfg: dict, rows: int) -> int:
    """x read, y and the per-row ladj written, the weights read once."""
    d = cfg["dim"]
    return F32_BYTES * rows * (2 * d + 1) + weight_bytes(cfg)


def b5_flops(cfg: dict, rows: int) -> int:
    """The backward's products: each layer's input cotangent (g W^T) and
    its weight gradient (h^T g), twice the forward's."""
    return 2 * b4_flops(cfg, rows)


def b5_bytes(cfg: dict, rows: int) -> int:
    """x, the output cotangents gy and gl read, gx written; the weights
    read and their gradients written once."""
    d = cfg["dim"]
    return F32_BYTES * rows * (3 * d + 1) + 2 * weight_bytes(cfg)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the call."""
    return max(flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The call's bound as a share of its measured time, in %."""
    return 100.0 * bound_s(flops, nbytes) / seconds


def mfu_pct(flops: float, seconds: float) -> float:
    """Operations over the TF32 peak for ``seconds``, in %."""
    return 100.0 * flops / (TF32_FLOP_PER_S * seconds)
