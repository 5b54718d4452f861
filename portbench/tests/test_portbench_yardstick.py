"""Operations and bytes computed from the configurations' shapes."""
import json
from pathlib import Path

import pytest

from portbench import yardstick as Y

CONF = Path(__file__).resolve().parents[1] / "configs"
AFFINE = json.loads((CONF / "coupling_affine_d64.json").read_text())
SPLINE = json.loads((CONF / "coupling_spline_d64.json").read_text())


@pytest.mark.parametrize("cfg,flops,weights", [
    # 4 x 2 (32 x 512 + 512 x 512 + 512 x 64); weights and biases, f32
    (AFFINE, 2_490_368, 4 * 4 * (311_296 + 512 + 512 + 64)),
    # the last layer 512 -> 32 x (3 x 8 - 1) = 736
    (SPLINE, 5_242_880, 4 * 4 * (655_360 + 512 + 512 + 736)),
])
def test_flops_and_bytes(cfg, flops, weights):
    assert Y.forward_flops_per_row(cfg) == flops
    assert Y.weight_bytes(cfg) == weights
    rows = 1 << 17
    assert Y.b4_bytes(cfg, rows) == 4 * rows * 129 + weights
    assert Y.b5_bytes(cfg, rows) == 4 * rows * 193 + 2 * weights
    assert Y.b5_flops(cfg, rows) == 2 * flops * rows


def test_affine_b4_is_bound_by_operations():
    rows = 1 << 17
    # 326.4 GFLOP at 495 TFLOP/s: 0.659 ms, against 67 MB at 3.35 TB/s
    assert Y.bound_s(Y.b4_flops(AFFINE, rows), Y.b4_bytes(AFFINE, rows)) \
        == pytest.approx(326.4e9 / 495e12, rel=1e-3)
    assert Y.roofline_pct(1e12, 0, 1.0) == pytest.approx(100 / 495)
    assert Y.mfu_pct(495e12, 2.0) == pytest.approx(50.0)
