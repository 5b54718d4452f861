"""A whole run of each cell on the CPU at a small size, the look for a card
skipped: sound, it is correct; with the timed path broken underneath (a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced) and with the control's bf16
conditioner products, ``correct`` comes out false."""
import pytest

from portbench import faults, harness

# Small sizes for the CPU: every width and row count cut, the code paths
# those of the cells.
SMALL = {"config": {"dim": 8, "hidden": [16, 16]},
         "traffic": {"dataset_rows": 4096, "batch_rows": 256,
                     "chunk_batches": 2, "chains": 64, "trace_units": 2}}
SEED = 2_147_483_659
WHITEN = ["coupling_affine_d64.whiten", "coupling_spline_d64.whiten"]


def run(workload, **kw):
    return harness.run_cell(workload, SEED, 0.3, False, "cpu",
                            overrides=SMALL, **kw)


@pytest.mark.parametrize("workload", WHITEN + ["coupling_affine_d64.eval",
                                               "coupling_affine_d64.hmc"])
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("workload", WHITEN + ["coupling_affine_d64.eval",
                                               "coupling_affine_d64.hmc"])
def test_control_is_not_correct(workload):
    assert not run(workload, control=True)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(fault):
    workload = {"whiten": WHITEN[0], "eval": "coupling_affine_d64.eval",
                "hmc": "coupling_affine_d64.hmc"}[fault.split(".")[0]]
    with faults.planted(fault):
        assert not run(workload, units=3)["correct"]


# The spline cell's window loss is not compared (no reading separates a
# fault from round-off on the card), so a loss altered after the window's
# first chunk is not among its faults.
@pytest.mark.parametrize("fault", ["whiten.unchanged", "whiten.half",
                                   "whiten.altered", "whiten.half_late"])
def test_spline_fault_is_caught(fault):
    with faults.planted(fault):
        assert not run(WHITEN[1], units=3)["correct"]


@pytest.mark.parametrize("workload, fault", [
    (WHITEN[0], "whiten.half_late"), (WHITEN[0], "whiten.altered_late"),
    (WHITEN[1], "whiten.half_late")])
def test_late_fault_is_caught_in_the_window_alone(workload, fault):
    """A fault that starts after the window's first chunk passes every
    number of set-up's steps and fails one of the window's chunks."""
    with faults.planted(fault):
        r = run(workload, units=3)
    checks = {k: c["value"] <= c["limit"] for k, c in r["checks"].items()}
    assert all(ok for k, ok in checks.items()
               if not k.startswith("window_")), r["checks"]
    assert not r["correct"], r["checks"]
