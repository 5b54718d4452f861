"""Every file BENCHMARK.json names loads, and the metrics are consistent."""
import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.runners.stack import PRODUCTS

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads(workload):
    cell = harness.load_cell(workload)
    assert (ROOT / "portbench" / "runners"
            / f"{cell['traffic']['runner']}.py").exists()
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and cell["traffic"]["rate_metric"] in names
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]))
    assert cell["params"].get("limits"), "the cell's limits are set"


def test_configs_hold_their_entries():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["products"] in PRODUCTS
        assert c["file"].startswith("portbench/")


def test_every_metric_file_is_named():
    named = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert files == named


def test_metrics_move_what_their_cells_report():
    for m in SPEC["per_layer"]:
        e2e = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
        for w in m["workloads"]:
            assert w in e2e.get("workloads", CELLS), (m["name"], w)
