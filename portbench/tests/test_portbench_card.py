"""On the card, at the cells' own sizes: a sound run is correct, and the
control (the program with bf16 conditioner products) is not, on three
seeds. ``python -m pytest portbench/tests -q -m card`` on a machine with
the card."""
import json
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_sound_and_control_on_the_card(workload, card):
    assert harness.run_cell(workload, 4_000_000_007, 1.0, False,
                            card)["correct"]
    for seed in (4_000_000_011, 4_000_000_013, 4_000_000_017):
        assert not harness.run_cell(workload, seed, 1.0, False, card,
                                    control=True)["correct"]
