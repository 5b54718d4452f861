"""The harness fails, with no result, where it cannot measure: with no
card (it does not fall back to the CPU), and in a directory that holds only
BENCHMARK.json and the benchmark's files."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "coupling_affine_d64.eval", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_bare_directory_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
