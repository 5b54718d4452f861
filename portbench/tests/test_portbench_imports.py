"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmarks, and the reference imports nothing of the program. Top-level
names are compared whole: ``enflows_tpu_torch`` is not ``enflows_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]
PROGRAM = "enflows_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and "portbench" not in names


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import enflows_tpu_torch.ops\nfrom jaxtyping import x\n")
    assert not top_level_imports(f) & set(FORBIDDEN)
    f.write_text("from enflows_tpu.ops import y\n")
    assert top_level_imports(f) & set(FORBIDDEN) == {"enflows_tpu"}


def test_loading_every_module_loads_no_jax():
    """Every module of the benchmark, the runners and so the program with
    them, imported in a fresh process."""
    code = ("import sys, importlib, pathlib; sys.path.insert(0, %r)\n"
            "for p in sorted(pathlib.Path(%r).rglob('*.py')):\n"
            "    rel = p.relative_to(%r).with_suffix('')\n"
            "    if rel.parts[1] in ('tests', 'metrics') or rel.name == 'run':"
            " continue\n"
            "    importlib.import_module('.'.join(rel.parts))\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules())\n"
            % (str(BENCH.parent), str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
