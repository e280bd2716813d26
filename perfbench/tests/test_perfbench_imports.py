"""No module the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program either. Names compare whole, by
their top-level part: ``qldpc_tpu_torch`` begins with ``qldpc_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
JAX = {"jax", "jaxlib", "flax", "qldpc_tpu"}
PROGRAM = {"qldpc_tpu_torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize(
    "path", sorted(BENCH.rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_sources(path):
    found = top_level_imports(path)
    assert not found & JAX
    if "reference" in path.parts:
        assert not found & PROGRAM
        assert found <= {"__future__", "itertools", "numpy", "torch"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, timeout=600, check=True).stdout.split("\n")[-2]
    return set(out.split())


def test_a_run_loads_no_jax():
    loaded = _loaded("import sys; sys.path.insert(0, 'perfbench/tests')\n"
                     "import helpers; helpers.run()")
    assert "qldpc_tpu_torch" in loaded
    assert not loaded & JAX


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import perfbench.reference.decode")
    assert not loaded & (JAX | PROGRAM)
