"""What the benchmark loads: no module under ``h100_bench/`` imports a
module whose top-level name (the part before the first dot, compared
whole) is jax, jaxlib, flax, optax or nonode_tpu (``nonode_tpu_torch`` is
the program, and only its top-level name begins with ``nonode_tpu``);
nothing under ``h100_bench/reference/`` imports the program. Checked in
the sources, and in a fresh interpreter's ``sys.modules`` once the runner,
every mix, every metric reader and the reference are loaded."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "h100_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nonode_tpu"}


def _imported(path):
    """Top-level names a source imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted(HERE.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        assert not _imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        names = _imported(path)
        assert "nonode_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "torch"}, (path, names)


def test_the_loaded_modules_hold_no_forbidden_name():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = f"""
import sys
sys.modules['jax'] = None          # an import of it would raise
from h100_bench import run, calibrate
from h100_bench.reference import common, egno, segno
import nonode_tpu_torch.main, nonode_tpu_torch.fleet_main
for mix in {sorted({w['traffic'] for w in manifest['workloads']})!r}:
    run.mix_module(mix)
for m in {[m['name'] for m in manifest['per_layer']]!r}:
    run.metric_reader(m)
del sys.modules['jax']
print(run.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from h100_bench import run

    assert run.forbidden_loaded(["nonode_tpu_torch.main", "torch",
                                 "jaxtyping"]) == []
    assert run.forbidden_loaded(["nonode_tpu.models", "jax._src"]) == \
        ["jax", "nonode_tpu"]
