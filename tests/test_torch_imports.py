"""Import guard for the port: the card's machine has torch, numpy, scipy,
einops, pytest and hypothesis, and no jax, flax, optax, yaml, wandb or
matplotlib.

Every module of nonode_tpu_torch, chip_smoke.py and the port's profiling
scripts are scanned: no jax, no
module of the JAX package nonode_tpu, and flax, optax, yaml, wandb and
matplotlib only inside a function (imported lazily, when asked for). Then
the entry points and the mocap modules are imported, and the sweep, report
and mocap CLIs print their help, in a fresh interpreter with those
packages blocked.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "nonode_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_serving.py",
    REPO / "scripts" / "profile_torch_training.py",
    REPO / "scripts" / "profile_torch_stretch.py",
    REPO / "scripts" / "time_pairwise_kernels.py"]
LAZY_ONLY = {"flax", "optax", "yaml", "wandb", "matplotlib"}


def _imports(tree):
    """(module name, lazy?) for every import; lazy means inside a function,
    so that importing the module does not run it."""
    def visit(node, in_function):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, in_function
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, in_function
        inner = in_function or isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            yield from visit(child, inner)
    yield from visit(tree, False)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_only_lazy_optional_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, lazy in _imports(tree):
        root = name.split(".")[0]
        assert root != "jax", f"{path}: imports {name}"
        assert root != "nonode_tpu", f"{path}: imports {name}"
        if root in LAZY_ONLY:
            assert lazy, f"{path}: imports {name} outside a function"


def test_main_imports_with_jax_and_friends_blocked():
    blocked = ["jax", "jaxlib", "flax", "optax", "yaml", "wandb", "nonode_tpu"]
    code = ("import sys\n"
            f"for m in {blocked!r}:\n"
            "    sys.modules[m] = None\n"
            "import nonode_tpu_torch.main\n"
            "import nonode_tpu_torch.motion_main\n"
            "import nonode_tpu_torch.data.amc\n"
            "import nonode_tpu_torch.ops.kernels\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["nonode_tpu_torch.parallel.sweep",
                                    "nonode_tpu_torch.analysis.registry",
                                    "nonode_tpu_torch.motion_main"])
def test_cli_help_runs_with_jax_and_friends_blocked(module):
    blocked = ["jax", "jaxlib", "flax", "optax", "yaml", "wandb",
               "matplotlib", "nonode_tpu"]
    code = ("import runpy, sys\n"
            f"for m in {blocked!r}:\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['x', '--help']\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")


def test_no_file_of_the_port_is_git_ignored():
    """A checkout holds only what git commits: an ignore rule that matches a
    module of the port (``data/`` matches ``nonode_tpu_torch/data/``) would
    leave it out of every checkout, though the tests here still find it."""
    files = [str(p.relative_to(REPO)) for p in SOURCES]
    files += [str(p.relative_to(REPO))
              for d in ("csrc", "configs")
              for p in (REPO / "nonode_tpu_torch" / d).iterdir()]
    out = subprocess.run(["git", "check-ignore", "--no-index", "--", *files],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    if out.returncode == 128:
        pytest.skip(f"not a git checkout: {out.stderr.strip()}")
    assert out.returncode == 1, f"git ignores: {out.stdout.split()}"
