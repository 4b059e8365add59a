"""The port stands alone: no module of parc_torch, and not chip_smoke.py,
imports JAX, flax, optax, orbax or anything of parc_tpu (found by an AST
scan of every import statement, including ones inside functions)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "parc_tpu")
FILES = sorted(ROOT.glob("parc_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    assert len(FILES) > 30
    for module in ("physics/substep.py", "learning/ppo.py",
                   "learning/distributions.py", "learning/rl_util.py",
                   "learning/diagnostics.py", "utils/checkpoint.py",
                   "utils/logger.py", "utils/profiling.py",
                   "pipeline/cli.py", "pipeline/train_tracker.py",
                   "pipeline/record.py", "pipeline/dataset.py"):
        assert (ROOT / "parc_torch" / module) in FILES, module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_parc_tpu_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
