"""tpusvm_torch and chip_smoke.py import neither jax nor the JAX package,
and the port's entry points never fall back to the CPU on their own."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "tpusvm_torch"


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax_or_tpusvm():
    code = f"""
import sys
sys.modules["jax"] = None  # any import of jax now raises
import importlib
for name in {_modules()!r} + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "tpusvm" or m.startswith("tpusvm.") or m == "jax"
                  or m.startswith("jax.")))
print("LOADED", bad)
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_ast_has_no_jax_or_tpusvm_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpusvm"), (path, name)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    from tpusvm_torch.convert import solver_state_from_numpy
    from tpusvm_torch.models.svm import BinarySVC
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    X = np.random.default_rng(0).random((20, 3)).astype(np.float32)
    Y = np.tile([1, -1], 10).astype(np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BinarySVC().fit(X, Y)
    with pytest.raises(RuntimeError, match="--device cpu"):
        blocked_smo_solve(X, Y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver_state_from_numpy(np.zeros(20))


def test_pair_and_task_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC
    from tpusvm_torch.solver.smo import smo_solve, smo_solve_batched

    X = np.random.default_rng(0).random((20, 3)).astype(np.float32)
    Y = np.tile([1, -1], 10).astype(np.int32)
    for call in (lambda: smo_solve(X, Y),
                 lambda: smo_solve_batched(X, Y[None]),
                 lambda: EpsilonSVR().fit(X, Y.astype(float)),
                 lambda: OneVsRestSVC().fit(X, np.arange(20) % 3),
                 lambda: BinarySVC(solver="pair").fit(X, Y)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd is tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, cwd=cwd, env=env, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
