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


def test_checkpoint_shrink_and_csv_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    from tpusvm_torch.cli import main
    from tpusvm_torch.data import write_csv
    from tpusvm_torch.models.svm import BinarySVC
    from tpusvm_torch.solver.checkpoint import checkpointed_blocked_solve
    from tpusvm_torch.solver.shrink import shrinking_blocked_solve

    X = np.random.default_rng(0).random((20, 3)).astype(np.float32)
    Y = np.tile([1, -1], 10).astype(np.int32)
    csv = str(tmp_path / "a.csv")
    write_csv(csv, X, Y)
    ck = str(tmp_path / "ck.npz")
    for call in (lambda: checkpointed_blocked_solve(X, Y, checkpoint_path=ck),
                 lambda: shrinking_blocked_solve(X, Y),
                 lambda: BinarySVC().fit(X, Y, checkpoint_path=ck),
                 lambda: BinarySVC(solver_opts=dict(shrink_every=2)).fit(X, Y),
                 lambda: main(["train", "--train", csv, "--test", csv]),
                 lambda: main(["train", "--train", csv, "--checkpoint", ck])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "ck.npz").exists()


@pytest.mark.parametrize("pkg", ["stream", "approx", "faults", "obs", "pod",
                                 "faults.__main__", "tune", "parallel.mesh",
                                 "data.native_io", "serve", "serve.http",
                                 "serve.refresh", "serve.watch",
                                 "obs.fleet", "stream.append", "autopilot",
                                 "tenants", "router", "obs.trace",
                                 "router.proxy", "obs.report", "obs.prof",
                                 "obs.costs", "obs.benchdiff",
                                 "utils.logging", "utils.timing"])
def test_new_tiers_import_alone_without_jax_or_tpusvm(pkg):
    # each tier in a fresh interpreter, alone: what it pulls in is its own
    code = f"""
import sys
sys.modules["jax"] = None
import tpusvm_torch.{pkg}
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "tpusvm" or m.startswith("tpusvm.") or m == "jax"
                  or m.startswith("jax.")))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def test_stream_and_approx_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    from tpusvm_torch.approx import build_map, kernel_approx_error
    from tpusvm_torch.cli import main
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models.svm import BinarySVC
    from tpusvm_torch.stream import ingest_arrays, open_dataset

    X = np.random.default_rng(0).random((40, 3))
    Y = np.tile([1, -1], 20).astype(np.int32)
    d = str(tmp_path / "d")
    ingest_arrays(d, X, Y, rows_per_shard=16)  # the host tier needs no card
    ds = open_dataset(d)
    rff = SVMConfig(kernel="rff", rff_dim=128)
    fmap = build_map(rff, n_features=3)
    for call in (lambda: BinarySVC().fit_stream(ds),
                 lambda: BinarySVC(rff).fit_stream(ds),
                 lambda: BinarySVC(rff).fit(X, Y),
                 lambda: BinarySVC().fit_cascade_stream(ds),
                 lambda: fmap.transform_np(X),
                 lambda: kernel_approx_error(X, fmap, 1.0),
                 lambda: main(["train", "--data", d]),
                 lambda: main(["train", "--data", d, "--kernel", "nystrom",
                               "--landmarks", "128"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_pod_workers_run_without_jax_or_tpusvm(tmp_path, monkeypatch):
    # every worker process starts under a guard that makes jax and the JAX
    # package unimportable: a worker that imported either would die, and
    # the fit with it
    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.pod import pod_fit
    from tpusvm_torch.stream import ingest_arrays

    guard = tmp_path / "guard.py"
    guard.write_text(
        "import runpy, sys\n"
        "sys.modules['jax'] = sys.modules['tpusvm'] = None\n"
        "assert sys.argv[1] == '-m', sys.argv\n"
        "sys.argv = [sys.argv[2]] + sys.argv[3:]\n"
        "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")
    python = tmp_path / "python"
    python.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{guard}" "$@"\n')
    python.chmod(0o755)
    X, Y = rings(n=64, seed=3)
    ds = str(tmp_path / "ds")
    ingest_arrays(ds, X, Y, rows_per_shard=16)
    monkeypatch.setattr(sys, "executable", str(python))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = pod_fit(ds, SVMConfig(C=10.0, gamma=10.0),
                      CascadeConfig(n_shards=2, sv_capacity=64),
                      device="cpu")
    finally:
        torch.set_num_threads(n)
    assert res.converged and sum(res.worker_rows) == 64


def test_class_axis_ranks_and_the_native_reader_run_without_jax_or_tpusvm(
        tmp_path):
    # two rank processes of `train --multiclass --class-parallel
    # --distributed` (the CSV through the native reader) start under a
    # guard that makes jax and the JAX package unimportable
    from tpusvm_torch.data import write_csv

    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 2)) + np.repeat([[0, 0], [5, 0], [0, 5]], 20, 0)
    write_csv(str(tmp_path / "a.csv"), X, np.repeat([0, 1, 2], 20))
    guard = ("import runpy, sys; sys.modules['jax'] = sys.modules['tpusvm'] "
             "= None; sys.argv[0] = 'tpusvm_torch'; "
             "runpy.run_module('tpusvm_torch', run_name='__main__', "
             "alter_sys=True)")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = ["train", "--train", "a.csv", "--C", "10", "--gamma", "1",
            "--multiclass", "--class-parallel", "--distributed",
            "--coordinator-address", f"file://{tmp_path / 'store'}",
            "--num-processes", "2", "--device", "cpu"]
    procs = [subprocess.Popen([sys.executable, "-c", guard, *argv,
                               "--process-id", str(r)], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "status = ['CONVERGED', 'CONVERGED', 'CONVERGED']" in outs[0][0]


def test_serve_subprocess_runs_without_jax_or_tpusvm(tmp_path):
    # `serve --smoke` and `swap-chaos-smoke` start under a guard that makes
    # jax and the JAX package unimportable: an import of either would fail
    # the command
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for mod, argv, line in (
            ("tpusvm_torch", ["serve", "--smoke", "--smoke-threads", "2",
                              "--smoke-requests", "4"], "bit-equal"),
            ("tpusvm_torch.faults", ["swap-chaos-smoke"],
             "swap chaos smoke ok")):
        guard = ("import runpy, sys; sys.modules['jax'] = "
                 "sys.modules['tpusvm'] = None; "
                 f"sys.argv[0] = {mod!r}; "
                 f"runpy.run_module({mod!r}, run_name='__main__', "
                 "alter_sys=True)")
        out = subprocess.run([sys.executable, "-c", guard, *argv, "--device",
                              "cpu"], capture_output=True, text=True,
                             cwd=tmp_path, env=env, timeout=120)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        assert line in out.stdout
