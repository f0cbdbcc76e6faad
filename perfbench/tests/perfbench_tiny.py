"""Shared set-up of the benchmark's CPU tests (imported by them): tiny copies of the
configurations (the published shapes but for the rows and the working
set), and a benchmark description whose cells keep their names (so the
cells' own limits apply) and point at those copies."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"n": 700, "n_train": 600}
TINY_Q = 128



def write_tiny(root: Path) -> dict:
    """Tiny copies of every configuration under root/configs, and the
    benchmark whose cells use them."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((REPO / "perfbench" / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        cfg["name"] = "tiny_" + cfg["name"]
        cfg["data"].update(TINY)
        cfg["solver"]["opts"]["q"] = TINY_Q
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        w["config"] = "tiny_" + w["config"]
    return bench


def run_cell(search, bench, cell, seed=3000000001, seconds=0.5, trace=0):
    """One run of `cell` on the CPU, its parts looked for in `search` (a
    directory or a list of them) first; returns (exit code, the result
    line parsed, standard error)."""
    import contextlib
    import io

    from perfbench.core.runner import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  search=search if isinstance(search, list) else [search],
                  bench=bench)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("perfbench_tiny")
    return root, write_tiny(root)


@pytest.fixture
def cuda_device():
    """Skips a card-only test where no card is present (decided here,
    never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
