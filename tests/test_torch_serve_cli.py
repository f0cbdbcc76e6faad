"""The serving tier's command lines as subprocesses on the CPU: `serve
--smoke`, `refresh --smoke`, `python -m tpusvm_torch.faults
swap-chaos-smoke`, and `serve --port 0 --state` driven over HTTP with
`refresh --swap URL` into it. Each runs with one intra-op thread and a
deadline, so nothing can hang the suite."""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")


def _run(args, cwd, timeout=120):
    out = subprocess.run([sys.executable, "-m", *args, "--device", "cpu"],
                         capture_output=True, text=True, cwd=cwd, env=ENV,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("args,line", [
    (("tpusvm_torch", "serve", "--smoke"),
     "decision_function: bit-equal"),
    (("tpusvm_torch", "refresh", "--smoke"), "refresh smoke ok"),
    (("tpusvm_torch.faults", "swap-chaos-smoke"), "swap chaos smoke ok"),
])
def test_smoke_commands_exit_zero(args, line, tmp_path):
    assert line in _run(args, tmp_path)


def _get(url):
    with urllib.request.urlopen(url, timeout=30.0) as r:
        return r.status, r.read()


def test_serve_subprocess_http_then_refresh_swap(tmp_path):
    """`serve --port 0 --state` in a subprocess: POSTs of 1..8 rows equal
    the artifact's decision_function bit for bit, the state names the bound
    address, and `refresh --data DIR --swap URL` flips the served scores to
    the refreshed artifact's bits."""
    from tpusvm_torch.stream import ingest_arrays

    X, Y = rings(n=360, seed=11)
    deployed = str(tmp_path / "m.npz")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu").fit(
            X[:240], Y[:240])
    finally:
        torch.set_num_threads(n)
    model.save(deployed)
    ingest_arrays(str(tmp_path / "ds"), X, Y, rows_per_shard=128)
    state = tmp_path / "s.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpusvm_torch", "serve", "--model",
         f"m={deployed}", "--port", "0", "--state", str(state), "--max-batch",
         "8", "--device", "cpu"], cwd=tmp_path, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        deadline = time.monotonic() + 60.0
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-3000:]
            if line.startswith("serving on http://"):
                url = line.split()[2]
        assert url is not None
        assert json.loads(state.read_text())["address"] in url
        code, body = _get(f"{url}/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        want = np.asarray(model.decision_function(X[240:276]))
        i = 0
        for k in range(1, 9):
            req = urllib.request.Request(
                f"{url}/v1/models/m:predict",
                data=json.dumps({"instances": X[240 + i:240 + i + k]
                                 .tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30.0) as r:
                got = np.asarray(json.loads(r.read())["scores"], np.float32)
            assert got.tobytes() == want[i:i + k].tobytes()
            i += k
        out = _run(["tpusvm_torch", "refresh", "--model", deployed, "--data",
                    str(tmp_path / "ds"), "--save", str(tmp_path / "r.npz"),
                    "--swap", url, "--swap-name", "m"], tmp_path)
        assert "swapped m -> generation 2" in out
        fresh = BinarySVC.load(str(tmp_path / "r.npz"), device="cpu")
        req = urllib.request.Request(
            f"{url}/v1/models/m:predict",
            data=json.dumps({"instances": X[:16].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30.0) as r:
            got = np.asarray(json.loads(r.read())["scores"], np.float32)
        assert got.tobytes() == np.asarray(
            fresh.decision_function(X[:16])).tobytes()
        assert json.loads(state.read_text())["models"]["m"]["generation"] == 2
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
