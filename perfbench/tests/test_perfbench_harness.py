"""The benchmark harness on the CPU: the command at a tiny size, the
parts found by name (one added as a new file only), the result line,
the frozen copies against the port, the count functions against hand
arithmetic, and what the harness and the reference load."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from perfbench_tiny import REPO, run_cell, tiny  # noqa: F401

from perfbench.core import devtrace, registry
from perfbench.core.generate import mnist_like, mnist_like_multiclass

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("seed", [0, 587, 2**31 + 11])
def test_frozen_generator_equals_the_ports(seed):
    from tpusvm_torch.data import synthetic

    kw = dict(n=300, d=784, noise=30.0, seed=seed)
    X, Y = mnist_like(label_noise=0.005, **kw)
    Xp, Yp = synthetic.mnist_like(label_noise=0.005, **kw)
    assert np.array_equal(X, Xp) and np.array_equal(Y, Yp)
    X, L = mnist_like_multiclass(**kw)
    Xp, Lp = synthetic.mnist_like_multiclass(**kw)
    assert np.array_equal(X, Xp) and np.array_equal(L, Lp)


@pytest.mark.parametrize("task", ["binary", "ovr"])
def test_the_seed_orders_one_draw_of_rows(task):
    from perfbench.core.generate import make_data

    cfg = {"task": task, "data": {"n": 260, "n_train": 200, "d": 784,
                                  "n_classes": 10, "rank": 32, "seed": 587,
                                  "positive_class": 1, "noise": 30.0,
                                  "label_noise": 0.005}}
    y = "Y" if task == "binary" else "labels"
    a, b = make_data(cfg, 2**31 + 5), make_data(cfg, 2**31 + 5)
    c = make_data(cfg, 12)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["X"].shape == (200, 784) and a["X_test"].shape == (60, 784)
    for part, lab in (("X", y), ("X_test", y + "_test")):
        assert not np.array_equal(a[part], c[part])
        # the same rows with their labels, in another order
        ka = sorted(map(tuple, np.column_stack([a[part], a[lab]])))
        kc = sorted(map(tuple, np.column_stack([c[part], c[lab]])))
        assert ka == kc
    # the held-out rows are never training rows
    X, _ = (mnist_like if task == "binary" else mnist_like_multiclass)(
        n=260, d=784, seed=587, noise=30.0)
    train = {r.tobytes() for r in X[:200]}
    assert not any(r.tobytes() in train for r in c["X_test"])


def test_every_name_in_the_benchmark_has_its_file():
    bench = registry.benchmark()
    for c in bench["configs"]:
        cfg = registry.load_json("configs", c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert str(registry.find("configs", c["name"]).relative_to(REPO)) \
            == c["file"]
    for w in bench["workloads"]:
        traffic = registry.load_json("traffic", w["traffic"])
        registry.load_module("entries", traffic["entry"])
        registry.load_json("limits", w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.load_module("metrics", m["name"]).read)
    with pytest.raises(LookupError):
        registry.find("metrics", "no_such_metric")


@pytest.mark.parametrize("cell", CELLS)
def test_command_at_a_tiny_size(tiny, cell):
    root, bench = tiny
    rc, res, err = run_cell(root, bench, cell)
    assert rc == 0, err
    assert RESULT_KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"train_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["checks"]) == set(registry.load_json("limits", cell))
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "limit" in line for line in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_cells_counter_metrics(tiny, cell):
    # on the CPU there is no device trace: the readers of the trace find
    # nothing and their metrics are left out
    root, bench = tiny
    rc, res, err = run_cell(root, bench, cell, trace=1)
    assert rc == 0, err
    expect = {m["name"] for m in bench["per_layer"]
              if cell in m["workloads"] and m["source"] != "device_trace"}
    assert set(res["metrics"]) == expect
    assert "breakdown" not in res


def test_parts_added_as_new_files_only(tmp_path, tiny):
    root, bench = tiny
    new = tmp_path
    for kind in ("configs", "traffic", "metrics", "limits"):
        (new / kind).mkdir()
    cfg = json.loads((root / "configs" / "tiny_mnist60k_binary.json")
                     .read_text())
    cfg["name"] = "tiny_added"
    cfg["svm"]["C"] = 5.0
    (new / "configs" / "tiny_added.json").write_text(json.dumps(cfg))
    (new / "traffic" / "added_mix.json").write_text(json.dumps(
        {"entry": "binary_fit", "check": {"reference_lanes": 1}}))
    (new / "metrics" / "added_metric.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    (new / "limits" / "tiny_added.added_mix.json").write_text(
        (REPO / "perfbench/limits/mnist60k_binary.cold_fit.json").read_text())
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "tiny_added.added_mix",
                               "config": "tiny_added",
                               "traffic": "added_mix", "chips": 1})
    bench["per_layer"].append({"name": "added_metric", "unit": "fits",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "train_s",
                               "workloads": ["tiny_added.added_mix"]})
    rc, res, err = run_cell([new, root], bench, "tiny_added.added_mix",
                            seed=17, trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    assert res["metrics"]["added_metric"]["value"] == res["attempted"]


def test_command_refuses_without_a_card():
    # this sandbox has no CUDA device: the command exits non-zero and
    # prints no result
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


LOADED = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from perfbench_tiny import write_tiny, run_cell
from pathlib import Path
root = Path({tmp!r})
rc, res, err = run_cell(root, write_tiny(root), {cell!r})
assert rc == 0, err
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
from perfbench.core.generate import mnist_like
from perfbench.reference import check, svm
X, Y = mnist_like(n=300, d=784, noise=30.0, seed=5)
Xf = torch.as_tensor(svm.minmax_scale(X, X).astype(np.float32))
r = svm.solve(Xf, Y, C=10.0, gamma=0.00125, eps=1e-12, tau=1e-5, q=64,
              max_inner=4096, max_iter=100000)
svm.judge(Xf, Y, r["alpha"], C=10.0, gamma=0.00125, eps=1e-12)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_harness_loads_neither_jax_nor_the_jax_package(tmp_path, cell):
    code = LOADED.format(repo=str(REPO), tests=str(REPO / "perfbench/tests"),
                         tmp=str(tmp_path), cell=cell)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "tpusvm_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpusvm"}


def test_reference_loads_nothing_of_the_program(tmp_path):
    code = REFERENCE_ONLY.format(repo=str(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "tpusvm", "tpusvm_torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from perfbench.core import runner

    monkeypatch.setitem(sys.modules, "tpusvm_lookalike", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert runner.forbidden_modules() == ["jax"]


def test_fupdate_count_by_hand():
    from perfbench.core import peaks
    m = registry.load_module("metrics", "fupdate_roofline")
    n, d, q = 60000, 784, 2048
    ops, nbytes = m.count(n, d, q, 1)
    assert ops == 2 * 60000 * 2048 * 784 == 192_675_840_000
    assert nbytes == 4 * (60000 * 784 + 60000 + 2048 * 784 + 2048 + 60000)
    least, bound = m.least_seconds(n, d, q, 16, 16)
    assert bound == "operations"
    assert least == pytest.approx(16 * 192_675_840_000 / peaks.TF32_FLOPS)
    # 16 lanes in one launch: X is read once, the lanes' operations add
    ops16, bytes16 = m.count(n, d, q, 16)
    assert ops16 == 16 * ops
    assert bytes16 == 4 * (60000 * 784 + 60000 + 16 * (2048 * 784 + 2048
                                                       + 60000))


def test_inner_smo_count_by_hand():
    from perfbench.core import peaks
    m = registry.load_module("metrics", "inner_smo_roofline")
    ops, nbytes = m.count(2048, 1, 3000)
    assert ops == 10 * 2048 * 3000
    assert nbytes == 4 * (2048 * 2048 + 5 * 2048)
    least, bound = m.least_seconds(2048, 16, 16, 48000)
    assert bound == "bytes"
    assert least == pytest.approx(16 * nbytes / peaks.HBM_BYTES)


def test_train_mfu_count_by_hand():
    m = registry.load_module("metrics", "train_mfu")
    assert m.count(60000, 784, 2048, 16) == 16 * (
        2 * 60000 * 2048 * 784 + 2 * 2048 * 2048 * 784)


def test_device_trace_arithmetic():
    tr = devtrace.Trace(ops=[("void inner_smo_kernel(float const*)", 1.0, 1.5),
                             ("rbf_cross_matvec_kernel", 1.2, 2.0),
                             ("Memcpy HtoD", 3.0, 3.25),
                             ("inner_smo_kernel", 9.5, 11.0)],
                        t0=0.5, t1=10.0)
    secs, count = devtrace.by_kernel(tr)
    assert secs["void inner_smo_kernel(float const*)"] == 0.5
    assert count["inner_smo_kernel"] == 1
    assert devtrace.kernel_seconds(tr, ["inner_smo_kernel"]) == (2.0, 2)
    assert devtrace.busy_intervals(tr) == [(1.0, 2.0), (3.0, 3.25),
                                           (9.5, 10.0)]
    assert devtrace.busy_seconds(tr) == pytest.approx(1.75)
    assert devtrace.idle_gaps(tr) == [(3.25, 9.5), (2.0, 3.0), (0.5, 1.0)]
    assert devtrace.base_name("void f<float>(int)") == "f"
    assert devtrace.base_name("(anonymous namespace)::inner_smo_kernel("
                              "float const*, int)") == "inner_smo_kernel"
    assert devtrace.base_name("void tpusvm::rbf::rbf_cross_matvec_kernel("
                              "CUtensorMap_st)") == "rbf_cross_matvec_kernel"


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    import re

    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    assert all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    n = 24  # later PRs may grow the benchmark to 24 cells
    assert (2 + 14 * n) * (b["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(re.fullmatch(NAME, x) for x in names)
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    cells = {w["name"]: w for w in b["workloads"]}
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert re.fullmatch(NAME, w["traffic"]) and _line(w["why"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m \
            else True
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])
