"""--trace, --jsonl, --profile and --faults on the port's command line,
against the JAX command line on the same tiny CPU data.

Each sub-command runs once traced in each package, all as subprocesses
started together (one torch/XLA thread each). Then:

  * every trace passes both packages' `report` alike (the same text and
    exit code, --smoke included), and holds the JAX run's phase span names
    and event names; compile records are compared apart, since XLA compiles
    on the CPU and the port builds nothing there;
  * a traced fit is the untraced fit bit for bit (the saved artifacts);
  * the traced cascade and pod runs give the JAX runs' SV counts, round
    counts and status (PARITY.md's cross-engine band: b within 1e-4), and
    the pod's trace directory stitches into one timeline in both reports;
  * train --jsonl writes the JAX run's records, their time fields aside;
  * --faults prints the JAX activation line, a bad plan exits 2 through
    argparse, and TPUSVM_FAULTS is honoured.
"""

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpusvm.cli import main as j_main
from tpusvm_torch.cli import main as t_main

REPO = Path(__file__).resolve().parents[1]
FIXTURE_PLAN = str(REPO / "tests" / "fixtures" / "chaos_plan.json")

TRAIN = ["train", "--synthetic", "rings", "--n", "240", "--n-test", "60",
         "--C", "10", "--gamma", "10", "--convergence", "16"]
CASCADE = ["train", "--synthetic", "rings", "--n", "320", "--n-test", "100",
           "--C", "10", "--gamma", "10", "--mode", "cascade", "--shards",
           "4", "--topology", "star", "--sv-capacity", "256",
           "--solver-opt", "q=64"]
INGEST = ["ingest", "--synthetic", "rings", "--n", "200", "--rows-per-shard",
          "64"]

# (name, argv without device flags); every run is traced into <name>.jsonl
# or, for the pod, <name>/ ; the traced train runs also save an artifact
RUNS = {
    "train": TRAIN + ["--jsonl", "{p}train_log.jsonl", "--save",
                      "{p}train.npz"],
    "cascade": CASCADE + ["--save", "{p}cascade.npz"],
    "ingest": INGEST + ["--out", "{p}ds"],
    "tune": ["tune", "--smoke", "-q"],
    "autopilot": ["autopilot", "--smoke", "-q"],
    "tenants": ["tenants", "--smoke", "-q"],
    "pod": ["pod", "--smoke", "-q"],
}
# untraced port controls for the bit-for-bit checks
CONTROLS = {
    "train_plain": TRAIN + ["--save", "train_plain.npz"],
    "cascade_plain": CASCADE + ["--save", "cascade_plain.npz"],
}
NO_DEVICE = ("ingest",)


def _argv(pkg, name, argv):
    p = "j_" if pkg == "jax" else "t_"
    out = [a.format(p=p) for a in argv]
    if name == "pod":
        out += ["--trace-dir", p + "pod"]
    elif name in RUNS:
        out += ["--trace", p + name + ".jsonl"]
    if name.split("_")[0] not in NO_DEVICE:
        out += ["--platform", "cpu"] if pkg == "jax" else ["--device", "cpu"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_cli")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env.pop("TPUSVM_FAULTS", None)
    procs = {}
    for pkg, mod in (("jax", "tpusvm"), ("torch", "tpusvm_torch")):
        for name, argv in RUNS.items():
            procs[(pkg, name)] = subprocess.Popen(
                [sys.executable, "-m", mod, *_argv(pkg, name, argv)],
                cwd=d, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for name, argv in CONTROLS.items():
        procs[("torch", name)] = subprocess.Popen(
            [sys.executable, "-m", "tpusvm_torch",
             *_argv("torch", name, argv)],
            cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            text, _ = proc.communicate(timeout=400)
            out[key] = (proc.returncode, text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return d, out


def _ok(runs, pkg, name):
    d, out = runs
    rc, text = out[(pkg, name)]
    assert rc == 0, text[-3000:]
    return text


def _trace(runs, pkg, name):
    p = "j_" if pkg == "jax" else "t_"
    return str(runs[0] / (p + name + (".jsonl" if name != "pod" else "")))


def _read(path):
    from tpusvm_torch.obs import read_trace
    from tpusvm_torch.obs.report import merge_trace_files

    if os.path.isdir(path):
        return merge_trace_files(sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".jsonl")))
    return read_trace(path)


def _names(recs):
    phases = []
    for r in recs:
        if r["kind"] == "span" and (r.get("attrs") or {}).get("phase") \
                and r["name"] not in phases:
            phases.append(r["name"])
    events = collections.Counter(r["name"] for r in recs
                                 if r["kind"] == "event")
    compiles = events.pop("prof.compile", 0)
    return phases, events, compiles


@pytest.mark.parametrize("name", list(RUNS))
def test_traces_hold_the_jax_runs_phases_and_events(runs, name):
    _ok(runs, "jax", name)
    _ok(runs, "torch", name)
    jp, je, _ = _names(_read(_trace(runs, "jax", name)))
    tp, te, tc = _names(_read(_trace(runs, "torch", name)))
    assert tp == jp
    if name == "pod":
        # a worker's own closing snapshot races the coordinator's teardown
        # (in both packages); the coordinator's merged fleet snapshot, one
        # a fit, and every round event are deterministic
        te.pop("metrics.snapshot")
        je.pop("metrics.snapshot")
        assert te == je
        coord = _read(os.path.join(_trace(runs, "torch", name),
                                   "coordinator.jsonl"))
        assert sum(r.get("name") == "metrics.snapshot" for r in coord) == 2
    else:
        assert set(te) == set(je) and te == je, (te, je)
    # the port compiles nothing on the CPU but serve's bucket programs
    if name in ("autopilot", "tenants"):
        assert tc > 0
    elif name != "pod":
        assert tc == 0


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("name", list(RUNS))
def test_both_reports_read_the_ports_traces_alike(runs, name):
    _ok(runs, "torch", name)
    path = _trace(runs, "torch", name)
    for extra in ([], ["--smoke"]):
        t = _cli(t_main, ["report", path, *extra])
        j = _cli(j_main, ["report", path, *extra])
        assert t == j
        assert t[0] == 0 or extra
    if name in ("train", "pod"):
        # phase spans and convergence records: the smoke gate holds
        assert t[0] == 0 and "report smoke ok" in t[1]


def test_the_pod_directory_stitches_into_one_timeline(runs):
    _ok(runs, "torch", "pod")
    from tpusvm_torch.obs.report import reparent_stats

    stats = reparent_stats(_read(_trace(runs, "torch", "pod")))
    # the coordinator and 4 workers, each topology
    assert stats["files"] == 9 and stats["unresolved"] == 0
    assert stats["roles"] == ["pod-coordinator", "pod-worker"]
    assert stats["reparented"] > 0
    # the same rounds and SV counts as JAX's pod smoke
    line = r"^pod ok: (.*), 4 workers"
    assert re.search(line, _ok(runs, "torch", "pod"), re.M).group(1) == \
        re.search(line, _ok(runs, "jax", "pod"), re.M).group(1)


def _artifact(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["train", "cascade"])
def test_a_traced_fit_is_the_untraced_fit(runs, name):
    _ok(runs, "torch", name)
    _ok(runs, "torch", name + "_plain")
    d = runs[0]
    a = _artifact(str(d / f"t_{name}.npz"))
    b = _artifact(str(d / f"{name}_plain.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _field(pattern, text):
    m = re.search(pattern, text, re.M)
    assert m, (pattern, text[-2000:])
    return m.group(1)


@pytest.mark.parametrize("name", ["train", "cascade"])
def test_traced_fits_match_the_jax_fits(runs, name):
    from tpusvm_torch.models import BinarySVC

    t, j = _ok(runs, "torch", name), _ok(runs, "jax", name)
    for pat in (r"^(n = \d+, n_features = \d+)", r"^SV count = (\d+)",
                r"^(accuracy = .*)"):
        assert _field(pat, t) == _field(pat, j), pat
    assert abs(float(_field(r"^b = (\S+)", t))
               - float(_field(r"^b = (\S+)", j))) <= 1e-4
    if name == "cascade":
        assert _field(r"^(cascade: \d+ rounds, converged = \w+)", t) == \
            _field(r"^(cascade: \d+ rounds, converged = \w+)", j)
    d = runs[0]
    mt = BinarySVC.load(str(d / f"t_{name}.npz"), device="cpu")
    mj = BinarySVC.load(str(d / f"j_{name}.npz"), device="cpu")
    assert np.array_equal(np.sort(mt.sv_ids_), np.sort(mj.sv_ids_))


def test_train_jsonl_is_the_jax_runs_without_time_fields(runs):
    _ok(runs, "torch", "train")
    _ok(runs, "jax", "train")

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    d = runs[0]
    t = records(str(d / "t_train_log.jsonl"))
    j = records(str(d / "j_train_log.jsonl"))
    assert [r["event"] for r in t] == [r["event"] for r in j] == [
        "data", "train", "eval", "timing"]
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
    # the data and eval records exactly; the fit's within the cross-engine
    # band (the iteration counts of the two engines differ)
    assert t[0] == dict(j[0], ts=t[0]["ts"])
    assert t[2] == dict(j[2], ts=t[2]["ts"])
    assert (t[1]["sv_count"], t[1]["status"]) == (j[1]["sv_count"],
                                                  j[1]["status"])
    assert abs(t[1]["b"] - j[1]["b"]) <= 1e-4


@pytest.mark.parametrize("primary", [True, False])
def test_run_logger_writes_the_jax_loggers_lines(tmp_path, primary):
    from tpusvm.utils import RunLogger as JRunLogger
    from tpusvm_torch.utils import RunLogger

    outs = {}
    for name, cls in (("jax", JRunLogger), ("torch", RunLogger)):
        buf = io.StringIO()
        path = str(tmp_path / f"{name}.jsonl")
        with cls(stream=buf, jsonl_path=path, primary=primary) as log:
            log.info("n = %d, n_features = %d", 100, 4)
            log.info("plain line")
            log.round_header(3)
            log.event("data", n=100, arr=np.arange(3), f=np.float32(0.5),
                      i=np.int64(7), ok=np.bool_(True))
            log.event("timing", training=1.25, total=2.5)
        lines = []
        if os.path.exists(path):
            with open(path) as f:
                lines = [json.loads(line) for line in f]
        for rec in lines:
            assert isinstance(rec.pop("ts"), float)
        outs[name] = (buf.getvalue(), lines)
    assert outs["torch"] == outs["jax"]
    assert bool(outs["torch"][1]) is primary


def test_train_trace_carries_the_kernel_counts(runs):
    _ok(runs, "torch", "train")
    from tpusvm_torch.obs.report import nonzero_counters

    recs = _read(_trace(runs, "torch", "train"))
    snaps = [r for r in recs if r["kind"] == "event"
             and r["name"] == "metrics.snapshot"]
    names = {(e["name"], e["labels"].get("kernel"))
             for e in snaps[0]["attrs"]["snapshot"]["metrics"]}
    assert ("kernel.launches", "fused_fupdate") in names
    assert ("kernel.launches", "inner_smo") in names
    # on the CPU no kernel launches: nothing of it among the counters
    assert not [c for c in nonzero_counters(recs) if "kernel." in c]


def test_autopilot_and_tenant_traces_carry_their_decisions(runs):
    from tpusvm_torch.obs.report import autopilot_rows, format_autopilot_table

    t = _read(_trace(runs, "torch", "autopilot"))
    j = _read(_trace(runs, "jax", "autopilot"))
    assert len(autopilot_rows(t)) == len(autopilot_rows(j)) >= 1
    assert [r["decision"] for r in autopilot_rows(t)] == [
        r["decision"] for r in autopilot_rows(j)]
    assert "REFRESH" in format_autopilot_table(autopilot_rows(t))


# ------------------------------------------------------------------ faults
def _run_cli(argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("TPUSVM_FAULTS", None)
    env.update(env_extra or {})
    out = {}
    for pkg, mod in (("jax", "tpusvm"), ("torch", "tpusvm_torch")):
        p = subprocess.run([sys.executable, "-m", mod, *argv],
                           capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=120)
        out[pkg] = p
    return out


def test_faults_flag_prints_the_jax_activation_line(capsys):
    from tpusvm import faults as jfaults
    from tpusvm_torch import faults

    try:
        for argv in (["--faults", FIXTURE_PLAN, "info"],
                     ["info", "--faults", FIXTURE_PLAN]):
            assert t_main(argv) == 0
            tout = capsys.readouterr().out.splitlines()[0]
            assert j_main(argv) == 0
            jout = capsys.readouterr().out.splitlines()[0]
            assert tout == jout
            assert tout.startswith(f"fault plan active: {FIXTURE_PLAN} (seed ")
            assert faults.active_plan() is not None
            faults.deactivate()
            jfaults.deactivate()
    finally:
        faults.deactivate()
        jfaults.deactivate()


def test_a_bad_plan_exits_2_and_the_env_var_is_honoured(tmp_path):
    bad = str(tmp_path / "absent.json")
    out = _run_cli(["report", "--faults", bad, str(tmp_path)])
    for p in out.values():
        assert p.returncode == 2 and "--faults:" in p.stderr
    torn = tmp_path / "torn.json"
    torn.write_text("{not json")
    out = _run_cli(["--faults", str(torn), "benchdiff", "a", "b"])
    assert [p.returncode for p in out.values()] == [2, 2]
    # the environment variable activates the plan before the command runs
    fix = str(REPO / "tests" / "fixtures" / "benchdiff" / "baseline.jsonl")
    out = _run_cli(["benchdiff", fix, fix],
                   env_extra={"TPUSVM_FAULTS": FIXTURE_PLAN})
    lines = {k: p.stdout.splitlines()[0] for k, p in out.items()}
    assert lines["torch"] == lines["jax"]
    assert lines["torch"].startswith("fault plan active: ")
    assert all(p.returncode == 0 for p in out.values())
