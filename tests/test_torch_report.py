"""tpusvm_torch.obs.report (and convergence.to_trace_events) held to the
JAX package's tpusvm.obs.report.

The same span and event script is written once by each package's Tracer
on a counter clock: the two files are byte-equal, and every formatter of
both report modules renders the same text from either file, alone, merged
from a directory of processes, and from a rotated set. Both command lines'
`report` print the same bytes. No tolerance: every comparison is exact.
"""

import contextlib
import io
import itertools
import os

import numpy as np
import pytest

from tpusvm.cli import main as j_main
from tpusvm.obs import convergence as jconv
from tpusvm.obs import report as jrep
from tpusvm.obs import trace as jtrace
from tpusvm.obs.registry import MetricsRegistry as JRegistry
from tpusvm_torch.cli import main as t_main
from tpusvm_torch.obs import convergence as tconv
from tpusvm_torch.obs import report as trep
from tpusvm_torch.obs import trace as ttrace
from tpusvm_torch.obs.registry import MetricsRegistry as TRegistry

PACKAGES = {"jax": (jtrace, jrep, JRegistry), "torch": (ttrace, trep,
                                                        TRegistry)}

# a compile record as the port writes one (cost unknown) and one with a
# cost model (the JAX package's), so both table shapes render
COMPILES = [
    {"executable": "serve.bucket[m:b8]", "lower_s": 0.125, "compile_s": 0.5,
     "cost_available": False, "flops": None, "bytes_accessed": None,
     "arith_intensity": None, "model": "m", "bucket": 8},
    {"executable": "solver.blocked_smo_solve", "lower_s": 0.25,
     "compile_s": 1.5, "cost_available": True, "flops": 2.0e9,
     "bytes_accessed": 1.0e8, "arith_intensity": 20.0},
    {"executable": "serve.bucket[m:b8]", "lower_s": 0.0625,
     "compile_s": 0.25, "cost_available": False, "flops": None,
     "bytes_accessed": None, "arith_intensity": None},
]


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 0.25


def _snapshot(Registry):
    reg = Registry()
    reg.counter("serve.requests", model="m").inc(7)
    reg.counter("stream.shards_read").inc(3)
    reg.counter("faults.injected", point="x").inc(0)
    reg.gauge("prof.compile_s", executable="e").set_max(0.5)
    reg.histogram("serve.latency_s").observe(0.01)
    return reg.snapshot()


def _write_main(trace_mod, Registry, path, rng_seed=0, max_bytes=None,
                role=None, trace_id=None):
    """The single-process script: phases, nested spans, compile records,
    a convergence trajectory, autopilot decisions, a metrics snapshot."""
    rng = np.random.default_rng(rng_seed)
    tr = trace_mod.Tracer(path, clock=_clock(), wall=lambda: 1000.0,
                          argv=["train"], max_bytes=max_bytes, role=role,
                          trace_id=trace_id)
    with tr.span("data", phase=True):
        tr.event("fault.injected", point="csv.read", kind="transient")
    with tr.span("training", phase=True):
        for rnd in (1, 2):
            with tr.span("cascade.round", round=rnd, topology="star"):
                pass
        for rec in COMPILES:
            tr.event("prof.compile", **rec)
    with tr.span("data", phase=True):
        pass
    gaps = np.sort(rng.random(50))[::-1] * 2.0
    for i, g in enumerate(gaps):
        tr.event("convergence.round", round=i + 1,
                 gap=None if i == 3 else float(g),
                 updates=int(rng.integers(0, 5000)),
                 active=int(rng.integers(100, 900)),
                 status="CONVERGED" if i == len(gaps) - 1 else "RUNNING")
    for tick in range(1, 4):
        dets = [{"name": "growth", "score": 0.1 * tick, "threshold": 0.25,
                 "triggered": tick == 3},
                {"name": "feature", "score": 0.01 * tick,
                 "threshold": 0.2, "triggered": False}]
        tr.event("autopilot.drift", tick=tick, decision=tick == 3,
                 reason="growth 0.3 >= 0.25" if tick == 3 else "",
                 report={"detectors": dets})
    tr.metrics_snapshot(_snapshot(Registry))
    tr.close()
    return tr


def _write_pod(trace_mod, Registry, d):
    """A coordinator and two workers, the workers spawned with the
    coordinator's context and their per-request spans naming its round."""
    coord = trace_mod.Tracer(os.path.join(d, "coordinator.jsonl"),
                             clock=_clock(), wall=lambda: 2000.0,
                             argv=["pod"], role="pod-coordinator",
                             trace_id="abcdef0123456789")
    workers = []
    with coord.span("pod.fit", phase=True, topology="tree", n_leaves=2):
        ctx = coord.ctx()
        for w in range(2):
            wall = 2000.0 + 0.1 * (w + 1)
            workers.append(trace_mod.Tracer(
                os.path.join(d, f"worker{w}.p{100 + w}.jsonl"),
                clock=_clock(), wall=lambda wall=wall: wall,
                argv=[f"pod.worker:{w}"], role="pod-worker", ctx=ctx))
        for rnd in (1, 2):
            with coord.span("pod.round", round=rnd):
                rctx = coord.ctx()
                for w, wt in enumerate(workers):
                    with wt.span("pod.leaf_train", req=rnd * 2 + w,
                                 phase=True, ctx=rctx.to_dict()):
                        with wt.span("pod.solve"):
                            pass
            coord.event("convergence.round", round=rnd, updates=10 * rnd,
                        active=5, status="RUNNING" if rnd == 1
                        else "CONVERGED")
    for wt in workers:
        wt.metrics_snapshot(_snapshot(Registry))
        wt.close()
    coord.close()


def _formatters(rep, recs, merged):
    out = {
        "phase_summary": rep.phase_summary(recs),
        "convergence_rows": rep.convergence_rows(recs),
        "convergence_table": rep.format_convergence_table(
            rep.convergence_rows(recs)),
        "convergence_table_10": rep.format_convergence_table(
            rep.convergence_rows(recs), max_rows=10),
        "compile_rows": rep.compile_rows(recs),
        "compile_table": rep.format_compile_table(rep.compile_rows(recs)),
        "autopilot_rows": rep.autopilot_rows(recs),
        "autopilot_table": rep.format_autopilot_table(
            rep.autopilot_rows(recs), max_rows=2),
        "counters": rep.nonzero_counters(recs),
        "report": rep.render_report(recs),
        "timeline": rep.format_timeline(recs, max_rows=6),
        "gantt": rep.format_round_gantt(recs),
        "reparent": rep.reparent_stats(recs),
        "phase_lines": rep.render_phase_lines(*rep.phase_summary(recs)),
    }
    if merged:
        spans, roles = rep.cross_process_spans(recs)
        out["cross_process"] = (
            [(s["_gid"], s["_gparent"], s["_role"], s["name"])
             for s in spans], roles)
    return out


@pytest.fixture(scope="module")
def main_traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("main")
    paths = {}
    for name, (tmod, _, Reg) in PACKAGES.items():
        paths[name] = str(d / f"{name}.jsonl")
        _write_main(tmod, Reg, paths[name])
    return paths


def test_the_two_tracers_write_the_same_bytes(main_traces):
    with open(main_traces["jax"], "rb") as f:
        jb = f.read()
    with open(main_traces["torch"], "rb") as f:
        tb = f.read()
    assert jb == tb


def test_snapshots_of_the_two_registries_are_equal():
    assert _snapshot(JRegistry) == _snapshot(TRegistry)


@pytest.mark.parametrize("reader", ["jax", "torch"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_every_formatter_renders_the_same_text(main_traces, writer, reader):
    recs = PACKAGES[reader][0].read_trace(main_traces[writer])
    want = _formatters(jrep, jtrace.read_trace(main_traces["jax"]), False)
    got = _formatters(PACKAGES[reader][1], recs, False)
    assert got == want
    assert "cost_analysis: unavailable" in got["compile_table"]
    assert "rounds elided" in got["convergence_table_10"]
    assert "reason: growth 0.3 >= 0.25" in got["autopilot_table"]


@pytest.fixture(scope="module")
def pod_dirs(tmp_path_factory):
    dirs = {}
    for name, (tmod, _, Reg) in PACKAGES.items():
        d = tmp_path_factory.mktemp(f"pod_{name}")
        _write_pod(tmod, Reg, str(d))
        dirs[name] = str(d)
    return dirs


def _members(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".jsonl"))


def test_pod_directories_hold_the_same_bytes(pod_dirs):
    jm, tm = _members(pod_dirs["jax"]), _members(pod_dirs["torch"])
    assert [os.path.basename(p) for p in jm] == [
        os.path.basename(p) for p in tm]
    for a, b in zip(jm, tm):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("reader", ["jax", "torch"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_merged_directory_renders_one_timeline(pod_dirs, writer, reader):
    rep = PACKAGES[reader][1]
    recs = rep.merge_trace_files(_members(pod_dirs[writer]))
    want = _formatters(jrep, jrep.merge_trace_files(
        _members(pod_dirs["jax"])), True)
    got = _formatters(rep, recs, True)
    # the merged files carry their own paths: compare all but provenance
    assert got == want
    stats = got["reparent"]
    assert stats["unresolved"] == 0 and stats["reparented"] == 4
    assert stats["roles"] == ["pod-coordinator", "pod-worker"]
    assert "pod rounds" in got["report"] and "#" in got["gantt"]


def test_rotated_sets_read_alike(tmp_path):
    for name, (tmod, _, Reg) in PACKAGES.items():
        tr = _write_main(tmod, Reg, str(tmp_path / f"{name}.jsonl"),
                         max_bytes=900)
        assert tr.rotations >= 1
    for name in PACKAGES:
        assert os.path.exists(tmp_path / f"{name}.jsonl.1")
        with open(tmp_path / f"{name}.jsonl.1", "rb") as f:
            backup = f.read()
        with open(tmp_path / "jax.jsonl.1", "rb") as f:
            assert backup == f.read()
    for reader in PACKAGES.values():
        for writer in PACKAGES:
            recs = reader[0].read_trace(str(tmp_path / f"{writer}.jsonl"))
            assert reader[1].render_report(recs) == jrep.render_report(
                jtrace.read_trace(str(tmp_path / "jax.jsonl")))


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("smoke", [False, True], ids=["report", "smoke"])
def test_both_command_lines_print_the_same_report(main_traces, pod_dirs,
                                                  smoke):
    extra = ["--smoke"] if smoke else []
    for target in (main_traces["torch"], pod_dirs["torch"],
                   main_traces["jax"], pod_dirs["jax"]):
        jr = _cli(j_main, ["report", target, "--max-rows", "8", *extra])
        tr = _cli(t_main, ["report", target, "--max-rows", "8", *extra])
        assert tr == jr
        assert tr[0] == 0
    if smoke:
        assert "report smoke ok: 2 phases, 2 convergence rounds, 3 files/2 "\
            "roles stitched (4 re-parented)" in tr[1]


def test_report_smoke_fails_alike_on_a_torn_trace(tmp_path, main_traces):
    path = str(tmp_path / "torn.jsonl")
    with open(main_traces["torch"]) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[:len(text) // 2])
    jr = _cli(j_main, ["report", "--smoke", path])
    tr = _cli(t_main, ["report", "--smoke", path])
    assert tr == jr and tr[0] == 1 and "REPORT SMOKE FAILED" in tr[1]


def _materialized(seed, T=8, count=13, active=True):
    rng = np.random.default_rng(seed)
    conv = {"gap": rng.random(T) * 2.0,
            "updates": rng.integers(0, 4000, T),
            "status": np.r_[np.zeros(T - 1, np.int32), [1]],
            "rounds_recorded": count, "wrapped": count > T}
    conv["gap"][2] = np.nan
    if active:
        conv["active"] = rng.integers(10, 500, T)
    return conv


class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_to_trace_events_and_the_gap_table_match(seed, active):
    conv = _materialized(seed, active=active)
    jr, tr = _Recorder(), _Recorder()
    jconv.to_trace_events(jr, conv)
    tconv.to_trace_events(tr, conv)
    assert tr.events == jr.events
    assert [a["round"] for _, a in tr.events] == list(range(6, 14))
    assert tconv.format_gap_table(conv) == jconv.format_gap_table(conv)
    assert tconv.format_gap_table(conv, max_rows=4) == \
        jconv.format_gap_table(conv, max_rows=4)
