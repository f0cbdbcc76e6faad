"""The readers of the outer loop's spans, on hand-built runs: select_host_ms
and launch_host_ms sum their solve.* spans a fit, solve_idle_ms takes each
fit.solve span less the device's busy union clipped to it, and each finds
nothing to read where the program records no such spans or the run has no
device trace. Then the two span readers on a real traced fit on the CPU."""

from __future__ import annotations

import pytest

from perfbench_tiny import REPO  # noqa: F401  (puts the repo on the path)

from perfbench.core import devtrace, registry
from perfbench.core.runner import Run
from perfbench.core.spans import Spans

CELL = "mnist60k_binary.cold_fit"
CFG = {"data": {"n_train": 600, "d": 16},
       "solver": {"opts": {"q": 128}}}


def _run(spans, trace=None, units=2):
    rec = Spans()
    rec.spans = list(spans)
    return Run(CELL, CFG, {}, [{"counters": {}, "phases": {}}] * units, rec,
               trace, 1.0, 1.0, "")


def _read(metric, run):
    return registry.load_module("metrics", metric).read(run)


# two fits' worth of one round each: (name, t0, t1) in seconds
ROUNDS = [
    ("fit.solve", 1.0, 2.0),
    ("solve.setup", 1.0, 1.1), ("solve.check", 1.1, 1.15),
    ("solve.check_wait", 1.15, 1.3), ("solve.select", 1.3, 1.34),
    ("solve.kbb", 1.34, 1.36), ("solve.inner", 1.36, 1.4),
    ("solve.inner_wait", 1.4, 1.8), ("solve.fupdate", 1.8, 1.85),
    ("solve.finish", 1.85, 2.0),
    ("fit.solve", 3.0, 4.0),
    ("solve.setup", 3.0, 3.2), ("solve.check", 3.2, 3.3),
    ("solve.check_wait", 3.3, 3.4), ("solve.select", 3.4, 3.5),
    ("solve.kbb", 3.5, 3.6), ("solve.inner", 3.6, 3.7),
    ("solve.inner_wait", 3.7, 3.8), ("solve.fupdate", 3.8, 3.9),
    ("solve.finish", 3.9, 4.0),
    ("fit.scale", 0.0, 1.0), ("scale.minmax", 0.0, 0.4),
]


@pytest.mark.parametrize("metric,expect_ms", [
    # (0.05 + 0.04) + (0.1 + 0.1) over two fits
    ("select_host_ms", 1e3 * 0.29 / 2),
    # (0.02 + 0.04 + 0.05) + (0.1 + 0.1 + 0.1) over two fits
    ("launch_host_ms", 1e3 * 0.41 / 2),
])
def test_span_readers_sum_their_spans_a_fit(metric, expect_ms):
    assert _read(metric, _run(ROUNDS)) == pytest.approx(expect_ms)
    # three units, the same spans: a third less a fit
    assert _read(metric, _run(ROUNDS, units=3)) == pytest.approx(
        expect_ms * 2 / 3)


@pytest.mark.parametrize("metric", ["select_host_ms", "launch_host_ms",
                                    "solve_idle_ms"])
def test_readers_find_nothing_without_the_spans(metric):
    # a program that records only the fit's phases (the parent of the
    # solve.* spans) and no device trace
    fit_only = [s for s in ROUNDS if s[0].startswith("fit.")]
    assert _read(metric, _run(fit_only)) is None
    assert _read(metric, _run([])) is None


def test_solve_idle_is_none_without_a_device_trace():
    assert _read("solve_idle_ms", _run(ROUNDS)) is None


def test_solve_idle_clips_device_ops_to_each_solve():
    trace = devtrace.Trace(ops=[
        ("marker-less op straddling the first solve's start", 0.9, 1.2),
        ("inner_smo_kernel", 1.5, 1.6),
        ("overlapping op", 1.55, 1.7),
        # straddles the first solve's end and the second's start
        ("rbf_cross_matvec_kernel", 1.9, 3.1),
        ("after the second solve", 4.2, 4.5),
    ], t0=0.5, t1=5.0)
    # first: 1.0 less busy 1.0-1.2, 1.5-1.7, 1.9-2.0 = 0.5 idle; second:
    # 1.0 less busy 3.0-3.1 = 0.9 idle; 1.4 s over two fits
    assert _read("solve_idle_ms", _run(ROUNDS, trace)) == pytest.approx(700.0)
    # idle is what the device trace leaves of the span, whatever the
    # spans inside it say
    inner_only = [s for s in ROUNDS if s[0] == "fit.solve"]
    assert _read("solve_idle_ms", _run(inner_only, trace)) == \
        pytest.approx(700.0)
    # no device operation at all: every solve is idle
    empty = devtrace.Trace(ops=[], t0=0.5, t1=5.0)
    assert _read("solve_idle_ms", _run(ROUNDS, empty)) == pytest.approx(1e3)


def test_idle_seconds_of_one_interval_by_hand():
    m = registry.load_module("metrics", "solve_idle_ms")
    busy = [(0.0, 1.0), (2.0, 3.0), (4.0, 6.0)]
    assert m.idle_seconds(busy, 0.5, 5.0) == pytest.approx(4.5 - 2.5)
    assert m.idle_seconds(busy, 1.0, 2.0) == pytest.approx(1.0)
    assert m.idle_seconds(busy, 4.5, 5.5) == pytest.approx(0.0)


def test_the_three_readers_are_declared_for_the_cell_on_one_layer():
    bench = registry.benchmark()
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("solve_idle_ms", "select_host_ms", "launch_host_ms"):
        m = layer[name]
        assert m["layer"] == layer["outer_rounds"]["layer"]
        assert m["moves"] == "train_s" and m["workloads"] == [CELL]
    assert layer["solve_idle_ms"]["source"] == "device_trace"


def test_span_readers_on_a_traced_fit_on_the_cpu():
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.models.svm import BinarySVC

    X, Y = mnist_like(n=600, d=16, seed=5)
    spans = Spans()
    model = BinarySVC(SVMConfig(C=10.0, gamma=0.05), device="cpu",
                      solver_opts={"q": 128}).fit(X, Y, tracer=spans)
    run = _run(spans.spans, units=1)
    select = _read("select_host_ms", run)
    launch = _read("launch_host_ms", run)
    assert select > 0 and launch > 0
    # both lie inside the solve phase, beside its waits
    solve_ms = 1e3 * model.fit_phases_["solve"]
    wait_ms = 1e3 * model.result_.host_wait_s
    assert select + launch + wait_ms <= solve_ms * (1 + 1e-9)
