"""The blocked solve's and the scaler's spans (BinarySVC.fit(tracer=)), and
the profile's anchor event, on the CPU.

A recording tracer on small fits: the solve.* spans tile fit.solve (one
after another, none overlapping, from its start to its end within 1e-6 s)
and scale.minmax + scale.transform tile fit.scale; a round's spans come in
the loop's order, one solve.select a round that ran a subproblem, and the
wait spans are the intervals host_wait_s sums; every timestamp lies
between perf_counter readings taken around the fit; the results are the
same bits with and without a tracer, for the blocked solve's engines, the
shrinking and checkpointed routes (whose segments' spans tile the phase
too) and the pair solver (which records none). Then the JSONL Tracer
receives the spans, and utils.timing.trace(tracer=) writes the
profile.anchor event that places the profile's operations on the spans'
clock."""

import json
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.synthetic import rings
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.obs.trace import Tracer, read_trace
from tpusvm_torch.solver.blocked import blocked_smo_solve

# the device route's order (BinarySVC.fit): the raw rows cross first, then
# are scaled and cast where the solve runs
FIT_PHASES = ["to_device", "scale", "cast", "solve", "to_host", "sv_extract"]
ROUND = ("solve.check", "solve.check_wait", "solve.refine", "solve.select",
         "solve.kbb", "solve.inner", "solve.inner_wait", "solve.rescue",
         "solve.fupdate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small per-step ops on one intra-op thread (a parallel test run's
    workers contend for the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """The harness's span list: add_span(name, t0, t1) only."""

    def __init__(self):
        self.spans = []

    def add_span(self, name, t0, t1):
        self.spans.append((name, t0, t1))

    def named(self, prefix):
        return [s for s in self.spans if s[0].startswith(prefix)]

    def one(self, name):
        (span,) = [s for s in self.spans if s[0] == name]
        return span


@pytest.fixture(scope="module")
def data():
    X, Y = rings(n=400, seed=11)
    return X, Y.astype(np.int32)


def _model(**opts):
    return BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu",
                     solver_opts=opts)


def _fit(data, tracer=None, opts=None, **fit_kw):
    X, Y = data
    return _model(**(opts or {})).fit(X, Y, tracer=tracer, **fit_kw)


def _assert_tile(parts, t0, t1):
    """parts (name, a, b) one after another from t0 to t1: each starts
    where the one before it ended, none runs backwards."""
    parts = sorted(parts, key=lambda s: s[1])
    assert parts, "no spans"
    assert abs(parts[0][1] - t0) <= 1e-6 and abs(parts[-1][2] - t1) <= 1e-6
    for (_, a, b), (_, c, _) in zip(parts, parts[1:]):
        assert a <= b and abs(b - c) <= 1e-6
    assert parts[-1][1] <= parts[-1][2]
    assert sum(b - a for _, a, b in parts) == pytest.approx(t1 - t0,
                                                            abs=1e-6)


# the engines and round kinds of the blocked solve: the kernel engine
# (q % 128 == 0), the loop engine (unaligned q), refine rebuilds, the
# K-row cache's extra verdict, fused selection, the cell's wss=2
CONFIGS = {
    "kernel": dict(q=128, max_inner=256),
    "loop": dict(q=16),
    "refine": dict(q=128, refine=400, max_refines=4),
    "krow_cache": dict(q=128, krow_cache=256),
    "fused_selection": dict(q=128, fused_selection=True),
    "wss2": dict(q=128, wss=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_spans_tile_fit_solve(data, name):
    rec = Recorder()
    before = time.perf_counter()
    m = _fit(data, rec, CONFIGS[name])
    after = time.perf_counter()
    res = m.result_
    _, s0, s1 = rec.one("fit.solve")
    solve = sorted(rec.named("solve."), key=lambda s: s[1])
    _assert_tile(solve, s0, s1)
    names = [n for n, _, _ in solve]
    assert names[0] == "solve.setup" and names[-1] == "solve.finish"
    assert names.count("solve.setup") == names.count("solve.finish") == 1
    assert set(names[1:-1]) <= set(ROUND)
    count = Counter(names)
    assert count["solve.select"] == count["solve.kbb"] == res.n_outer
    assert count["solve.fupdate"] == res.n_outer
    # every body of the loop checks once: the rounds, the refines and the
    # last check that ends the solve
    assert count["solve.check"] == count["solve.check_wait"] == \
        res.n_outer + res.n_refines + 1
    assert count["solve.refine"] == res.n_refines
    waits = sum(b - a for n, a, b in solve if n.endswith("_wait"))
    assert waits == pytest.approx(res.host_wait_s, rel=1e-9, abs=1e-12)
    if name in ("kernel", "refine", "krow_cache", "fused_selection", "wss2"):
        assert count["solve.inner_wait"] == res.n_outer
    else:
        assert count["solve.inner_wait"] == 0
    if name == "refine":
        assert res.n_refines >= 1
    # a round's spans in the loop's order
    order = {n: i for i, n in enumerate(ROUND)}
    body = names[1:-1]
    for a, b in zip(body, body[1:]):
        assert order[b] > order[a] or b == "solve.check"
    for _, a, b in rec.spans:
        assert before <= a <= b <= after
    assert list(m.fit_phases_) == FIT_PHASES


def test_scale_spans_tile_fit_scale(data):
    rec = Recorder()
    before = time.perf_counter()
    _fit(data, rec, CONFIGS["loop"])
    _, t0, t1 = rec.one("fit.scale")
    scale = rec.named("scale.")
    assert [n for n, _, _ in sorted(scale, key=lambda s: s[1])] == [
        "scale.minmax", "scale.transform"]
    _assert_tile(scale, t0, t1)
    # fit.to_device, then fit.scale, then fit.cast, one after another
    front = [rec.one("fit." + p) for p in ("to_device", "scale", "cast")]
    _assert_tile(front, front[0][1], front[-1][2])
    # the fit's phases tile the fit from its start, in the order they ran
    fit = rec.named("fit.")
    assert [n for n, _, _ in fit] == ["fit." + p for p in FIT_PHASES]
    assert before <= fit[0][1]
    _assert_tile(fit, fit[0][1], fit[-1][2])


def test_an_unscaled_fit_records_no_scale_spans(data):
    rec = Recorder()
    X, Y = data
    BinarySVC(SVMConfig(C=10.0, gamma=10.0), scale=False, device="cpu",
              solver_opts=CONFIGS["loop"]).fit(X, Y, tracer=rec)
    assert rec.named("scale.") == [] and rec.one("fit.scale")


ROUTES = {
    "kernel": dict(opts=CONFIGS["kernel"]),
    "loop": dict(opts=CONFIGS["loop"]),
    "shrinking": dict(opts=dict(q=16, shrink_every=2, shrink_min=64)),
    "checkpointed": dict(opts=dict(q=16), checkpoint_every=2),
    "pair": dict(opts={}, solver="pair"),
}


def _route_fit(data, route, tracer, tmp_path):
    X, Y = data
    spec = ROUTES[route]
    kw = {}
    if "checkpoint_every" in spec:
        kw = dict(checkpoint_path=str(tmp_path / f"{id(tracer)}.npz"),
                  checkpoint_every=spec["checkpoint_every"])
    m = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu",
                  solver=spec.get("solver", "blocked"),
                  solver_opts=spec["opts"])
    return m.fit(X, Y, tracer=tracer, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_traced_fit_is_the_untraced_fit_bit_for_bit(data, route, tmp_path):
    rec = Recorder()
    a = _route_fit(data, route, rec, tmp_path)
    b = _route_fit(data, route, None, tmp_path)
    assert torch.equal(a.result_.alpha, b.result_.alpha)
    assert a.b_ == b.b_ and a.status_ == b.status_
    assert a.n_iter_ == b.n_iter_
    assert np.array_equal(a.sv_ids_, b.sv_ids_)
    assert rec.one("fit.solve")


@pytest.mark.parametrize("route", ["shrinking", "checkpointed"])
def test_segmenting_routes_tile_fit_solve_segment_by_segment(data, route,
                                                             tmp_path):
    rec = Recorder()
    m = _route_fit(data, route, rec, tmp_path)
    _, s0, s1 = rec.one("fit.solve")
    solve = sorted(rec.named("solve."), key=lambda s: s[1])
    _assert_tile(solve, s0, s1)
    names = [n for n, _, _ in solve]
    # one setup and one finish a segment
    assert names.count("solve.setup") == names.count("solve.finish") >= 2
    assert names.count("solve.select") == m.result_.n_outer
    waits = sum(b - a for n, a, b in solve if n.endswith("_wait"))
    assert waits == pytest.approx(m.result_.host_wait_s, rel=1e-9,
                                  abs=1e-12)


def test_the_pair_solver_takes_a_tracer_and_records_no_solve_spans(
        data, tmp_path):
    rec = Recorder()
    _route_fit(data, "pair", rec, tmp_path)
    assert rec.named("solve.") == []
    assert [n for n, _, _ in rec.named("fit.")] == [
        "fit." + p for p in FIT_PHASES]


def test_blocked_solve_called_alone_tiles_its_call(data):
    X, Y = data
    rec = Recorder()
    Xs = ((X - X.min(0)) / (X.max(0) - X.min(0))).astype(np.float32)
    before = time.perf_counter()
    res = blocked_smo_solve(Xs, Y, C=10.0, gamma=10.0, q=128,
                            accum_dtype=torch.float64, device="cpu",
                            tracer=rec)
    after = time.perf_counter()
    plain = blocked_smo_solve(Xs, Y, C=10.0, gamma=10.0, q=128,
                              accum_dtype=torch.float64, device="cpu")
    assert torch.equal(res.alpha, plain.alpha) and res.b == plain.b
    spans = sorted(rec.spans, key=lambda s: s[1])
    assert spans[0][0] == "solve.setup" and spans[-1][0] == "solve.finish"
    assert before <= spans[0][1] and spans[-1][2] <= after
    _assert_tile(spans, spans[0][1], spans[-1][2])


def test_the_jsonl_tracer_writes_the_spans(data, tmp_path):
    path = str(tmp_path / "t.jsonl")
    tracer = Tracer(path)
    m = _fit(data, tracer, CONFIGS["kernel"])
    tracer.close()
    spans = [r for r in read_trace(path) if r["kind"] == "span"]
    names = Counter(r["name"] for r in spans)
    assert names["solve.select"] == m.result_.n_outer
    assert names["scale.minmax"] == names["scale.transform"] == 1
    assert names["solve.setup"] == names["solve.finish"] == 1
    (solve,) = [r for r in spans if r["name"] == "fit.solve"]
    inner = [r for r in spans if r["name"].startswith("solve.")]
    assert min(r["t0"] for r in inner) == pytest.approx(solve["t0"],
                                                        abs=1e-6)
    assert max(r["t1"] for r in inner) == pytest.approx(solve["t1"],
                                                        abs=1e-6)


def test_profile_anchor_places_the_profile_on_the_spans_clock(tmp_path):
    from tpusvm_torch.utils.timing import ANCHOR, TRACE_FILE, trace

    path = str(tmp_path / "t.jsonl")
    tracer = Tracer(path)
    before = time.perf_counter()
    with trace(str(tmp_path / "prof"), device="cpu", tracer=tracer):
        a = torch.randn(64, 64)
        t_mm = time.perf_counter()
        torch.mm(a, a)
        t_mm_end = time.perf_counter()
    after = time.perf_counter()
    tracer.close()
    (anchor,) = [r for r in read_trace(path) if r["kind"] == "event"
                 and r["name"] == "profile.anchor"]
    assert anchor["attrs"]["marker"] == ANCHOR
    t = anchor["attrs"]["t"]
    assert before <= t <= after
    with open(os.path.join(str(tmp_path / "prof"), TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    (region,) = [e for e in events if e.get("name") == ANCHOR
                 and e.get("ph") == "X"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    # the profile's first operation is the marker's op, inside its region
    first = min(ops, key=lambda e: e["ts"])
    assert first["name"] == anchor["attrs"]["op"]
    assert region["ts"] <= first["ts"] <= region["ts"] + region["dur"]
    # the product's op, moved onto perf_counter by the anchor, lies where
    # the host clock saw it (to half a millisecond of clock skew)
    (mm,) = [e for e in ops if e["name"] == "aten::mm"]
    start = t + (mm["ts"] - first["ts"]) * 1e-6
    assert t_mm - 5e-4 <= start <= t_mm_end + 5e-4


def test_profile_without_a_tracer_writes_no_anchor(tmp_path):
    from tpusvm_torch.utils.timing import ANCHOR, TRACE_FILE, trace

    with trace(str(tmp_path / "prof"), device="cpu"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(os.path.join(str(tmp_path / "prof"), TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert not [e for e in events if e.get("name") == ANCHOR]
