"""The port's trace context, tracer and fleet view on the CPU, held against
the JAX package's (tests/test_obs_fabric.py's contracts).

Bands: exact. TraceContext dicts and headers cross between the packages
both ways and both refuse the same junk; tracers of both packages under
one fixed clock, wall clock, role and trace id write byte-identical
files (rotated sets included), and each package's read_trace reads the
other's file; merge_fleet, render_fleet_text, fleet_json, top_rows and
format_top give the JAX package's values and strings for the same
payloads, and both collectors derive the same rates from one injected
clock. Payloads come from registries filled from a seed with numpy.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusvm.obs import fleet as jfleet
from tpusvm.obs import trace as jtrace
from tpusvm.obs.registry import MetricsRegistry as JMetricsRegistry
from tpusvm.obs.report import render_phase_lines as j_render_phase_lines
from tpusvm_torch.obs import fleet as tfleet
from tpusvm_torch.obs import trace as ttrace
from tpusvm_torch.obs.fleet import (FleetCollector, FleetView, format_top,
                                    merge_fleet, parse_payload,
                                    read_snapshot_file, render_fleet_text,
                                    snapshot_payload, top_rows,
                                    write_snapshot_file)
from tpusvm_torch.obs.registry import MetricsRegistry
from tpusvm_torch.obs.trace import (TRACE_HEADER, PhaseTimer, TraceContext,
                                    Tracer, read_trace)

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic monotonic clock for bit-stable trace files."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ----------------------------------------------------------- TraceContext
CTXS = [TraceContext("abcd1234", 7, "router", 99),
        TraceContext("t0", None, "serve", 2),
        TraceContext("feed01", 0, "pod-coordinator", 17)]


@pytest.mark.parametrize("ctx", CTXS, ids=lambda c: c.role)
def test_trace_context_crosses_the_packages(ctx):
    j = jtrace.TraceContext(**ctx.to_dict())
    assert ctx.to_dict() == j.to_dict()
    assert ctx.to_header() == j.to_header()
    assert TraceContext.from_header(j.to_header()) == ctx
    assert jtrace.TraceContext.from_header(ctx.to_header()) == j
    assert TraceContext.from_dict(j.to_dict()) == ctx
    assert jtrace.TraceContext.from_dict(ctx.to_dict()) == j
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER == "X-Tpusvm-Trace"


JUNK_DICTS = [None, "x", 7, [], {},
              {"trace_id": "t", "role": "r"},
              {"trace_id": 5, "role": "r", "pid": 1},
              {"trace_id": "t", "role": None, "pid": 1},
              {"trace_id": "t", "role": "r", "pid": True},
              {"trace_id": "t", "role": "r", "pid": 1, "span_id": "3"},
              {"trace_id": "t", "role": "r", "pid": 1, "span_id": False}]
JUNK_HEADERS = [None, "", "garbage", "2;t;3;r;1", "1;t;3;r", "1;;3;r;1",
                "1;t;3;;1", "1;t;x;r;1", "1;t;3;r;nope", "1;t;3;r;1;extra"]


@pytest.mark.parametrize("junk", JUNK_DICTS, ids=repr)
def test_both_packages_refuse_the_same_junk_dicts(junk):
    assert TraceContext.from_dict(junk) is None
    assert jtrace.TraceContext.from_dict(junk) is None


@pytest.mark.parametrize("junk", JUNK_HEADERS, ids=repr)
def test_both_packages_refuse_the_same_junk_headers(junk):
    assert TraceContext.from_header(junk) is None
    assert jtrace.TraceContext.from_header(junk) is None


# ------------------------------------------------------------------ Tracer
def _drive(tracer_cls, path, seed, **kw):
    """One scripted sequence of spans and events, drawn from a seed."""
    rng = np.random.default_rng(seed)
    with tracer_cls(path, clock=FakeClock(), wall=lambda: 1000.0,
                    argv=["serve"], **kw) as tr:
        for i in range(int(rng.integers(3, 7))):
            with tr.span("serve.request", model=f"m{i}",
                         rows=int(rng.integers(1, 64)),
                         ctx={"trace_id": "cafe", "span_id": i,
                              "role": "router", "pid": 1}):
                if rng.random() < 0.5:
                    tr.event("fault.injected", point="router.forward",
                             hit=np.int64(i), score=np.float32(0.5))
                with tr.span("inner", phase=True):
                    pass
        tr.metrics_snapshot({"v": 1, "metrics": []})
        return tr


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("identity", ["anonymous", "role", "ctx"])
def test_tracer_files_equal_jax_byte_for_byte(tmp_path, seed, identity):
    kw = {"anonymous": {},
          "role": {"role": "serve", "trace_id": "tid0"},
          "ctx": {"role": "pod-worker",
                  "ctx": CTXS[0]}}[identity]
    jkw = dict(kw)
    if "ctx" in jkw:
        jkw["ctx"] = jtrace.TraceContext(**CTXS[0].to_dict())
    mine, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    _drive(Tracer, mine, seed, **kw)
    _drive(jtrace.Tracer, theirs, seed, **jkw)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    # each package reads the other's file
    assert read_trace(theirs) == jtrace.read_trace(mine)
    meta = read_trace(mine)[0]
    if identity == "anonymous":
        assert not {"trace_id", "role", "pid", "ctx"} & set(meta)
    else:
        assert meta["role"] == kw["role"] and meta["pid"] == os.getpid()


def test_rotated_sets_equal_jax(tmp_path):
    for cls, sub in ((Tracer, "p"), (jtrace.Tracer, "j")):
        os.makedirs(tmp_path / sub)
        with cls(str(tmp_path / sub / "t.jsonl"), clock=FakeClock(),
                 wall=lambda: 0.0, max_bytes=400, role="router",
                 trace_id="r0") as tr:
            for i in range(12):
                with tr.span("router.forward", model="m", i=i):
                    pass
        assert tr.rotations > 0
    for name in ("t.jsonl", "t.jsonl.1"):
        assert (tmp_path / "p" / name).read_bytes() \
            == (tmp_path / "j" / name).read_bytes()
    assert ttrace.trace_file_set(str(tmp_path / "p" / "t.jsonl")) == [
        str(tmp_path / "p" / "t.jsonl.1"), str(tmp_path / "p" / "t.jsonl")]
    recs = read_trace(str(tmp_path / "p" / "t.jsonl"))
    assert recs == jtrace.read_trace(str(tmp_path / "j" / "t.jsonl"))


def test_tracer_identity_ctx_minting_and_refusals(tmp_path):
    path = str(tmp_path / "r.jsonl")
    with Tracer(path, clock=FakeClock(), wall=lambda: 0.0, role="router",
                trace_id="tid0") as tr:
        assert tr.ctx() == TraceContext("tid0", None, "router", tr.pid)
        with tr.span("router.forward"):
            assert tr.ctx().span_id == 1
    auto = Tracer(str(tmp_path / "auto.jsonl"), role="serve")
    assert isinstance(auto.trace_id, str) and len(auto.trace_id) == 16
    auto.close()
    with pytest.raises(ValueError, match=";"):
        Tracer(str(tmp_path / "bad.jsonl"), role="a;b")
    with pytest.raises(ValueError, match="max_bytes"):
        Tracer(str(tmp_path / "bad.jsonl"), max_bytes=0)
    with Tracer(str(tmp_path / "anon.jsonl")) as anon:
        with pytest.raises(ValueError, match="role"):
            anon.ctx()
    # a torn last line (a killed writer) is reported, not skipped
    with open(path, "a") as f:
        f.write('{"v": 1, "kind": "sp')
    with pytest.raises(ValueError, match="truncated"):
        read_trace(path)
    with open(str(tmp_path / "v9.jsonl"), "w") as f:
        f.write('{"v": 9, "kind": "meta"}\n')
    with pytest.raises(ValueError, match="version"):
        read_trace(str(tmp_path / "v9.jsonl"))


def test_tracer_threads_write_whole_records_and_parent_per_thread(tmp_path):
    path = str(tmp_path / "threads.jsonl")
    tr = Tracer(path, role="router")
    n_threads, n_spans = 8, 50

    def run(t):
        for i in range(n_spans):
            with tr.span("outer", t=t, i=i):
                with tr.span("inner", t=t, i=i):
                    tr.event("tick", t=t, i=i)

    ts = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    tr.close()
    recs = read_trace(path)
    spans = {r["id"]: r for r in recs if r["kind"] == "span"}
    events = [r for r in recs if r["kind"] == "event"]
    assert len(spans) == 2 * n_threads * n_spans
    assert len(events) == n_threads * n_spans
    ids = [r["id"] for r in recs if "id" in r]
    assert len(ids) == len(set(ids))
    for s in spans.values():
        if s["name"] == "inner":
            parent = spans[s["parent"]]
            assert parent["name"] == "outer"
            assert parent["attrs"] == s["attrs"]
    for e in events:
        assert spans[e["parent"]]["attrs"] == e["attrs"]


def test_phase_timer_report_is_the_jax_format():
    t = PhaseTimer()
    with t.phase("train"):
        pass
    t.add("train", 1.25)
    t.add("predict", 0.5)
    acc = {k: v for k, v in t.asdict().items() if k != "total"}
    assert list(acc) == ["train", "predict"] and t["train"] >= 1.25
    assert ttrace.render_phase_lines(acc, 3.0) == j_render_phase_lines(acc,
                                                                      3.0)
    assert t.report().splitlines()[-1].startswith("elapsed time: ")


def test_phase_timer_writes_phase_spans(tmp_path):
    path = str(tmp_path / "phases.jsonl")
    with Tracer(path, clock=FakeClock(), wall=lambda: 0.0) as tr:
        t = PhaseTimer(tracer=tr)
        with t.phase("warmup"):
            pass
    (span,) = [r for r in read_trace(path) if r["kind"] == "span"]
    assert span["name"] == "warmup" and span["attrs"] == {"phase": True}


# ------------------------------------------------------------------- fleet
def _registry_from(reg_cls, seed):
    rng = np.random.default_rng(seed)
    reg = reg_cls()
    for j in range(int(rng.integers(2, 5))):
        reg.counter("serve.ok", model=f"m{j}").inc(int(rng.integers(0, 50)))
        reg.counter("serve.errors", model=f"m{j}").inc(
            int(rng.integers(0, 3)))
        reg.gauge("serve.queue_depth", model=f"m{j}").set(
            float(rng.integers(0, 9)))
        h = reg.histogram("serve.latency_s", model=f"m{j}")
        for v in rng.random(int(rng.integers(1, 20))) / 50:
            h.observe(float(v))
    reg.counter("router.requests").inc(int(rng.integers(0, 100)))
    return reg


def _payloads(seed, reg_cls=MetricsRegistry, make=snapshot_payload):
    out = []
    for i, role in enumerate(("serve", "serve", "router", "pod-worker")):
        reg = _registry_from(reg_cls, seed * 10 + i)
        if role == "pod-worker":
            reg.counter("pod.worker_requests").inc(5 + i)
            reg.gauge("pod.live_shards").set(2)
        status = ({"models": {"m0": {"generation": 1 + i,
                                     "breaker": ("closed", "open")[i % 2],
                                     "p99_s": 0.001 * (i + 1),
                                     "burning": bool(i % 2)}}}
                  if role == "serve" else {})
        out.append(make(role, f"{role}-{i}", reg.snapshot(), status=status,
                        pid=100 + i))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_merge_and_renderers_equal_jax(seed):
    mine = _payloads(seed)
    theirs = _payloads(seed, JMetricsRegistry, jfleet.snapshot_payload)
    assert mine == theirs  # the two registries' payloads are one format
    merged = merge_fleet(mine)
    assert merged == jfleet.merge_fleet(theirs)
    assert tfleet.tag_snapshot(mine[0]["snapshot"], role="x") \
        == jfleet.tag_snapshot(theirs[0]["snapshot"], role="x")
    # label-disjoint after tagging: the merged serve.ok total is the sum
    total = sum(e["value"] for p in mine for e in p["snapshot"]["metrics"]
                if e["name"] == "serve.ok")
    assert sum(e["value"] for e in merged["metrics"]
               if e["name"] == "serve.ok") == total
    errors = {"http://dead:1": "URLError: refused"}
    view = FleetView(mine, errors, merged, 12.0)
    jview = jfleet.FleetView(theirs, errors, jfleet.merge_fleet(theirs), 12.0)
    assert render_fleet_text(view) == jfleet.render_fleet_text(jview)
    assert json.dumps(tfleet.fleet_json(view), sort_keys=True) \
        == json.dumps(jfleet.fleet_json(jview), sort_keys=True)
    rates = {("serve", "serve-0"): {"qps": 2.5}}
    rows = top_rows(view, rates)
    assert rows == jfleet.top_rows(jview, rates)
    assert format_top(rows, errors=errors, clock_s=3.0) \
        == jfleet.format_top(rows, errors=errors, clock_s=3.0)
    assert merge_fleet([]) == jfleet.merge_fleet([])


def test_fleet_labels_beat_process_local_labels():
    reg = MetricsRegistry()
    reg.counter("serve.ok", instance="imposter").inc(2)
    p = snapshot_payload("serve", "r-real", reg.snapshot())
    (entry,) = [e for e in merge_fleet([p])["metrics"]
                if e["name"] == "serve.ok"]
    assert entry["labels"]["instance"] == "r-real"


def test_format_top_golden():
    reg = MetricsRegistry()
    reg.counter("serve.ok").inc(7)
    p1 = snapshot_payload(
        "serve", "r-1", reg.snapshot(), pid=42,
        status={"models": {"m": {"generation": 3, "breaker": "closed",
                                 "p99_s": 0.0123, "burning": False}}})
    reg = MetricsRegistry()
    reg.counter("pod.worker_requests").inc(5)
    reg.gauge("pod.live_shards").set(2)
    p2 = snapshot_payload("pod-worker", "w0", reg.snapshot(), pid=43)
    view = FleetView([p1, p2], {}, merge_fleet([p1, p2]), 12.0)
    rows = top_rows(view, rates={("serve", "r-1"): {"qps": 2.5}})
    text = format_top(rows, errors={"http://dead": "URLError: x"},
                      clock_s=12.0)
    assert text == (
        "tpusvm fleet — 2 process(es) — t=12.0s\n"
        "ROLE        INSTANCE  PID  GEN  REQS  QPS  P99MS  BURN  BREAKER  SHARDS\n"
        "pod-worker  w0        43   -    5     -    -      -     -        2\n"
        "serve       r-1       42   3    7     2.5  12.3   no    closed   -\n"
        "! http://dead: URLError: x\n"
    )


def test_fleet_collectors_give_jax_rates_views_and_errors():
    count = {"n": 0}
    out = []
    for coll_cls, make, reg_cls in (
            (FleetCollector, snapshot_payload, MetricsRegistry),
            (jfleet.FleetCollector, jfleet.snapshot_payload,
             JMetricsRegistry)):
        def src(make=make, reg_cls=reg_cls):
            reg = reg_cls()
            reg.counter("serve.ok").inc(count["n"])
            return make("serve", "r-1", reg.snapshot(), pid=1)

        def dead():
            raise OSError("connection refused")

        clk = iter([10.0, 12.0])
        coll = coll_cls(clock=lambda clk=clk: next(clk))
        coll.add_callable(src, name="r-1")
        coll.add_callable(dead, name="dead")
        count["n"] = 5
        v1 = coll.scrape_once()
        assert coll.rates() == {}  # no deltas before a second scrape
        count["n"] = 9
        v2 = coll.scrape_once()
        assert v2.merged == jfleet.merge_fleet(v2.processes)
        assert coll.view() is v2
        out.append((v1.errors, v2.errors, v2.processes, v2.merged,
                    coll.rates()))
    assert out[0] == out[1]
    assert out[0][4] == {("serve", "r-1"): {"qps": 2.0, "serve.ok": 2.0}}
    assert "OSError" in out[0][0]["dead"]


def test_fleet_collector_thread_is_a_daemon_that_stop_joins():
    reg = MetricsRegistry()
    coll = FleetCollector()
    coll.add_callable(lambda: snapshot_payload("serve", "r-1",
                                               reg.snapshot()), name="r-1")
    with coll:
        coll.start(interval_s=60.0)  # the first scrape is synchronous
        assert coll.view() is not None
        assert coll._thread is not None and coll._thread.daemon
        with pytest.raises(RuntimeError, match="already started"):
            coll.start()
        with pytest.raises(ValueError, match="interval_s"):
            FleetCollector().start(interval_s=0)
    assert coll._thread is None


def test_snapshot_file_roundtrip_and_payload_gates(tmp_path):
    p = _payloads(3)[0]
    path = str(tmp_path / "drop.json")
    write_snapshot_file(path, p)
    assert read_snapshot_file(path) == p
    assert jfleet.read_snapshot_file(path) == p
    with pytest.raises(ValueError, match="v"):
        parse_payload({**p, "v": 999})
    with pytest.raises(ValueError, match="role"):
        parse_payload({"v": 1, "instance": "x", "snapshot": p["snapshot"]})
    with pytest.raises(ValueError):
        parse_payload("not a dict")
    with pytest.raises(ValueError, match="snapshot version"):
        snapshot_payload("serve", "r-1", {"v": 99, "metrics": []})


def test_collector_scrapes_replica_router_and_file_sources(tmp_path):
    """add_replica/add_router/add_file over fetch stubs: the router's page
    is adopted process by process."""
    ps = _payloads(4)
    path = str(tmp_path / "ap.json")
    write_snapshot_file(path, ps[3])
    pages = {"http://r1/metrics.json": ps[0],
             "http://rt/fleet/metrics.json": {"v": 1, "processes": ps[1:3],
                                              "errors": {}},
             "http://bad/fleet/metrics.json": {"v": 1}}

    def fetch(url, timeout_s=0.0):
        return pages[url]

    coll = (FleetCollector(fetch=fetch, clock=lambda: 1.0)
            .add_replica("http://r1/").add_router("http://rt")
            .add_file(path).add_router("http://bad"))
    view = coll.scrape_once()
    assert view.processes == ps[:4]
    assert list(view.errors) == ["http://bad"]
    assert "not a fleet page" in view.errors["http://bad"]


# ------------------------------------------------ serve HTTP and the router
def test_serve_http_exports_fleet_payload_and_traced_spans(tmp_path):
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.http import make_http_server, start_http_thread

    X, Y = rings(n=96, seed=1)
    model = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu").fit(X, Y)
    srv = Server(ServeConfig(max_batch=8), device="cpu")
    srv.add_model("m", model)
    srv.warmup()
    tracer = Tracer(str(tmp_path / "serve.jsonl"), role="serve")
    httpd = make_http_server(srv, port=0)
    assert httpd.tpusvm_tracer is None
    httpd.tpusvm_tracer = tracer
    srv.attach_http(httpd, start_http_thread(httpd))
    host, port = httpd.server_address[:2]
    base = f"http://{host}:{port}"
    ctx = TraceContext(trace_id="deadbeef", span_id=7, role="router", pid=1)
    try:
        with urllib.request.urlopen(base + "/metrics.json",
                                    timeout=10) as resp:
            payload = jfleet.parse_payload(json.loads(resp.read()))
        assert payload["role"] == "serve"
        assert payload["instance"] == srv.replica_id
        for headers in ({TRACE_HEADER: ctx.to_header()},
                        {TRACE_HEADER: "junk"}, {}):
            body = json.dumps(
                {"instances": np.asarray(X[:2], float).tolist()}).encode()
            req = urllib.request.Request(
                base + "/v1/models/m:predict", data=body,
                headers={"Content-Type": "application/json", **headers},
                method="POST")
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert resp.status == 200
    finally:
        srv.close()
        tracer.close()
    spans = [r for r in jtrace.read_trace(tracer.path)
             if r["kind"] == "span" and r["name"] == "serve.request"]
    assert len(spans) == 3
    assert all(s["attrs"]["model"] == "m" and s["attrs"]["rows"] == 2
               for s in spans)
    # the propagated context landed verbatim; junk and absent headers
    # give a span with no context
    assert [s["attrs"].get("ctx") for s in spans] == [ctx.to_dict(), None,
                                                      None]


def _replica_health(url, timeout_s=0.0):
    return {"status": "ok", "replica_id": "r-x", "uptime_s": 1.0,
            "models": {"m": "closed"}, "swap": {"m": {"generation": 1}},
            "slo": {}}


def test_router_injects_trace_header_and_keeps_3arg_transport(tmp_path):
    from tpusvm_torch.router import Router, RouterConfig

    calls = []

    def transport4(url, body, timeout_s, headers):
        calls.append((url, headers))
        return 200, b"{}", None

    tracer = Tracer(str(tmp_path / "router.jsonl"), role="router",
                    trace_id="rtid")
    r = Router(RouterConfig(replicas=("http://a",), replication=1,
                            poll_interval_s=10.0),
               transport=transport4, fetch=_replica_health,
               registry=MetricsRegistry(), log_fn=None, tracer=tracer)
    r.poller.poll_once()
    inbound = TraceContext(trace_id="cli", span_id=2, role="client", pid=5)
    code, _, _ = r.forward("m", b"{}", ctx=inbound)
    assert code == 200
    (_, headers), = calls
    out = TraceContext.from_header(headers[TRACE_HEADER])
    # the outbound context is the ROUTER's, minted inside router.forward
    assert out.role == "router" and out.trace_id == "rtid"
    r.poller.stop()
    tracer.close()
    (fwd,) = [s for s in read_trace(tracer.path)
              if s["kind"] == "span" and s["name"] == "router.forward"]
    assert fwd["attrs"]["ctx"] == inbound.to_dict()
    assert fwd["id"] == out.span_id

    calls3 = []

    def transport3(url, body, timeout_s):
        calls3.append(url)
        return 200, b"{}", None

    r2 = Router(RouterConfig(replicas=("http://a",), replication=1,
                             poll_interval_s=10.0),
                transport=transport3, fetch=_replica_health,
                registry=MetricsRegistry(), log_fn=None)
    r2.poller.poll_once()
    # a tracer-less router passes an inbound context through unchanged,
    # which needs the 4-argument transport; without one it calls 3
    assert r2.forward("m", b"{}")[0] == 200 and calls3
    payload = parse_payload(r2.fleet_payload())
    assert payload["role"] == "router"
    assert payload["instance"] == f"router-{os.getpid()}"
    r2.poller.stop()


# ---------------------------------------------------- the command lines
def test_fleet_metrics_smoke_exits_zero(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tpusvm_torch", "fleet-metrics", "--smoke",
         "-q", "--device", "cpu"], capture_output=True, text=True,
        cwd=tmp_path, env=ENV, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "fleet-metrics smoke ok" in out.stdout


def test_fleet_metrics_and_top_read_snapshot_files(tmp_path, capsys):
    from tpusvm_torch.cli import main

    paths = []
    for i, p in enumerate(_payloads(5)):
        paths.append(str(tmp_path / f"p{i}.json"))
        write_snapshot_file(paths[-1], p)
    srcs = [x for p in paths for x in ("--snapshot-file", p)]
    assert main(["fleet-metrics", "--format", "json", *srcs]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["merged"] == merge_fleet(_payloads(5))
    assert main(["fleet-metrics", *srcs]) == 0
    text = capsys.readouterr().out
    assert text.startswith("# fleet: 4 process(es), 0 error(s)")
    assert main(["top", "--once", *srcs]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 5 and rows[0].startswith("ROLE")
    assert main(["top", "--iterations", "2", "--interval-s", "0.01",
                 "--no-clear", *srcs]) == 0
    assert capsys.readouterr().out.count("tpusvm fleet — 4 process(es)") == 2
    with pytest.raises(SystemExit, match="no fleet sources"):
        main(["top", "--once"])
    # a fleet entirely unreachable is an error
    assert main(["fleet-metrics", "--snapshot-file",
                 str(tmp_path / "absent.json")]) == 1
