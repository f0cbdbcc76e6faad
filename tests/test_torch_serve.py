"""tpusvm_torch.serve on the CPU, mirroring tests/test_serve.py,
tests/test_slo.py and the breaker and degraded-mode tests of
tests/test_faults.py, with the JAX package's objects beside the port's
where the two must agree.

Bands: a served score equals the port's own decision_function on the same
rows BIT FOR BIT, at every row count 1..max_batch, for binary, one-vs-rest,
SVR, poly and rff models, in-process and over HTTP (there are no bucket
floors: every scorer call runs full 2048-row products). The statuses, the
bucket tables, the breaker's transitions and Metrics' snapshot and text for
one event sequence equal the JAX package's exactly.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpusvm.faults.breaker import CircuitBreaker as JCircuitBreaker
from tpusvm.serve import Metrics as JMetrics
from tpusvm.serve import bucket_for as j_bucket_for
from tpusvm.serve import default_buckets as j_default_buckets
from tpusvm.serve.metrics import SLOConfig as JSLOConfig
from tpusvm.status import ServeStatus as JServeStatus
from tpusvm_torch import faults
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC
from tpusvm_torch.serve import (Metrics, MicroBatcher, ServeConfig, Server,
                                SLOConfig, bucket_for, default_buckets)
from tpusvm_torch.serve.http import (make_http_server, start_http_thread,
                                     stop_http_server)
from tpusvm_torch.status import ServeStatus

CFG = SVMConfig(C=10.0, gamma=10.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def binary_model():
    X, Y = rings(n=300, seed=2)
    return BinarySVC(CFG, device="cpu", dtype=torch.float64).fit(X, Y)


def _four_class_data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [6, 0], [0, 6], [6, 6]], float)
    labels = rng.integers(0, 4, n)
    X = centers[labels] + rng.normal(0, 0.8, (n, 2))
    return X, labels.astype(np.int32)


def _server(**kw):
    dtype = kw.pop("dtype", torch.float64)
    return Server(ServeConfig(**kw), dtype=dtype, device="cpu")


def _models():
    """The task/family matrix of served models, each with query rows."""
    from tpusvm_torch.data import blobs, svr_sine

    X, Y = rings(n=240, seed=2)
    Xq, _ = rings(n=40, seed=3)
    Xc, lc = _four_class_data(n=300, seed=0)
    Xcq, _ = _four_class_data(n=40, seed=1)
    Xs, ts = svr_sine(n=200, d=1, noise=0.05, seed=3)
    Xsq, _ = svr_sine(n=40, d=1, noise=0.05, seed=44)
    Xb, Yb = blobs(n=200, d=4, seed=5)
    return {
        "binary": (lambda: BinarySVC(CFG, device="cpu").fit(X, Y), Xq),
        "ovr": (lambda: OneVsRestSVC(SVMConfig(C=10.0, gamma=2.0),
                                     solver="blocked", device="cpu")
                .fit(Xc, lc), Xcq),
        "svr": (lambda: EpsilonSVR(SVMConfig(C=10.0, gamma=20.0,
                                             epsilon=0.1), device="cpu")
                .fit(Xs, ts), Xsq),
        "poly": (lambda: BinarySVC(SVMConfig(C=1.0, gamma=1.0, kernel="poly",
                                             degree=2, coef0=1.0),
                                   device="cpu").fit(Xb, Yb), Xb[:40]),
        "rff": (lambda: BinarySVC(SVMConfig(C=10.0, gamma=10.0, kernel="rff",
                                            rff_dim=128), device="cpu")
                .fit(X, Y), Xq),
    }


# ---------------------------------------------------------------- buckets
def test_default_buckets_and_lookup_equal_jax():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(1) == (1,)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    for cap in (1, 2, 3, 8, 12, 64, 100):
        assert default_buckets(cap) == j_default_buckets(cap)
    for m in range(1, 9):
        assert bucket_for(m, (1, 2, 4, 8)) == j_bucket_for(m, (1, 2, 4, 8))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        bucket_for(9, (1, 2, 4, 8))
    with pytest.raises(ValueError, match="max_batch"):
        default_buckets(0)
    with pytest.raises(ValueError, match="do not cover"):
        ServeConfig(max_batch=16, buckets=(1, 2, 4)).resolved_buckets()


def test_serve_status_values_equal_jax():
    assert {s.name: int(s) for s in ServeStatus} == \
        {s.name: int(s) for s in JServeStatus}


# ----------------------------------------------------- bit-identity + load
def test_concurrent_submits_bit_identical_and_compile_free(binary_model):
    """Eight client threads of single-row submits come back bit-identical
    to decision_function, with zero errors and zero post-warm-up builds."""
    Xt, _ = rings(n=64, seed=3)
    ref = binary_model.decision_function(Xt)
    ref_labels = binary_model.predict(Xt)
    with _server(max_batch=8, max_delay_ms=2.0) as srv:
        srv.add_model("rings", binary_model)
        # no floors: every power-of-two bucket down to a lone row
        assert srv.status()["models"]["rings"]["buckets"] == [1, 2, 4, 8]
        assert srv.warmup()["rings"] == 4
        assert srv.warmup()["rings"] == 0  # idempotent
        n_threads, per_thread = 8, 24
        results = {}

        def client(t):
            results[t] = [srv.submit("rings", Xt[(t * per_thread + i) % 64])
                          for i in range(per_thread)]

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        for t, out in results.items():
            for i, r in enumerate(out):
                idx = (t * per_thread + i) % 64
                assert r.ok, r.status
                assert r.scores == ref[idx]          # bitwise
                assert r.label == ref_labels[idx]
        snap = srv.metrics("rings")
        st = srv.status()["models"]["rings"]
        assert snap["errors"] == 0 and snap["timeouts"] == 0
        assert snap["recompiles"] == 0 and st["recompiles"] == 0
        assert snap["ok"] == n_threads * per_thread
        assert st["compiled_shapes"] == len(st["buckets"])
        assert st["graphed"] is False  # the CPU runs the programs eagerly


@pytest.mark.parametrize("kind", ["binary", "ovr", "svr", "poly", "rff"])
def test_every_row_count_bit_equal_to_decision_function(kind, tmp_path):
    """submit_many, predict_direct and an HTTP POST at every row count
    1..max_batch, and single submits, equal decision_function on the same
    rows (and the rows' slice of one call over all of them) bit for bit;
    the artifact loaded from disk serves the same bits as the estimator."""
    make, Xq = _models()[kind]
    est = make()
    whole = np.asarray(est.decision_function(Xq))
    path = str(tmp_path / "m.npz")
    est.save(path)
    with Server(ServeConfig(max_batch=8), device="cpu") as srv:
        srv.add_model("est", est)
        srv.load_model("disk", path)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        url = (f"http://127.0.0.1:{httpd.server_address[1]}"
               "/v1/models/disk:predict")
        for m in range(1, 9):
            rows = Xq[3:3 + m]
            want = np.asarray(est.decision_function(rows))
            assert want.tobytes() == whole[3:3 + m].tobytes()
            for name in ("est", "disk"):
                res = srv.submit_many(name, rows)
                assert all(r.ok for r in res)
                got = np.stack([np.asarray(r.scores) for r in res])
                assert got.tobytes() == want.tobytes(), (name, m)
                direct, labels = srv.predict_direct(name, rows)
                assert direct.tobytes() == want.tobytes(), (name, m)
            posted = _post(url, {"instances": rows.tolist()})["scores"]
            assert np.asarray(posted, want.dtype).tobytes() == \
                want.tobytes(), ("http", m)
        one = srv.submit("disk", Xq[5])
        assert one.ok and np.asarray(one.scores).tobytes() == \
            whole[5].tobytes()
        if kind == "ovr":
            assert np.array_equal(srv.predict_direct("disk", Xq)[1],
                                  est.predict(Xq))
        elif kind == "svr":
            s, lab = srv.predict_direct("disk", Xq)
            assert np.array_equal(s, lab)  # the value IS the score
        else:
            assert np.array_equal(srv.predict_direct("disk", Xq)[1],
                                  est.predict(Xq))
        assert srv.metrics("disk")["recompiles"] == 0
        assert srv.registry.get("disk").kind == \
            {"ovr": "ovr", "svr": "svr"}.get(kind, "binary")


def test_submit_many_coalesces_and_matches_direct(binary_model):
    Xt, _ = rings(n=40, seed=4)
    ref = binary_model.decision_function(Xt)
    with _server(max_batch=8) as srv:
        srv.add_model("rings", binary_model)
        srv.warmup()
        res = srv.submit_many("rings", Xt)
        assert all(r.ok for r in res)
        np.testing.assert_array_equal(np.array([r.scores for r in res]), ref)
        snap = srv.metrics("rings")
        assert snap["batches"] >= 5
        assert snap["mean_batch_rows"] > 1.5
        scores, labels = srv.predict_direct("rings", Xt)
        np.testing.assert_array_equal(scores, ref)
        np.testing.assert_array_equal(labels, binary_model.predict(Xt))


def test_unwarmed_server_builds_lazily_without_recompiles(binary_model):
    Xt, _ = rings(n=8, seed=5)
    with _server(max_batch=8) as srv:
        srv.add_model("rings", binary_model)
        assert srv.submit("rings", Xt[0]).ok
        st = srv.status()["models"]["rings"]
        assert st["compiles"] >= 1 and st["recompiles"] == 0
        assert not st["warmed"]
        assert srv.warmup()["rings"] == len(st["buckets"]) - \
            st["compiled_shapes"]


# ------------------------------------------------- backpressure / deadlines
def _slow_run_batch(delay_s):
    def run(X):
        time.sleep(delay_s)
        return np.zeros(X.shape[0]), np.ones(X.shape[0], np.int32)
    return run


def test_queue_full_fast_fails():
    metrics = Metrics(buckets=(1,))
    b = MicroBatcher(_slow_run_batch(0.2), max_batch=1, max_delay_s=0.0,
                     queue_size=2, timeout_s=5.0, metrics=metrics)
    try:
        row = np.zeros(2)
        done = threading.Event()
        t = threading.Thread(target=lambda: (b.submit(row), done.set()))
        t.start()
        time.sleep(0.05)  # the worker is now inside run_batch
        statuses = []
        lock = threading.Lock()

        def enqueue():
            r = b.submit(row)
            with lock:
                statuses.append(r.status)

        threads = [threading.Thread(target=enqueue) for _ in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10.0)
        t.join(10.0)
        assert ServeStatus.QUEUE_FULL in statuses
        assert metrics.snapshot()["queue_full"] >= 1
        assert done.is_set()
    finally:
        b.close()


def test_request_timeout_and_dead_on_arrival_drop():
    metrics = Metrics(buckets=(1, 2, 4))
    calls = []

    def run(X):
        calls.append(X.shape[0])
        time.sleep(0.15)
        return np.zeros(X.shape[0]), np.ones(X.shape[0], np.int32)

    b = MicroBatcher(run, max_batch=4, max_delay_s=0.0, queue_size=16,
                     timeout_s=0.05, metrics=metrics)
    try:
        row = np.zeros(2)
        held = []
        t = threading.Thread(target=lambda: held.append(b.submit(row)))
        t.start()
        time.sleep(0.03)
        r2 = b.submit(row)
        t.join(10.0)
        assert held[0].status == ServeStatus.TIMEOUT
        assert r2.status == ServeStatus.TIMEOUT
        time.sleep(0.3)
        assert metrics.snapshot()["timeouts"] == 2
        assert sum(calls) == 1  # the dead-on-arrival row was never scored
    finally:
        b.close()


def test_closed_batcher_returns_shutdown():
    b = MicroBatcher(_slow_run_batch(0.0), max_batch=2, max_delay_s=0.0,
                     queue_size=4)
    b.close()
    assert b.submit(np.zeros(2)).status == ServeStatus.SHUTDOWN


def test_server_close_under_concurrent_submit_load(binary_model):
    Xt, _ = rings(n=16, seed=7)
    srv = _server(max_batch=4, max_delay_ms=1.0, timeout_ms=2000.0)
    srv.add_model("rings", binary_model)
    srv.warmup()
    n_threads, per_thread = 8, 40
    results = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def client(t):
        start.wait()
        for i in range(per_thread):
            results[t].append(srv.submit("rings", Xt[i % 16]))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    time.sleep(0.02)
    t0 = time.monotonic()
    srv.close()
    close_s = time.monotonic() - t0
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert close_s < 6.0
    flat = [r for chunk in results for r in chunk]
    assert len(flat) == n_threads * per_thread
    assert {r.status for r in flat} <= {ServeStatus.OK, ServeStatus.SHUTDOWN,
                                        ServeStatus.TIMEOUT,
                                        ServeStatus.QUEUE_FULL}
    assert any(r.ok for r in flat)
    assert any(r.status == ServeStatus.SHUTDOWN for r in flat)


def test_scoring_error_fails_requests_not_worker():
    metrics = Metrics(buckets=(1, 2))
    state = {"boom": True}

    def run(X):
        if state["boom"]:
            raise RuntimeError("kernel exploded")
        return np.zeros(X.shape[0]), np.ones(X.shape[0], np.int32)

    b = MicroBatcher(run, max_batch=2, max_delay_s=0.0, queue_size=8,
                     timeout_s=1.0, metrics=metrics)
    try:
        assert b.submit(np.zeros(2)).status == ServeStatus.ERROR
        assert metrics.snapshot()["errors"] == 1
        state["boom"] = False
        assert b.submit(np.zeros(2)).ok
    finally:
        b.close()


def test_submit_validates_rows(binary_model):
    with _server(max_batch=2) as srv:
        srv.add_model("rings", binary_model)
        with pytest.raises(ValueError, match="features"):
            srv.submit("rings", np.zeros(5))
        with pytest.raises(ValueError, match="one row"):
            srv.submit("rings", np.zeros((3, 2)))
        with pytest.raises(KeyError, match="unknown model"):
            srv.submit("nope", np.zeros(2))
        with pytest.raises(ValueError, match="already registered"):
            srv.add_model("rings", binary_model)


def test_server_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(ServeConfig())


# ---------------------------------------------------------------- metrics
def _events(m):
    m.inc("requests", 3)
    m.inc("ok", 2)
    m.inc("errors")
    m.inc("overloaded", 4)
    m.observe_batch(2, 2)
    m.observe_batch(4, 3)
    m.observe_batch(16, 9)  # a late-registered bucket (direct chunking)
    for v in (0.001, 0.002, 0.003):
        m.observe_latency(v)


def test_metrics_snapshot_and_text_equal_jax():
    m, jm = Metrics(buckets=(1, 2, 4)), JMetrics(buckets=(1, 2, 4))
    _events(m)
    _events(jm)
    snap = m.snapshot()
    assert snap == jm.snapshot()
    assert snap["requests"] == 3 and snap["ok"] == 2
    assert snap["batch_occupancy"]["4"]["mean_rows"] == 3.0
    assert snap["latency_s"]["p50"] == 0.002
    json.dumps(snap)
    assert m.render_text(labels='model="m"') == \
        jm.render_text(labels='model="m"')
    assert 'tpusvm_serve_requests_total{model="m"} 3' in m.render_text(
        labels='model="m"')


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_slo_snapshot_equals_jax_and_window_slides():
    clock, jclock = FakeClock(), FakeClock()
    m = Metrics(buckets=(1, 2), slo=SLOConfig(p99_ms=5.0, window_s=10.0),
                clock=clock)
    jm = JMetrics(buckets=(1, 2), slo=JSLOConfig(p99_ms=5.0, window_s=10.0),
                  clock=jclock)
    for mm in (m, jm):
        for _ in range(4):
            mm.observe_latency(0.050)
        mm.inc("ok", 4)
    assert m.snapshot() == jm.snapshot()
    st = m.slo_status()
    assert st["burning"] and st["latency_burn"] == pytest.approx(100.0)
    clock.t += 11.0
    st = m.slo_status()
    assert st["latency_burn"] == 0.0 and not st["burning"]
    assert st["window_requests"] == 0


def test_error_burn_counts_failures_not_shedding():
    m = Metrics(buckets=(1,), slo=SLOConfig(p99_ms=1000.0, error_budget=0.1,
                                            window_s=60.0),
                clock=FakeClock())
    m.inc("ok", 9)
    m.inc("errors", 1)
    m.inc("overloaded", 50)
    m.inc("queue_full", 50)
    st = m.slo_status()
    assert st["error_burn"] == pytest.approx(1.0)
    assert st["burning"] and st["window_requests"] == 10


def test_slo_validation_and_no_slo_shape():
    with pytest.raises(ValueError):
        SLOConfig(p99_ms=0.0).validate()
    with pytest.raises(ValueError):
        SLOConfig(p99_ms=1.0, error_budget=1.5).validate()
    with pytest.raises(ValueError):
        ServeConfig(slo_shed=True).resolved_slo()
    assert ServeConfig().resolved_slo() is None
    assert ServeConfig(slo_p99_ms=5.0).resolved_slo().p99_ms == 5.0
    m = Metrics(buckets=(1,))
    m.inc("ok", 3)
    m.observe_latency(0.5)
    assert "slo" not in m.snapshot() and m.slo_status() is None
    assert "slo" not in m.render_text()


LATENCY_PLAN = {"format_version": 1, "seed": 7,
                "rules": [{"point": "serve.score", "kind": "latency",
                           "p": 1.0, "delay_ms": 40.0}]}


def test_latency_fault_plan_degrades_healthz_within_one_window(binary_model):
    X, _ = rings(n=8, seed=3)
    plan = faults.FaultPlan.from_json(LATENCY_PLAN)
    with _server(max_batch=4, slo_p99_ms=5.0, slo_window_s=60.0) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        assert srv.health()["status"] == "ok"
        with faults.active(plan):
            for i in range(6):
                assert srv.submit("m", X[i]).ok
        h = srv.health()
        assert h["status"] == "degraded"
        assert h["slo"]["m"]["burning"] is True
        text = srv.metrics_text()
        assert 'tpusvm_serve_slo_latency_burn{model="m"}' in text
        assert 'tpusvm_serve_slo_burning{model="m"} 1' in text
        names = {e["name"] for e in
                 srv._worker("m").metrics.registry_snapshot()["metrics"]}
        assert "serve.slo_latency_burn" in names


def test_slo_shed_feeds_admission_control(binary_model):
    X, _ = rings(n=8, seed=3)
    plan = faults.FaultPlan.from_json(dict(LATENCY_PLAN, rules=[
        dict(LATENCY_PLAN["rules"][0], max_hits=6)]))
    with _server(max_batch=4, slo_p99_ms=5.0, slo_window_s=60.0,
                 slo_shed=True) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        with faults.active(plan):
            for i in range(6):
                if not srv.submit("m", X[i]).ok:
                    break
        r = srv.submit("m", X[0])
        assert ServeStatus(r.status) == ServeStatus.OVERLOADED
        assert srv.metrics("m")["overloaded"] >= 1


def test_healthy_traffic_stays_ok(binary_model):
    X, _ = rings(n=8, seed=3)
    with _server(max_batch=4, slo_p99_ms=2000.0, slo_window_s=60.0) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        for i in range(8):
            assert srv.submit("m", X[i]).ok
        h = srv.health()
        assert h["status"] == "ok" and h["slo"]["m"]["burning"] is False


# ---------------------------------------------------------------- breaker
def _breaker_run(cls):
    clock = {"t": 0.0}
    events, states = [], []
    br = cls(threshold=3, cooldown_s=10.0, name="m",
             clock=lambda: clock["t"], listener=events.append)
    steps = [("f",), ("f",), ("s",), ("f",), ("f",), ("f",), ("a",),
             ("t", 10.0), ("a",), ("a",), ("f",), ("a",), ("t", 20.0),
             ("a",), ("s",), ("a",)]
    for step in steps:
        if step[0] == "f":
            br.record_failure()
        elif step[0] == "s":
            br.record_success()
        elif step[0] == "a":
            states.append(br.allow())
        else:
            clock["t"] = step[1]
        states.append(br.state)
    return events, states, br.describe(), br.snapshot()


def test_breaker_trip_halfopen_recover_and_reopen_equal_jax():
    events, states, desc, snap = _breaker_run(faults.CircuitBreaker)
    assert (events, states, desc, snap) == _breaker_run(JCircuitBreaker)
    assert events == ["tripped", "half_open", "reopened", "half_open",
                      "recovered"]
    assert desc["state"] == "closed" and desc["trips"] == 1
    assert desc["recoveries"] == 1
    br = faults.CircuitBreaker(threshold=2)
    br.restore(snap)
    assert br.snapshot() == snap
    with pytest.raises(ValueError):
        br.restore(dict(snap, state="bogus"))
    with pytest.raises(ValueError):
        faults.CircuitBreaker(threshold=0)


def _rule(**kw):
    return faults.FaultRule(**kw)


def test_serve_transient_scoring_faults_are_retried(binary_model):
    Xq, _ = rings(n=8, seed=3)
    plan = faults.FaultPlan([_rule(point="serve.score", kind="transient",
                                   max_hits=2)])
    with _server(max_batch=4, score_retries=3) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        ref = srv.predict_direct("m", Xq)[0]
        with faults.active(plan):
            res = srv.submit_many("m", Xq)
        assert all(r.ok for r in res)
        np.testing.assert_array_equal(np.array([r.scores for r in res]), ref)
        snap = srv.metrics("m")
        assert snap["retries"] >= 1 and snap["errors"] == 0
        assert snap["breaker_trips"] == 0


def test_serve_breaker_trips_sheds_fast_and_recovers(binary_model):
    Xq, _ = rings(n=4, seed=3)
    events = []
    faults.set_event_sink(lambda name, **kw: events.append(name))
    plan = faults.FaultPlan([_rule(point="serve.score", kind="transient",
                                   max_hits=2)])
    try:
        with _server(max_batch=4, score_retries=0, breaker_threshold=2,
                     breaker_cooldown_s=0.3) as srv:
            srv.add_model("m", binary_model)
            srv.warmup()
            with faults.active(plan):
                assert srv.submit("m", Xq[0]).status == ServeStatus.ERROR
                assert srv.submit("m", Xq[1]).status == ServeStatus.ERROR
                assert srv.health()["status"] == "degraded"
                assert srv.health()["models"]["m"] == "open"
                t0 = time.monotonic()
                r3 = srv.submit("m", Xq[2])
                assert r3.status == ServeStatus.UNAVAILABLE
                assert time.monotonic() - t0 < 0.5
                snap = srv.metrics("m")
                assert snap["breaker_trips"] == 1 and snap["unavailable"] >= 1
                time.sleep(0.35)
                assert srv.submit("m", Xq[3]).ok
                assert srv.health()["models"]["m"] == "closed"
                assert srv.metrics("m")["breaker_recoveries"] == 1
    finally:
        faults.set_event_sink(None)
    assert {"fault.injected", "breaker.tripped",
            "breaker.recovered"} <= set(events)


def test_microbatcher_sheds_overloaded_beyond_threshold():
    metrics = Metrics(buckets=(1,))
    release = threading.Event()

    def slow(X):
        release.wait(2.0)
        return np.zeros(X.shape[0]), np.ones(X.shape[0], np.int32)

    b = MicroBatcher(slow, max_batch=1, max_delay_s=0.0, queue_size=8,
                     timeout_s=5.0, metrics=metrics, shed_at=2)
    try:
        results, threads = [], []
        lock = threading.Lock()

        def fire():
            r = b.submit(np.zeros(2))
            with lock:
                results.append(r.status)

        t = threading.Thread(target=fire)
        t.start()
        threads.append(t)
        time.sleep(0.05)
        for _ in range(6):
            th = threading.Thread(target=fire)
            th.start()
            threads.append(th)
            time.sleep(0.01)
        release.set()
        for th in threads:
            th.join(5.0)
        assert ServeStatus.OVERLOADED in results
        assert metrics.snapshot()["overloaded"] >= 1
        assert results.count(ServeStatus.OK) >= 1
    finally:
        release.set()
        b.close()


def test_server_drain_completes_inflight_then_refuses(binary_model):
    Xq, _ = rings(n=8, seed=4)
    with _server(max_batch=4) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        inflight = []
        t = threading.Thread(
            target=lambda: inflight.extend(srv.submit_many("m", Xq)))
        t.start()
        assert srv.drain(timeout_s=5.0)
        t.join(5.0)
        assert all(r.status in (ServeStatus.OK, ServeStatus.DRAINING)
                   for r in inflight)
        assert srv.submit("m", Xq[0]).status == ServeStatus.DRAINING
        assert srv.health()["status"] == "draining"
        assert srv.status()["draining"] is True


# ------------------------------------------------------------------- HTTP
def _post(url, obj, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Tpusvm-Trace": "ignored"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def test_http_endpoint_roundtrip(binary_model):
    from tpusvm.obs.fleet import parse_payload as j_parse_payload
    from tpusvm_torch.obs.fleet import parse_payload

    Xt, _ = rings(n=70, seed=6)
    ref_scores = binary_model.decision_function(Xt)
    with _server(max_batch=8) as srv:
        srv.add_model("rings", binary_model)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        # POSTs of every size 1..8 rows, and one past the top bucket
        i = 0
        for k in list(range(1, 9)) + [34]:
            resp = _post(f"{base}/v1/models/rings:predict",
                         {"instances": Xt[i:i + k].tolist()})
            assert resp["statuses"] == ["OK"] * k
            got = np.asarray(resp["scores"])
            assert got.tobytes() == ref_scores[i:i + k].tobytes()
            np.testing.assert_array_equal(
                np.asarray(resp["predictions"]),
                binary_model.predict(Xt[i:i + k]))
            i += k
        health = json.loads(_get(f"{base}/healthz"))
        assert health["status"] == "ok"
        assert health["models"] == {"rings": "closed"}
        text = _get(f"{base}/metrics").decode()
        assert 'tpusvm_serve_ok_total{model="rings"} 70' in text
        models = json.loads(_get(f"{base}/v1/models"))
        assert models["models"]["rings"]["recompiles"] == 0
        assert json.loads(_get(f"{base}/v1/models/rings/metrics"))["ok"] == 70
        payload = json.loads(_get(f"{base}/metrics.json"))
        assert parse_payload(payload) == j_parse_payload(payload)
        assert payload["role"] == "serve"
        assert payload["status"]["models"]["rings"]["generation"] == 1
        body = json.dumps({"instances": Xt[:2].tolist()}).encode()
        for url, data, code in (
                (f"{base}/v1/models/nope:predict", body, 404),
                (f"{base}/v1/models/rings:predict", b"not json", 400),
                (f"{base}/nowhere", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    url, data=data,
                    headers={"Content-Type": "application/json"}),
                    timeout=30.0)
            assert ei.value.code == code


def test_http_proba_field_matches_predict_proba():
    X, Y = rings(n=240, seed=1)
    cal = BinarySVC(CFG, device="cpu", dtype=torch.float64).fit(X, Y)
    cal.calibrate(X, Y, folds=2, seed=0)
    plain = BinarySVC(CFG, device="cpu", dtype=torch.float64).fit(X, Y)
    Xq, _ = rings(n=6, seed=8)
    ref = cal.predict_proba(Xq)[:, 1]
    with _server(max_batch=8) as srv:
        srv.add_model("cal", cal)
        srv.add_model("plain", plain)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        thread = start_http_thread(httpd)
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            resp = _post(f"{base}/v1/models/cal:predict",
                         {"instances": Xq.tolist()})
            np.testing.assert_array_equal(np.asarray(resp["proba"]), ref)
            assert "proba" not in _post(f"{base}/v1/models/plain:predict",
                                        {"instances": Xq.tolist()})
        finally:
            stop_http_server(httpd, thread)
        assert srv.status()["models"]["cal"]["calibrated"] is True
        assert srv.status()["models"]["plain"]["calibrated"] is False


def test_http_healthz_drain_and_degraded_codes(binary_model):
    Xq, _ = rings(n=4, seed=5)
    with _server(max_batch=4) as srv:
        srv.add_model("m", binary_model)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert json.loads(_get(f"{base}/healthz"))["status"] == "ok"
        resp = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"{base}/admin/drain", data=b"", method="POST"),
            timeout=30.0).read())
        assert resp == {"drained": True}
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=30.0)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/v1/models/m:predict", {"instances": Xq.tolist()})
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["statuses"] == ["DRAINING"] * 4


# -------------------------------------------------------------------- CLI
def test_cli_serve_smoke_in_process(tmp_path, capsys, binary_model):
    from tpusvm_torch.cli import main

    p = str(tmp_path / "m.npz")
    binary_model.save(p)
    rc = main(["serve", "--model", f"rings={p}", "--smoke", "--max-batch",
               "8", "--smoke-threads", "4", "--smoke-requests", "8",
               "--dtype", "float64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "loaded rings: binary" in out
    assert "warmed rings: 4 bucket programs built" in out
    assert ("0 errors, 0 recompiles" in out
            and "decision_function: bit-equal" in out)
    assert 'tpusvm_serve_ok_total{model="rings"} 32' in out


def test_cli_serve_refuses_trace_and_nothing_to_host(tmp_path, capsys):
    from tpusvm_torch.cli import main
    from tpusvm_torch.obs.trace import read_trace

    # --trace works: a role-serve trace with the warm-up and smoke phases,
    # one compile record a bucket build and the final metrics; --profile
    # writes a torch.profiler trace of the smoke (the name is kept)
    path = str(tmp_path / "t.jsonl")
    assert main(["serve", "--smoke", "--trace", path, "--smoke-threads", "2",
                 "--smoke-requests", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bit-equal" in out
    built = int(re.search(r"warmed rings: (\d+) bucket programs built",
                          out).group(1))
    recs = read_trace(path)
    assert recs[0]["kind"] == "meta" and recs[0]["role"] == "serve"
    assert recs[0]["argv"] == ["serve"] and recs[-1]["kind"] == "end"
    phases = [r["name"] for r in recs if r["kind"] == "span"]
    assert phases == ["warmup", "smoke"]
    assert {r["name"] for r in recs if r["kind"] == "event"} == {
        "serve.metrics", "metrics.snapshot", "prof.compile"}
    compiles = [r["attrs"] for r in recs
                if r["kind"] == "event" and r["name"] == "prof.compile"]
    assert len({c["bucket"] for c in compiles}) == len(compiles) == built
    assert all(c["cost_available"] is False for c in compiles)
    prof_dir = str(tmp_path / "prof")
    assert main(["serve", "--smoke", "--profile", prof_dir,
                 "--smoke-threads", "2", "--smoke-requests", "4",
                 "--device", "cpu"]) == 0
    assert os.path.getsize(os.path.join(prof_dir, "trace.json")) > 0
    for argv, msg in ((["serve", "--device", "cpu"], "nothing to host"),
                      (["serve", "--smoke", "--assert-cached"],
                       "--cache-dir")):
        with pytest.raises(SystemExit, match=msg):
            main(argv + ["--device", "cpu"] if argv[-1] != "cpu" else argv)
