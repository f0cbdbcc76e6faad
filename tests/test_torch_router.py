"""tpusvm_torch.router on the CPU, held against the JAX package's router
(tests/test_router.py's contracts) on the same scripted inputs.

Bands: exact everywhere on the router's own outputs. RouterStatus values,
HRW scores, placements and table bytes, the health poller's state
sequence and records, admission orders, rollout posts (their order
included) and SkewReport JSON, and every forwarding case's (code, body,
Retry-After, attempted URLs, counters) equal the JAX package's. Scores
served through a port router equal the artifact's decision_function bit
for bit; across packages (a port router in front of a JAX replica, a JAX
router in front of a port replica, both float64) they agree within 1e-9
absolute, the cross-package score band of tests/test_torch_swap.py.
Inputs are drawn with numpy from a seed; the HTTP servers bind ephemeral
ports on 127.0.0.1.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm import faults as jfaults
from tpusvm import router as jrouter
from tpusvm.config import SVMConfig as JSVMConfig
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm.obs.registry import MetricsRegistry as JMetricsRegistry
from tpusvm.serve import ServeConfig as JServeConfig
from tpusvm.serve import Server as JServer
from tpusvm.serve.http import make_http_server as j_make_http_server
from tpusvm.serve.http import start_http_thread as j_start_http_thread
from tpusvm.status import RouterStatus as JRouterStatus
from tpusvm_torch import faults
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC, load_any
from tpusvm_torch.obs.registry import MetricsRegistry
from tpusvm_torch.obs.trace import (TRACE_HEADER, TraceContext, Tracer,
                                    read_trace)
from tpusvm_torch.router import (HealthPoller, ReplicaSet, Router,
                                 RouterConfig, check_skew, generation_vector,
                                 hrw_score, make_router_http, place,
                                 placement_table, skew_of, staggered_rollout,
                                 table_bytes)
from tpusvm_torch.serve import ServeConfig, Server
from tpusvm_torch.serve.http import make_http_server, start_http_thread
from tpusvm_torch.status import RouterStatus

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- subprocess gates, early
# started when the module's first test runs and awaited by their own
# cases, so the command lines run beside the in-process tests
GATES = {
    "router-smoke": (("tpusvm_torch", "router", "--smoke"),
                     "router smoke ok"),
    "router-chaos-smoke": (("tpusvm_torch.faults", "router-chaos-smoke"),
                           "router chaos smoke ok"),
}


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    td = tmp_path_factory.mktemp("router_gates")
    procs = {}
    for name, (args, _) in GATES.items():
        out = open(td / f"{name}.out", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", *args, "--device", "cpu"], cwd=td,
            stdout=out, stderr=subprocess.STDOUT, env=ENV), out)
    yield td, procs
    for p, out in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()


def test_gates_start(gates):
    _, procs = gates
    assert all(p.poll() in (None, 0) for p, _ in procs.values())


# -------------------------------------------------------------- statuses
@pytest.mark.parametrize("name", [s.name for s in JRouterStatus])
def test_router_status_values_equal_jax(name):
    assert int(RouterStatus[name]) == int(JRouterStatus[name])
    assert [s.name for s in RouterStatus] == [s.name for s in JRouterStatus]


# ------------------------------------------------------------- placement
def _names(seed, n_keys=60, n_replicas=5):
    rng = np.random.default_rng(seed)
    keys = [f"model-{int(v)}" for v in rng.integers(0, 10**6, n_keys)]
    urls = [f"http://10.0.{int(a)}.{int(b)}:{int(p)}"
            for a, b, p in zip(rng.integers(0, 255, n_replicas),
                               rng.integers(1, 255, n_replicas),
                               rng.integers(1024, 65535, n_replicas))]
    return keys, urls


@pytest.mark.parametrize("seed", [0, 3, 7, 20260806])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_placement_bytes_equal_jax(seed, k):
    keys, urls = _names(seed)
    for key in keys[:10]:
        for u in urls:
            assert hrw_score(key, u, seed) == jrouter.hrw_score(key, u, seed)
        assert place(key, urls, k=k, seed=seed) == jrouter.place(
            key, urls, k=k, seed=seed)
    mine = table_bytes(placement_table(keys, urls, k=k, seed=seed))
    assert mine == jrouter.table_bytes(jrouter.placement_table(
        keys, urls, k=k, seed=seed))
    # container types do not matter; another seed is another table
    assert mine == table_bytes(placement_table(tuple(keys), tuple(urls),
                                               k=k, seed=seed))
    assert mine != table_bytes(placement_table(keys, urls, k=k,
                                               seed=seed + 1))


@pytest.mark.parametrize("seed", [1, 5])
def test_join_and_leave_move_the_same_keys_as_jax(seed):
    keys, urls = _names(seed, n_keys=200, n_replicas=6)
    for k in (1, 2):
        before = placement_table(keys, urls, k=k, seed=seed)
        leaver = urls[2]
        rest = [u for u in urls if u != leaver]
        after = placement_table(keys, rest, k=k, seed=seed)
        moved = sorted(x for x in keys if after[x] != before[x])
        j_after = jrouter.placement_table(keys, rest, k=k, seed=seed)
        j_before = jrouter.placement_table(keys, urls, k=k, seed=seed)
        assert moved == sorted(x for x in keys if j_after[x] != j_before[x])
        # only the leaver's keys moved
        assert all(leaver in before[x] for x in moved)
    before = placement_table(keys, urls, k=1, seed=seed)
    joined = urls + ["http://10.9.9.9:1"]
    after = placement_table(keys, joined, k=1, seed=seed)
    moved = [x for x in keys if after[x] != before[x]]
    assert all(after[x] == (joined[-1],) for x in moved)
    assert len(moved) <= 2.5 * len(keys) / len(joined)
    j_after = jrouter.placement_table(keys, joined, k=1, seed=seed)
    assert moved == [x for x in keys if j_after[x] != before[x]]


def test_place_validation_and_small_fleets():
    with pytest.raises(ValueError, match="replication factor"):
        place("m", ["a"], k=0)
    with pytest.raises(ValueError, match="replication factor"):
        ReplicaSet(("a",), k=0)
    with pytest.raises(ValueError, match="replication"):
        RouterConfig(replicas=("a",), replication=0)
    assert set(place("m", ["a", "b"], k=5)) == {"a", "b"}
    assert hrw_score("c", "ab") != hrw_score("bc", "a")


def test_replica_set_views_equal_jax():
    logs = ([], [])
    sets = [cls(("b", "a", "a"), k=1, seed=0,
                listener=lambda v, log=log: log.append((v.version,
                                                        v.replicas)))
            for cls, log in zip((ReplicaSet, jrouter.ReplicaSet), logs)]
    for rs in sets:
        assert rs.replicas() == ("a", "b") and rs.version == 1
        assert rs.join("c") and not rs.join("c")
        assert rs.leave("a") and not rs.leave("zz")
    assert logs[0] == logs[1] == [(1, ("a", "b")), (2, ("a", "b", "c")),
                                  (3, ("b", "c"))]
    assert sets[0].placement("m") == sets[1].placement("m")
    assert ReplicaSet((), k=1).placement("m") == ()


# ---------------------------------------------------------------- health
def _payload(status="ok", gen=1, burning=(), breakers=None,
             replica_id="r-x", uptime=12.5):
    return {
        "status": status,
        "replica_id": replica_id,
        "uptime_s": uptime,
        "models": breakers or {"m": "closed"},
        "swap": {"m": {"generation": gen}},
        "slo": {name: {"burning": True} for name in burning},
    }


def _script(seed, urls, n_polls):
    """Per (poll, replica): a healthz payload or a refusal, drawn from a
    seed: ok, degraded, draining, ok-but-burning, a failed poll."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(5, size=(n_polls, len(urls)),
                       p=[0.4, 0.15, 0.1, 0.1, 0.25])
    gens = rng.integers(1, 4, size=(n_polls, len(urls)))
    out = []
    for i in range(n_polls):
        row = {}
        for j, u in enumerate(urls):
            kind = int(kinds[i, j])
            if kind == 4:
                row[u] = ConnectionRefusedError("refused")
            else:
                row[u] = _payload(
                    status=("ok", "degraded", "draining", "ok")[kind],
                    gen=int(gens[i, j]), burning=("m",) if kind == 3 else (),
                    replica_id=f"r-{j}", uptime=float(i))
        out.append(row)
    return out


def _scripted_fetch(script, step):
    def fetch(url, timeout_s=0.0):
        out = script[step[0]][url]
        if isinstance(out, Exception):
            raise out
        return out
    return fetch


def _rec(r):
    return (r.url, r.state, r.replica_id, r.uptime_s, r.generations,
            r.breakers, r.burning, r.failures, r.polls, r.last_error)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("down_after", [1, 2, 3])
def test_health_poller_state_sequence_equals_jax(seed, down_after):
    urls = [f"http://r{j}" for j in range(4)]
    script = _script(seed, urls, 12)
    step = [0]
    pollers = [cls(urls, interval_s=0.05, down_after=down_after,
                   fetch=_scripted_fetch(script, step), registry=reg())
               for cls, reg in ((HealthPoller, MetricsRegistry),
                                (jrouter.HealthPoller, JMetricsRegistry))]
    for i in range(len(script)):
        step[0] = i
        states = [p.poll_once() for p in pollers]
        assert states[0] == states[1]
        snaps = [p.snapshot() for p in pollers]
        assert {u: _rec(r) for u, r in snaps[0].items()} \
            == {u: _rec(r) for u, r in snaps[1].items()}
        placed, fallback = urls[:2], urls[1:]
        assert pollers[0].admissible(placed, fallback) \
            == pollers[1].admissible(placed, fallback)
        regs = [p._registry.snapshot() for p in pollers]
        assert regs[0] == regs[1]


def test_health_grace_window_and_never_polled():
    state = {"fail": False}

    def flaky(url, timeout_s=0.0):
        if state["fail"]:
            raise ConnectionRefusedError("refused")
        return _payload()

    p = HealthPoller(("a",), interval_s=0.05, down_after=2, fetch=flaky,
                     registry=MetricsRegistry())
    assert p.poll_once() == {"a": "ok"}
    state["fail"] = True
    assert p.poll_once() == {"a": "ok"}        # one blip keeps the state
    assert p.poll_once() == {"a": "down"}
    state["fail"] = False
    assert p.poll_once() == {"a": "ok"}
    q = HealthPoller(("a",), interval_s=0.05, down_after=3, fetch=flaky,
                     registry=MetricsRegistry())
    state["fail"] = True
    assert q.poll_once() == {"a": "down"}      # never polled: no grace
    with pytest.raises(ValueError, match="interval_s"):
        HealthPoller(("a",), interval_s=0.0, registry=MetricsRegistry())
    with pytest.raises(ValueError, match="down_after"):
        HealthPoller(("a",), down_after=0, registry=MetricsRegistry())


def test_health_poller_thread_is_a_daemon_that_stop_joins():
    p = HealthPoller(("a",), interval_s=0.01, fetch=lambda u, timeout_s: (
        _payload()), registry=MetricsRegistry())
    p.start()
    t = p._thread
    assert t.daemon and t.is_alive()
    with pytest.raises(RuntimeError, match="already started"):
        p.start()
    time.sleep(0.05)
    p.stop()
    assert not t.is_alive() and p._thread is None


# ------------------------------------------------------------------ skew
class _Rec:
    def __init__(self, state="ok", polls=1, gens=None):
        self.state = state
        self.polls = polls
        self.generations = gens or {}


def test_generation_vector_and_skew_equal_jax():
    snap = {
        "a": _Rec(gens={"m": 3}),
        "b": _Rec(gens={"m": 5}),
        "c": _Rec(state="down", gens={"m": 9}),
        "d": _Rec(polls=0),
        "e": _Rec(gens={}),
    }
    vec = generation_vector(snap, "m")
    assert vec == jrouter.generation_vector(snap, "m") == {
        "a": 3, "b": 5, "c": None, "d": None, "e": None}
    assert skew_of(vec) == jrouter.skew_of(vec) == 2
    for w in (0, 1, 2, 3):
        assert check_skew(snap, "m", window=w).to_json() \
            == jrouter.check_skew(snap, "m", window=w).to_json()
    with pytest.raises(ValueError, match="window"):
        check_skew({}, "m", window=-1)


def _rollout_case(name):
    """(fetches over mutable generations, post) for one scenario."""
    if name == "clean":
        gens = {"a": 1, "b": 1, "c": 1}
        fetches = {u: (lambda u=u: _payload(gen=gens[u])) for u in gens}
        fail = ()
    elif name == "skew_hold":
        gens = {"a": 1, "b": 4}
        fetches = {u: (lambda u=u: _payload(gen=gens[u])) for u in gens}
        fail = ()
    else:  # a down replica skipped, a 409 recorded
        gens = {"a": 1, "b": 1}
        fetches = {"a": lambda: _payload(gen=gens["a"]),
                   "b": lambda: _payload(gen=gens["b"]),
                   "c": lambda: ConnectionRefusedError("dead")}
        fail = ("b",)
    posts = []

    def post(url, obj, timeout_s=0.0):
        posts.append((url, json.dumps(obj, sort_keys=True)))
        base = url[:-len("/admin/swap")]
        if base in fail:
            return 409, {"error": "stage failed, rolled back"}
        gens[base] += 1
        return 200, {"swapped": True, "generation": gens[base]}

    def fetch(url, timeout_s=0.0):
        out = fetches[url]()
        if isinstance(out, Exception):
            raise out
        return out

    return fetch, post, posts, sorted(fetches)


@pytest.mark.parametrize("case", ["clean", "skew_hold", "down_and_409"])
def test_staggered_rollout_equals_jax(case):
    outs, all_posts = [], []
    for poller_cls, reg, roll in (
            (HealthPoller, MetricsRegistry, staggered_rollout),
            (jrouter.HealthPoller, JMetricsRegistry,
             jrouter.staggered_rollout)):
        fetch, post, posts, urls = _rollout_case(case)
        p = poller_cls(urls, interval_s=0.05, down_after=1, fetch=fetch,
                       registry=reg())
        outs.append(roll(p, "m", "/x/v2.npz", window=1, post=post))
        all_posts.append(posts)
    assert outs[0] == outs[1]
    assert all_posts[0] == all_posts[1]
    out, posts = outs[0], all_posts[0]
    if case == "clean":
        assert out["status"] == RouterStatus.OK.name
        # non-idempotent: exactly one POST per replica, in sorted order
        assert [u for u, _ in posts] == [u + "/admin/swap"
                                         for u in ("a", "b", "c")]
    elif case == "skew_hold":
        assert out["status"] == RouterStatus.SKEW_HOLD.name and posts == []
    else:
        assert out["swapped"] == ["a"] and out["skipped"] == ["c"]
        assert "409" in out["failed"]["b"]


# ----------------------------------------------------------------- proxy
def _routers(fetches, transport, **cfg_kw):
    """The port's and the JAX package's Router over the same stubs."""
    cfg_kw.setdefault("replicas", tuple(sorted(fetches)))
    cfg_kw.setdefault("replication", 2)
    cfg_kw.setdefault("poll_interval_s", 10.0)

    def fetch(url, timeout_s=0.0):
        out = fetches[url]
        if isinstance(out, Exception):
            raise out
        return out

    out = []
    for cls, cfg_cls, reg in ((Router, RouterConfig, MetricsRegistry),
                              (jrouter.Router, jrouter.RouterConfig,
                               JMetricsRegistry)):
        r = cls(cfg_cls(**cfg_kw), transport=transport, fetch=fetch,
                registry=reg(), log_fn=None)
        r.poller.poll_once()
        out.append(r)
    return out


def _metrics(router):
    snap = router._registry.snapshot()["metrics"]
    return sorted((m["name"], sorted(m["labels"].items()), m["value"])
                  for m in snap if m["name"].startswith("router."))


FORWARD_CASES = ["success", "failover_connection", "failover_503",
                 "backpressure_429", "all_down", "no_replica", "fault_point"]


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_forward_cases_equal_jax(case):
    ok2 = {"http://a": _payload(), "http://b": _payload()}
    calls = []
    fetches, cfg = ok2, {}
    plan_rules = None
    # each package's router retries its own package's transient class
    fmods = [faults]

    def transport(url, body, timeout_s):
        calls.append(url)
        first = len(calls) % 2 == 1
        if case == "failover_connection" and first:
            raise fmods[0].TransientIOError("refused")
        if case == "failover_503" and first:
            return 503, b'{"error": "half-dead"}', None
        if case == "backpressure_429":
            return 429, b'{"error": "OVERLOADED"}', None
        if case == "all_down":
            raise fmods[0].TransientIOError("refused")
        return 200, b'{"scores": [1.5]}', None

    if case == "no_replica":
        fetches, cfg = {"http://a": ConnectionRefusedError("dead")}, {
            "down_after": 1}
    if case == "fault_point":
        plan_rules = dict(point="router.forward", kind="transient", p=1.0,
                          max_hits=1)
    got = []
    for r, fmod in zip(_routers(fetches, transport, **cfg),
                       (faults, jfaults)):
        del calls[:]
        fmods[0] = fmod
        if plan_rules is not None:
            plan = fmod.FaultPlan([fmod.FaultRule(**plan_rules)])
            with fmod.active(plan):
                res = r.forward("m", b'{"instances": [[0, 0]]}')
            hits = plan.hits("router.forward")
        else:
            res = r.forward("m", b'{"instances": [[0, 0]]}')
            hits = None
        got.append((res, list(calls), _metrics(r), hits))
        r.poller.stop()
    assert got[0] == got[1]
    (code, data, ra), attempted, counters, hits = got[0]
    c = {name: v for name, _, v in counters if name != "router.forwards"}
    if case == "success":
        assert (code, ra) == (200, None) and len(attempted) == 1
        assert c["router.failovers"] == 0
    elif case.startswith("failover"):
        assert code == 200 and len(attempted) == 2
        assert c["router.failovers"] == 1 and c["router.retries"] == 1
    elif case == "backpressure_429":
        assert (code, ra) == (429, "1") and len(attempted) == 1
    elif case == "all_down":
        assert code == 503 and json.loads(data)["router"] == "ALL_DOWN"
    elif case == "no_replica":
        assert code == 503 and json.loads(data)["router"] == "NO_REPLICA"
        assert c["router.no_replica"] == 1 and attempted == []
    else:
        # the injected transient is absorbed by failover
        assert code == 200 and hits == 2 and c["router.failovers"] == 1


def test_router_status_and_health_rollup():
    def transport(url, body, timeout_s):
        return 200, b"{}", None

    r, j = _routers({}, transport, replicas=())
    assert r.status_code() == RouterStatus.NO_REPLICA
    assert r.health() == j.health() and r.health()["status"] == "down"
    for x in (r, j):
        x.poller.stop()
    r, j = _routers({"http://a": ConnectionRefusedError("dead")}, transport,
                    down_after=1)
    assert r.status_code() == RouterStatus.ALL_DOWN
    assert int(r.status_code()) == int(j.status_code())
    for x in (r, j):
        x.poller.stop()
    r, j = _routers({"http://a": _payload()}, transport)
    assert r.status_code() == RouterStatus.OK
    for x in (r, j):
        with x._lock:
            x._holds["m"] = {"skew": 2}
    assert r.status_code() == RouterStatus.SKEW_HOLD
    h = r.health()
    assert h == j.health()
    assert h["status"] == "degraded" and h["holds"]["m"]["skew"] == 2
    assert r.replica_detail() == j.replica_detail()
    for x in (r, j):
        x.poller.stop()


def test_router_rollout_sets_and_clears_hold(monkeypatch):
    import tpusvm_torch.router.proxy as proxy_mod

    outcomes = [
        {"status": RouterStatus.SKEW_HOLD.name, "swapped": [],
         "skipped": [], "failed": {}, "report": {"skew": 2}},
        {"status": RouterStatus.OK.name, "swapped": ["http://a"],
         "skipped": [], "failed": {}, "report": {"skew": 0}},
    ]
    seen = []

    def stub(poller, model, path, window=1, **kw):
        seen.append((model, path, window))
        return outcomes[len(seen) - 1]

    monkeypatch.setattr(proxy_mod, "staggered_rollout", stub)
    r, j = _routers({"http://a": _payload()}, lambda *a: (200, b"{}", None),
                    skew_window=2)
    j.poller.stop()
    assert r.rollout("m", "/x.npz")["status"] == "SKEW_HOLD"
    assert r.holds() == {"m": {"skew": 2}}
    assert r.status_code() == RouterStatus.SKEW_HOLD
    assert r.rollout("m", "/x.npz", window=1)["status"] == "OK"
    assert not r.holds() and r.status_code() == RouterStatus.OK
    assert seen == [("m", "/x.npz", 2), ("m", "/x.npz", 1)]
    r.poller.stop()


# -------------------------------------------- HTTP front door, end to end
def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _post(url, obj, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _serve_http(srv, tracer=None, jax=False):
    mk, st = ((j_make_http_server, j_start_http_thread) if jax
              else (make_http_server, start_http_thread))
    httpd = mk(srv, port=0)
    httpd.tpusvm_tracer = tracer
    srv.attach_http(httpd, st(httpd))
    host, port = httpd.server_address[:2]
    return f"http://{host}:{port}"


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two in-process port replicas (rings n=240, CPU) with serve tracers,
    behind a port router with a router tracer and its HTTP front."""
    td = tmp_path_factory.mktemp("router_fleet")
    X, Y = rings(n=240, seed=2)
    path = str(td / "m.npz")
    BinarySVC(SVMConfig(C=10.0, gamma=10.0), device="cpu").fit(X, Y).save(
        path)
    servers, urls, tracers = [], [], []
    for i in range(2):
        srv = Server(ServeConfig(max_batch=8), device="cpu")
        srv.load_model("m", path)
        srv.warmup()
        tr = Tracer(str(td / f"serve{i}.jsonl"), role="serve")
        urls.append(_serve_http(srv, tr))
        servers.append(srv)
        tracers.append(tr)
    rtr = Tracer(str(td / "router.jsonl"), role="router")
    router = Router(RouterConfig(replicas=tuple(urls), replication=2,
                                 seed=3, poll_interval_s=10.0),
                    registry=MetricsRegistry(), log_fn=None, tracer=rtr)
    router.poller.poll_once()
    httpd = make_router_http(router, port=0)
    router.attach_http(httpd, start_http_thread(httpd))
    host, port = httpd.server_address[:2]
    yield dict(servers=servers, router=router, base=f"http://{host}:{port}",
               path=path, tracers=tracers, rtracer=rtr, urls=urls)
    router.close()
    for srv in servers:
        srv.close()
    for tr in tracers + [rtr]:
        tr.close()


def test_router_http_predict_and_introspection(fleet):
    base = fleet["base"]
    Xq, _ = rings(n=11, seed=3)
    want = np.asarray(load_any(fleet["path"], device="cpu")
                      .decision_function(Xq))
    code, out = _post(base + "/v1/models/m:predict",
                      {"instances": np.asarray(Xq, float).tolist()})
    assert code == 200
    assert np.asarray(out["scores"], np.float32).tobytes() == want.tobytes()
    code, h = _get(base + "/healthz")
    assert code == 200 and h["router"] == "OK"
    assert set(h["replicas"].values()) == {"ok"}
    code, detail = _get(base + "/v1/replicas")
    assert code == 200 and len(detail) == 2
    ids = {rec["replica_id"] for rec in detail.values()}
    assert ids == {s.replica_id for s in fleet["servers"]}
    for rec in detail.values():
        assert rec["state"] == "ok" and rec["generations"] == {"m": 1}
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert "tpusvm_router_requests_total" in text
    assert "tpusvm_router_forwards_total" in text
    code, err = _post(base + "/admin/rollout", {"name": "m"})
    assert code == 400 and "path" in err["error"]
    code, err = _post(base + "/v1/nothing", {})
    assert code == 404


def test_router_http_join_leave(fleet):
    base, router = fleet["base"], fleet["router"]
    v0 = router.replica_set.version
    code, out = _post(base + "/admin/join", {"url": "http://10.9.9.9:1"})
    assert code == 200 and out["changed"] and out["version"] == v0 + 1
    code, out = _post(base + "/admin/join", {"url": "http://10.9.9.9:1"})
    assert not out["changed"] and out["version"] == v0 + 1
    code, out = _post(base + "/admin/leave", {"url": "http://10.9.9.9:1"})
    assert code == 200 and out["changed"] and out["version"] == v0 + 2
    assert "http://10.9.9.9:1" not in router.replica_set.replicas()
    code, err = _post(base + "/admin/join", {})
    assert code == 400


def test_trace_header_is_injected_and_honoured(fleet):
    """A predict carrying a client context: the router's router.forward
    span records it, the replica's serve.request span records the context
    the router minted inside that span (trace_id and span id)."""
    base, rtr = fleet["base"], fleet["rtracer"]
    client = TraceContext(trace_id="c11e47", span_id=4, role="client", pid=7)
    Xq, _ = rings(n=3, seed=4)
    for i in range(3):
        code, _ = _post(base + "/v1/models/m:predict",
                        {"instances": [np.asarray(Xq[i], float).tolist()]},
                        headers={TRACE_HEADER: client.to_header()})
        assert code == 200
    fwd = {r["id"]: r for r in read_trace(rtr.path)
           if r["kind"] == "span" and r["name"] == "router.forward"}
    mine = [r for r in fwd.values() if r["attrs"].get("ctx")
            == client.to_dict()]
    assert len(mine) == 3
    served = [r for tr in fleet["tracers"] for r in read_trace(tr.path)
              if r["kind"] == "span" and r["name"] == "serve.request"]
    parented = [s for s in served
                if s["attrs"].get("ctx", {}).get("span_id")
                in {r["id"] for r in mine}]
    assert len(parented) == 3
    for s in parented:
        ctx = TraceContext.from_dict(s["attrs"]["ctx"])
        assert (ctx.trace_id, ctx.role, ctx.pid) == (rtr.trace_id, "router",
                                                     os.getpid())
        assert s["attrs"]["model"] == "m" and s["attrs"]["rows"] == 1


def test_router_fleet_view_covers_every_process(fleet):
    base = fleet["base"]
    with urllib.request.urlopen(base + "/fleet/metrics", timeout=30) as r:
        text = r.read().decode()
    assert text.startswith("# fleet: 3 process(es), 0 error(s)")
    code, doc = _get(base + "/fleet/metrics.json")
    assert code == 200 and doc["v"] == 1 and not doc["errors"]
    roles = sorted(p["role"] for p in doc["processes"])
    assert roles == ["router", "serve", "serve"]
    code, me = _get(base + "/metrics.json")
    assert me["role"] == "router" and me["instance"].startswith("router-")


def test_top_once_prints_a_row_per_process(fleet):
    out = subprocess.run(
        [sys.executable, "-m", "tpusvm_torch", "top", "--once", "--router",
         fleet["base"]], capture_output=True, text=True, env=ENV, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].split()[:3] == ["ROLE", "INSTANCE", "PID"]
    assert sorted(x.split()[0] for x in lines[1:]) == ["router", "serve",
                                                       "serve"]
    assert {x.split()[1] for x in lines[1:] if x.startswith("serve")} \
        == {s.replica_id for s in fleet["servers"]}


# ------------------------------------------------------ the wire across
@pytest.fixture(scope="module")
def twin_replicas(tmp_path_factory):
    """One artifact (float64) served by a port replica and a JAX replica."""
    td = tmp_path_factory.mktemp("router_wire")
    X, Y = rings(n=240, seed=2)
    path = str(td / "m.npz")
    JBinarySVC(JSVMConfig(C=10.0, gamma=10.0), dtype=jnp.float64).fit(
        X, Y).save(path)
    ps = Server(ServeConfig(max_batch=8), dtype=torch.float64, device="cpu")
    ps.load_model("m", path)
    ps.warmup()
    js = JServer(JServeConfig(max_batch=8), dtype=jnp.float64)
    js.load_model("m", path)
    js.warmup()
    urls = {"port": _serve_http(ps), "jax": _serve_http(js, jax=True)}
    yield urls, path
    ps.close()
    js.close()


@pytest.mark.parametrize("front,back", [("port", "jax"), ("jax", "port")])
def test_a_router_of_one_package_fronts_a_replica_of_the_other(
        twin_replicas, front, back):
    urls, path = twin_replicas
    cls, cfg_cls, reg = ((Router, RouterConfig, MetricsRegistry)
                         if front == "port" else
                         (jrouter.Router, jrouter.RouterConfig,
                          JMetricsRegistry))
    r = cls(cfg_cls(replicas=(urls[back],), replication=1,
                    poll_interval_s=10.0), registry=reg(), log_fn=None)
    try:
        assert r.poller.poll_once() == {urls[back]: "ok"}
        assert r.health()["router"] == "OK"
        Xq, _ = rings(n=9, seed=5)
        code, data, _ = r.forward("m", json.dumps(
            {"instances": np.asarray(Xq, float).tolist()}).encode())
        assert code == 200
        got = np.asarray(json.loads(data)["scores"], np.float64)
        if back == "port":
            other = np.asarray(JBinarySVC.load(path, dtype=jnp.float64)
                               .decision_function(Xq))
        else:
            other = np.asarray(load_any(path, device="cpu",
                                        dtype=torch.float64)
                               .decision_function(Xq))
        # the other package's scores, within the cross-package band
        np.testing.assert_allclose(got, other, rtol=0, atol=1e-9)
    finally:
        r.poller.stop()


def test_the_smokes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    from tpusvm_torch.cli import main

    for argv in (["router", "--smoke"], ["fleet-metrics", "--smoke"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


# ------------------------------------------------- subprocess gates, last
@pytest.mark.parametrize("name", list(GATES))
def test_router_command_line_gates_exit_zero(gates, name):
    td, procs = gates
    p, out = procs[name]
    try:
        p.wait(timeout=240)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    out.flush()
    text = (td / f"{name}.out").read_text()
    assert p.returncode == 0, text[-3000:]
    assert GATES[name][1] in text
