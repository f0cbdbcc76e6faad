"""Hot-swap, persisted state, the watcher and the refresh in tpusvm_torch,
on the CPU, mirroring tests/test_swap.py.

Bands: under swap load every response is bitwise one generation's score;
serve_state.json and the deployed seeds are the JAX package's bit for bit
(a state written by either package restores in the other); the port's
refresh_fit against JAX's on the same rows is the repo's cross-engine
criterion (the same SV-ID set and status, b within 1e-4; one-vs-rest and
SVR: every head's status and SV set, b within 1e-4), and the warm arm takes
fewer updates than the cold one in both packages; a refresh killed at any
checkpoint resumes bit for bit.
"""

import json
import os
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm.models import OneVsRestSVC as JOvR
from tpusvm.models.svr import EpsilonSVR as JSVR
from tpusvm.serve import ServeConfig as JServeConfig
from tpusvm.serve import Server as JServer
from tpusvm.serve.cache import save_serve_state as j_save_state
from tpusvm.serve.refresh import refresh_fit as j_refresh_fit
from tpusvm.tune.warm import deployed_seed as j_seed
from tpusvm.tune.warm import deployed_seed_ovr as j_seed_ovr
from tpusvm.tune.warm import deployed_seed_svr as j_seed_svr
from tpusvm_torch import faults
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.serve import ModelLoadError, ServeConfig, Server
from tpusvm_torch.serve.cache import (CACHE_MANIFEST_NAME, load_serve_state,
                                      read_cache_manifest, record_signatures,
                                      save_serve_state)
from tpusvm_torch.serve.refresh import refresh_fit, swap_via_http
from tpusvm_torch.status import ServeStatus
from tpusvm_torch.tune.warm import (deployed_seed, deployed_seed_ovr,
                                    deployed_seed_svr)

CFG_A = SVMConfig(C=10.0, gamma=10.0)
CFG_B = SVMConfig(C=10.0, gamma=5.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_models():
    Xa, Ya = rings(n=240, seed=2)
    Xb, Yb = rings(n=240, seed=9)
    A = BinarySVC(CFG_A, device="cpu", dtype=torch.float64).fit(Xa, Ya)
    B = BinarySVC(CFG_B, device="cpu", dtype=torch.float64).fit(Xb, Yb)
    return A, B


@pytest.fixture()
def model_paths(two_models, tmp_path):
    A, B = two_models
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    A.save(pa)
    B.save(pb)
    return pa, pb


def _server(**kw):
    return Server(ServeConfig(**kw), dtype=torch.float64, device="cpu")


# ----------------------------------------------------------- atomic swap
def test_swap_flips_generation_and_scores(two_models):
    A, B = two_models
    Xq, _ = rings(n=16, seed=3)
    with _server(max_batch=8) as srv:
        srv.add_model("m", A)
        srv.warmup()
        refA, _ = srv.predict_direct("m", Xq)
        old = weakref.ref(srv._worker("m")._gen)
        out = srv.swap("m", B)
        assert out["generation"] == 2
        assert out["latency_s"] > 0 and out["staleness_before_s"] >= 0
        assert old() is None  # the replaced generation is released
        refB, _ = srv.predict_direct("m", Xq)
        assert not np.array_equal(refA, refB)
        assert np.array_equal(refB, np.asarray(B.decision_function(Xq)))
        snap = srv.metrics("m")
        assert snap["swaps"] == 1 and snap["swap_failures"] == 0
        h = srv.health()
        assert h["status"] == "ok" and h["swap"]["m"]["generation"] == 2
        st = srv.status()["models"]["m"]
        assert st["generation"] == 2 and st["last_swap"]["outcome"] == "ok"
        names = {e["name"] for e in
                 srv._worker("m").metrics.registry_snapshot()["metrics"]}
        assert {"serve.generation", "serve.staleness_s",
                "serve.swap_latency_s"} <= names


def _swap_under_load(srv, refA, refB, Xq, targets, clients=4):
    stop = threading.Event()
    bad, served = [], [0]
    lock = threading.Lock()

    def client(t):
        i = t
        while not stop.is_set():
            r = srv.submit("m", Xq[i % len(Xq)], timeout_s=10.0)
            with lock:
                if not r.ok:
                    bad.append(("status", ServeStatus(r.status).name))
                elif r.scores != refA[i % len(Xq)] and \
                        r.scores != refB[i % len(Xq)]:
                    bad.append(("torn", i % len(Xq), float(r.scores)))
                else:
                    served[0] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(clients)]
    for t in threads:
        t.start()
    for target in targets:
        srv.swap("m", target)
    stop.set()
    for t in threads:
        t.join(10.0)
    assert not any(t.is_alive() for t in threads)
    return bad, served[0]


def test_swap_under_load_no_torn_reads(two_models):
    A, B = two_models
    Xq, _ = rings(n=32, seed=3)
    with _server(max_batch=8) as srv:
        srv.add_model("m", A)
        srv.warmup()
        refA = srv.predict_direct("m", Xq)[0]
        refB = np.asarray(B.decision_function(Xq))
        assert not np.array_equal(refA, refB)
        bad, served = _swap_under_load(
            srv, refA, refB, Xq, [B if k % 2 == 0 else A for k in range(6)])
        assert not bad, bad[:10]
        assert served > 0
        assert srv.registry.generation("m") == 7
        assert srv.metrics("m")["errors"] == 0


def test_swap_under_load_rff_entries():
    X, Y = rings(n=256, seed=5)
    ma = BinarySVC(SVMConfig(C=10.0, gamma=10.0, kernel="rff", rff_dim=128,
                             map_seed=0), device="cpu").fit(X, Y)
    mb = BinarySVC(SVMConfig(C=10.0, gamma=10.0, kernel="rff", rff_dim=128,
                             map_seed=7), device="cpu").fit(X, Y)
    Xq, _ = rings(n=16, seed=6)
    with Server(ServeConfig(max_batch=4), device="cpu") as srv:
        srv.add_model("m", ma)
        srv.warmup()
        refA = np.asarray(ma.decision_function(Xq))
        refB = np.asarray(mb.decision_function(Xq))
        assert not np.array_equal(refA, refB)
        bad, _ = _swap_under_load(srv, refA, refB, Xq,
                                  [mb if k % 2 == 0 else ma
                                   for k in range(4)], clients=3)
        assert not bad, bad[:10]


def test_inflight_batch_finishes_on_its_generation(two_models):
    A, B = two_models
    Xq, _ = rings(n=8, seed=4)
    refA = np.asarray(A.decision_function(Xq))
    refB = np.asarray(B.decision_function(Xq))
    plan = faults.FaultPlan([faults.FaultRule(
        point="serve.score", kind="latency", delay_ms=50.0, max_hits=4)],
        seed=0)
    with _server(max_batch=4) as srv:
        srv.add_model("m", A)
        srv.warmup()
        results = []
        with faults.active(plan):
            t = threading.Thread(target=lambda: results.extend(
                srv.submit_many("m", Xq, timeout_s=10.0)))
            t.start()
            srv.swap("m", B)  # flips while the slow batch is in flight
            t.join(15.0)
        assert len(results) == 8
        for i, r in enumerate(results):
            assert r.ok, ServeStatus(r.status).name
            assert r.scores == refA[i] or r.scores == refB[i]


# ------------------------------------------------- failure classification
def test_load_model_corrupt_npz_is_classified(model_paths, tmp_path):
    pa, _ = model_paths
    raw = open(pa, "rb").read()
    bad = str(tmp_path / "trunc.npz")
    with open(bad, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with _server(max_batch=4) as srv:
        with pytest.raises(ModelLoadError) as ei:
            srv.load_model("x", bad)
        assert bad in str(ei.value)
        assert ei.value.status == ServeStatus.LOAD_FAILED
        with pytest.raises(ModelLoadError, match="missing.npz"):
            srv.load_model("y", str(tmp_path / "missing.npz"))
        noise = str(tmp_path / "noise.npz")
        np.savez(noise, junk=np.arange(3))
        with pytest.raises(ModelLoadError, match="format_version"):
            srv.load_model("z", noise)
        assert srv.registry.names() == []


def test_load_model_transient_io_is_retried(model_paths):
    pa, _ = model_paths
    plan = faults.FaultPlan([faults.FaultRule(
        point="registry.load", kind="transient", max_hits=2)], seed=0)
    with _server(max_batch=4) as srv:
        with faults.active(plan):
            entry = srv.load_model("m", pa)
        assert entry.n_sv > 0
        assert plan.hits("registry.load") == 3


def test_failed_swap_rolls_back_and_recovers(model_paths):
    pa, pb = model_paths
    Xq, _ = rings(n=8, seed=3)
    with _server(max_batch=4) as srv:
        srv.load_model("m", pa)
        srv.warmup()
        ref, _ = srv.predict_direct("m", Xq)
        plan = faults.FaultPlan([faults.FaultRule(
            point="registry.load", kind="corrupt", at_hit=1)], seed=3)
        with faults.active(plan):
            with pytest.raises(ModelLoadError):
                srv.swap("m", pb)
        h = srv.health()
        assert h["status"] == "degraded"
        assert h["swap"]["m"]["last_swap"]["outcome"] == "failed"
        assert srv.registry.generation("m") == 1
        assert np.array_equal(srv.predict_direct("m", Xq)[0], ref)
        assert srv.metrics("m")["swap_failures"] == 1
        srv.swap("m", pb)
        assert srv.health()["status"] == "ok"
        assert srv.registry.generation("m") == 2


def test_swap_killed_mid_stage_leaves_old_generation(model_paths):
    pa, pb = model_paths
    Xq, _ = rings(n=8, seed=3)
    plan = faults.FaultPlan([faults.FaultRule(
        point="serve.swap", kind="kill", at_hit=1)], seed=0)
    with _server(max_batch=4) as srv:
        srv.load_model("m", pa)
        srv.warmup()
        ref, _ = srv.predict_direct("m", Xq)
        with faults.active(plan):
            with pytest.raises(faults.SimulatedKill):
                srv.swap("m", pb)
        assert np.array_equal(srv.predict_direct("m", Xq)[0], ref)
        assert srv.registry.generation("m") == 1
        assert srv.health()["status"] == "ok"  # a dead stage records nothing
        srv.swap("m", pb)
        assert srv.registry.generation("m") == 2


def test_swap_unknown_model_is_keyerror(model_paths):
    pa, _ = model_paths
    with _server(max_batch=4) as srv:
        with pytest.raises(KeyError, match="unknown model"):
            srv.swap("nope", pa)


# ----------------------------------------------------------- serve state
def test_serve_state_roundtrip_with_generations(model_paths):
    pa, pb = model_paths
    state = os.path.join(os.path.dirname(pa), "serve_state.json")
    with _server(max_batch=4) as s1:
        s1.enable_state(state)
        s1.load_model("m", pa)
        s1.swap("m", pb)
        s1.swap("m", pa)
        s1.set_bound_address("127.0.0.1", 8471)
        rid = s1.replica_id
    obj = json.load(open(state))
    assert obj["format_version"] == 1
    assert obj["models"]["m"] == {"path": pa, "generation": 3}
    assert obj["address"] == "127.0.0.1:8471" and obj["replica_id"] == rid
    with _server(max_batch=4) as s2:
        rep = s2.restore_state(state)
        assert rep["restored"] == ["m"] and rep["skipped"] == []
        assert s2.registry.generation("m") == 3
        assert s2.registry.get("m").source_path == pa
        assert s2.replica_id == rid


def test_serve_state_bytes_equal_jax_and_cross_restore(model_paths,
                                                       tmp_path):
    """The same registry written by either package is the same bytes, and
    a state file written by each package's Server restores in the other."""
    pa, pb = model_paths
    args = ({"m": {"path": pa, "generation": 4}, "n": {"path": None,
                                                       "generation": 1}},)
    kw = dict(cache_dir="/c", address="127.0.0.1:9", replica_id="r-1")
    mine, theirs = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    save_serve_state(mine, *args, **kw)
    j_save_state(theirs, *args, **kw)
    assert open(mine, "rb").read() == open(theirs, "rb").read()

    Xq, _ = rings(n=8, seed=3)
    jstate, tstate = str(tmp_path / "js.json"), str(tmp_path / "ts.json")
    with JServer(JServeConfig(max_batch=4), dtype=jnp.float64) as js:
        js.enable_state(jstate)
        js.load_model("m", pa)
        js.swap("m", pb)
        jid = js.replica_id
    with _server(max_batch=4) as ts:
        rep = ts.restore_state(jstate)
        assert rep["restored"] == ["m"]
        assert ts.registry.generation("m") == 2 and ts.replica_id == jid
        ts.enable_state(tstate)
        ts.swap("m", pa)
        tid = ts.replica_id
        got = ts.predict_direct("m", Xq)[0]
    with JServer(JServeConfig(max_batch=4), dtype=jnp.float64) as js2:
        rep = js2.restore_state(tstate)
        assert rep["restored"] == ["m"]
        assert js2.registry.generation("m") == 3 and js2.replica_id == tid
        jgot = np.asarray(js2.predict_direct("m", Xq)[0])
    # the same artifact in both packages: the cross-engine score band
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-9)


def test_serve_state_corrupt_is_named(tmp_path):
    p = str(tmp_path / "serve_state.json")
    with open(p, "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        load_serve_state(p)
    with open(p, "w") as f:
        json.dump({"models": {}}, f)
    with pytest.raises(ValueError, match="format_version"):
        load_serve_state(p)
    with pytest.raises(FileNotFoundError):
        load_serve_state(str(tmp_path / "absent.json"))


def test_cache_manifest_corrupt_is_tolerated_and_read_retried(tmp_path):
    from tpusvm_torch.obs.registry import default_registry

    d = str(tmp_path)
    m = record_signatures(d, ["binary:rbf:deg3:b8:blk8:d2:sv10:float32"])
    assert len(m["signatures"]) == 1 and "torch" in m["versions"]
    assert read_cache_manifest(d)["signatures"] == m["signatures"]
    before = default_registry().counter("serve.cache_manifest_invalid").value
    with open(os.path.join(d, CACHE_MANIFEST_NAME), "w") as f:
        f.write("garbage")
    assert read_cache_manifest(d)["signatures"] == {}
    assert default_registry().counter(
        "serve.cache_manifest_invalid").value == before + 1
    plan = faults.FaultPlan([faults.FaultRule(
        point="cache.read", kind="transient", max_hits=2)], seed=0)
    with faults.active(plan):
        assert read_cache_manifest(str(tmp_path / "e"))["signatures"] == {}
    assert plan.hits("cache.read") == 3


def test_assert_cached_restart_gate(model_paths, tmp_path, capsys):
    """--assert-cached passes on a restart whose bucket signatures an
    earlier run of the deployment recorded, and fails on one that builds
    a signature the manifest never saw."""
    from tpusvm_torch.cli import main

    pa, pb = model_paths
    d = str(tmp_path / "cache")
    base = ["serve", "--smoke", "--max-batch", "4", "--smoke-threads", "2",
            "--smoke-requests", "4", "--dtype", "float64", "--device", "cpu",
            "--cache-dir", d]
    assert main(base + ["--model", f"m={pa}"]) == 0
    assert main(base + ["--model", f"m={pa}", "--assert-cached"]) == 0
    out = capsys.readouterr().out
    assert "assert-cached ok" in out and "3 known" in out
    assert main(base + ["--model", f"m={pb}", "--assert-cached"]) == 1
    assert "SMOKE FAILED --assert-cached" in capsys.readouterr().out


# ---------------------------------------------------------------- watch
def test_watcher_loads_swaps_and_remembers_failures(two_models, tmp_path):
    from tpusvm_torch.serve.watch import ModelWatcher

    A, B = two_models
    wdir = tmp_path / "watch"
    wdir.mkdir()
    logs = []
    with _server(max_batch=4) as srv:
        w = ModelWatcher(srv, str(wdir), log_fn=logs.append, warmup=False)
        assert w.poll_once() == []
        p = str(wdir / "m.npz")
        A.save(p)
        assert [a["action"] for a in w.poll_once()] == ["loaded"]
        assert "m" in srv.registry
        assert w.poll_once() == []
        B.save(p)
        os.utime(p, (time.time() + 1, time.time() + 1))
        assert [a["action"] for a in w.poll_once()] == ["swapped"]
        assert srv.registry.generation("m") == 2
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[: len(raw) // 3])
        os.utime(p, (time.time() + 2, time.time() + 2))
        assert [a["action"] for a in w.poll_once()] == ["failed"]
        assert "generation keeps serving" in logs[-1]
        assert w.poll_once() == []
        assert srv.registry.generation("m") == 2
        A.save(p)
        os.utime(p, (time.time() + 3, time.time() + 3))
        assert [a["action"] for a in w.poll_once()] == ["swapped"]
        assert srv.registry.generation("m") == 3
        w.start()
        w.stop(timeout_s=5.0)
        with pytest.raises(ValueError):
            ModelWatcher(srv, str(wdir), interval_s=0)


# ---------------------------------------------------------- warm seeds
def test_deployed_seeds_bit_equal_to_jax():
    rng = np.random.default_rng(13)
    n, C = 50, 2.0
    Y = np.where(rng.random(n) < 0.4, 1, -1).astype(np.int32)
    ids = np.sort(rng.choice(40, 15, replace=False))
    alpha = rng.random(15) * 3.0  # some over the box: the clip bites
    a, ja = deployed_seed(ids, alpha, n, Y, C), j_seed(ids, alpha, n, Y, C)
    assert a.dtype == ja.dtype and a.tobytes() == ja.tobytes()
    labels = rng.integers(0, 3, n)
    coef = rng.standard_normal((3, 15)) * 2.0
    s = deployed_seed_ovr(ids, coef, n, labels, np.arange(3), C)
    js = j_seed_ovr(ids, coef, n, labels, np.arange(3), C)
    assert s.tobytes() == js.tobytes()
    b = deployed_seed_svr(ids, coef[0], n, C)
    assert b.tobytes() == j_seed_svr(ids, coef[0], n, C).tobytes()
    Y6 = np.array([1, -1, 1, -1, 1, -1])
    a6 = deployed_seed(np.array([0, 1]), np.array([2.0, 2.0]), 6, Y6, 10.0)
    assert a6[0] == 2.0 and a6[1] == 2.0 and not a6[2:].any()
    for fn, extra in ((deployed_seed, (np.array([1.0]), 6, Y6, 10.0)),
                      (deployed_seed_svr, (np.array([1.0]), 6, 10.0))):
        with pytest.raises(ValueError, match="prefix"):
            fn(np.array([7]), *extra)


# -------------------------------------------------------------- refresh
def _deployed(tmp_path, kind):
    """(deployed artifact path, X, Y): a model fitted by the JAX package on
    the data's prefix, saved in the shared format."""
    from tpusvm.data import rings as j_rings
    from tpusvm.data import svr_sine

    p = str(tmp_path / f"deployed_{kind}.npz")
    if kind == "svc":
        X, Y = j_rings(n=360, seed=11)
        JBinarySVC(JConfig(C=10.0, gamma=10.0)).fit(X[:240], Y[:240]).save(p)
    elif kind == "ovr":
        rng = np.random.default_rng(0)
        centers = np.array([[0, 0], [6, 0], [0, 6]], float)
        Y = rng.integers(0, 3, 300).astype(np.int32)
        X = centers[Y] + rng.normal(0, 1.2, (300, 2))
        JOvR(JConfig(C=10.0, gamma=1.0), solver="blocked").fit(
            X[:200], Y[:200]).save(p)
    else:
        X, Y = svr_sine(n=160, d=1, noise=0.05, seed=3)
        JSVR(JConfig(C=10.0, gamma=20.0, epsilon=0.1)).fit(
            X[:120], Y[:120]).save(p)
    return p, X, Y


def _sv_sets(m):
    if hasattr(m, "statuses_"):
        return [set(np.nonzero(c)[0]) for c in np.asarray(m.coef_)]
    return set(np.asarray(m.sv_ids_).tolist())


@pytest.mark.parametrize("kind", ["svc", "ovr", "svr"])
def test_refresh_fit_matches_jax_and_warm_saves_updates(kind, tmp_path):
    """The port's refresh_fit against the JAX package's on the same rows
    and deployed artifact: the same status and SV-ID sets, b within 1e-4;
    the warm arm takes fewer updates than the cold one in both."""
    p, X, Y = _deployed(tmp_path, kind)
    fits = {}
    for arm in ("warm", "cold"):
        t = refresh_fit(p, X, Y, out_path=str(tmp_path / f"t_{arm}.npz"),
                        warm=arm == "warm", device="cpu")
        j = j_refresh_fit(p, X, Y, out_path=str(tmp_path / f"j_{arm}.npz"),
                          warm=arm == "warm")
        if kind == "ovr":
            assert list(t.statuses_) == [int(s) for s in j.statuses_]
            assert np.array_equal(t.sv_ids_, j.sv_ids_)
        else:
            assert t.status_.name == j.status_.name == "CONVERGED"
        assert _sv_sets(t) == _sv_sets(j)
        np.testing.assert_allclose(t.b_, j.b_, rtol=0, atol=1e-4)
        fits[arm] = (int(np.sum(t.n_iter_)), int(np.sum(j.n_iter_)))
    assert fits["warm"][0] < fits["cold"][0]
    assert fits["warm"][1] < fits["cold"][1]


def test_refresh_warm_artifact_serves_its_bits(tmp_path):
    p, X, Y = _deployed(tmp_path, "svc")
    out = str(tmp_path / "warm.npz")
    refresh_fit(p, X, Y, out_path=out, device="cpu")
    with Server(ServeConfig(max_batch=8), device="cpu") as srv:
        srv.load_model("m", p)
        srv.warmup()
        assert srv.swap("m", out)["generation"] == 2
        scores, _ = srv.predict_direct("m", X[:16])
        offline = BinarySVC.load(out, device="cpu")
        assert scores.tobytes() == np.asarray(
            offline.decision_function(X[:16])).tobytes()


def test_refresh_kill_at_every_checkpoint_bit_identical(tmp_path):
    p, X, Y = _deployed(tmp_path, "svc")
    opts = {"q": 16}

    def run(**kw):
        return refresh_fit(p, X, Y, out_path=str(tmp_path / "o.npz"),
                           solver_opts=opts, device="cpu", **kw)

    plain = run()
    ck_ref = str(tmp_path / "ck_ref.npz")
    ckpted = run(checkpoint_path=ck_ref, checkpoint_every=1)
    assert ckpted.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()
    assert np.array_equal(ckpted.sv_ids_, plain.sv_ids_)
    assert ckpted.b_ == plain.b_
    killed = 0
    for k in range(1, 40):
        ck = str(tmp_path / f"ck{k}.npz")
        plan = faults.FaultPlan([faults.FaultRule(
            point="solver.outer_checkpoint", kind="kill", at_hit=k)], seed=0)
        try:
            with faults.active(plan):
                run(checkpoint_path=ck, checkpoint_every=1)
        except faults.SimulatedKill:
            killed += 1
        else:
            break  # the solve ended before checkpoint k: every one done
        resumed = run(checkpoint_path=ck, checkpoint_every=1, resume=True)
        assert resumed.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()
        assert np.array_equal(resumed.sv_ids_, plain.sv_ids_)
        assert resumed.b_ == plain.b_
    assert killed >= 2, "the checkpoint kills never fired"


def test_refresh_watchdog_stops_at_a_checkpoint_and_resumes(tmp_path):
    from tpusvm_torch.solver.checkpoint import WatchdogTimeout

    p, X, Y = _deployed(tmp_path, "svc")
    ck = str(tmp_path / "wd.npz")
    kw = dict(out_path=str(tmp_path / "o.npz"), solver_opts={"q": 16},
              device="cpu", checkpoint_path=ck, checkpoint_every=1)
    plain = refresh_fit(p, X, Y, out_path=str(tmp_path / "p.npz"),
                        solver_opts={"q": 16}, device="cpu")
    with pytest.raises(WatchdogTimeout):
        refresh_fit(p, X, Y, watchdog=lambda: True, **kw)
    assert os.path.exists(ck)
    resumed = refresh_fit(p, X, Y, resume=True, **kw)
    assert resumed.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()


def test_refresh_rejects_wrong_artifacts(tmp_path):
    X, Y = rings(n=300, seed=7)
    approx = str(tmp_path / "approx.npz")
    BinarySVC(SVMConfig(C=10.0, gamma=10.0, kernel="rff", rff_dim=128),
              device="cpu").fit(X, Y).save(approx)
    with pytest.raises(ValueError, match="approximate"):
        refresh_fit(approx, X, Y, out_path=str(tmp_path / "o.npz"),
                    device="cpu")
    p, X, Y = _deployed(tmp_path, "svr")
    with pytest.raises(ValueError, match="checkpoint"):
        refresh_fit(p, X, Y, out_path=str(tmp_path / "o.npz"),
                    checkpoint_path=str(tmp_path / "c.npz"), device="cpu")
    with pytest.raises(ValueError, match="watchdog needs"):
        refresh_fit(p, X, Y, out_path=str(tmp_path / "o.npz"),
                    watchdog=lambda: False, device="cpu")


# ----------------------------------------------------------------- HTTP
def test_http_admin_swap_roundtrip(model_paths, two_models):
    import urllib.request

    from tpusvm_torch.serve.http import make_http_server, start_http_thread

    pa, pb = model_paths
    A, B = two_models
    Xq, _ = rings(n=4, seed=5)
    with _server(max_batch=4) as srv:
        srv.load_model("m", pa)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        out = swap_via_http(base, "m", pb, timeout_s=30.0)
        assert out["swapped"] is True and out["generation"] == 2
        scores, _ = srv.predict_direct("m", Xq)
        assert np.array_equal(scores, np.asarray(B.decision_function(Xq)))
        health = json.loads(urllib.request.urlopen(f"{base}/healthz",
                                                   timeout=30.0).read())
        assert health["swap"]["m"]["generation"] == 2
        with pytest.raises(RuntimeError, match="HTTP 404"):
            swap_via_http(base, "nope", pb, timeout_s=30.0)
        bad = pa + ".bad.npz"
        with open(bad, "wb") as f:
            f.write(b"not a zip")
        with pytest.raises(RuntimeError, match="HTTP 409"):
            swap_via_http(base, "m", bad, timeout_s=30.0)
        assert srv.registry.generation("m") == 2
        assert srv.health()["status"] == "degraded"
