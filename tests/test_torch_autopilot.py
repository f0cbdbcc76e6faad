"""The closed-loop supervisor in tpusvm_torch (autopilot/), on the CPU,
held against the JAX package's tpusvm/autopilot/.

Bands: DriftReport JSON and autopilot_state.json are the JAX package's
bytes for the same inputs; under one fake clock and one append schedule
the port's tick statuses, decisions and drift reports equal JAX's tick by
tick, and each refreshed model meets JAX's at the cross-engine band (the
same SV-ID set and status, b within 1e-4, PARITY.md); within the port a
killed or watchdog-stopped refresh resumes bit for bit, and a seeded
refresh keeps its kernel rounds in the box [0, C].
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.autopilot import Autopilot as JAutopilot
from tpusvm.autopilot import AutopilotConfig as JAutopilotConfig
from tpusvm.autopilot import AutopilotState as JAutopilotState
from tpusvm.autopilot import DriftThresholds as JDriftThresholds
from tpusvm.autopilot import evaluate as j_evaluate
from tpusvm.autopilot import save_state as j_save_state
from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm.stream import ShardWriter as JShardWriter
from tpusvm.stream import ingest_arrays as j_ingest_arrays
from tpusvm.stream import open_dataset as j_open_dataset
from tpusvm_torch import faults
from tpusvm_torch.autopilot import (Autopilot, AutopilotConfig,
                                    AutopilotState, DriftThresholds,
                                    evaluate, load_state, save_state)
from tpusvm_torch.autopilot.drift import feature_drift, score_shift
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import rings
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.serve import ServeConfig, Server
from tpusvm_torch.serve.refresh import refresh_fit
from tpusvm_torch.status import AutopilotStatus, Status
from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset

X, Y = rings(n=800, seed=11)
CFG = SVMConfig(C=10.0, gamma=10.0)
GROWTHS = ((240, 400), (400, 800))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deploy(tmp_path, n=240):
    """A dataset over the prefix and a deployed artifact trained on it."""
    data = str(tmp_path / "data")
    ingest_arrays(data, X[:n], Y[:n], rows_per_shard=64)
    deployed = str(tmp_path / "deployed.npz")
    BinarySVC(CFG, device="cpu").fit(X[:n], Y[:n]).save(deployed)
    return data, deployed


def _grow(data, a=240, b=400, step=40, writer=ShardWriter):
    w = writer.open_append(data)
    for s in range(a, b, step):
        w.append(X[s:s + step], Y[s:s + step])
    w.close()


def _config(tmp_path, data, deployed, **kw):
    base = dict(
        data_dir=data, model_path=deployed,
        out_path=str(tmp_path / "m.refresh.npz"), name="m",
        thresholds=DriftThresholds(growth=0.5, feature=None, score=None,
                                   jitter_frac=0.0),
        hysteresis=1, cooldown_s=0.0, seed=3, device="cpu",
    )
    base.update(kw)
    return AutopilotConfig(**base)


# ------------------------------------------------ drift: the JAX bytes
_DRIFT_CASES = {
    "jittered": dict(thresholds=dict(jitter_frac=0.2), seed=9, tick=4,
                     rows_at_refresh=160, since_refresh_s=12.5,
                     score=({"pos": 50, "neg": 50}, {"pos": 80, "neg": 120})),
    "score_window": dict(thresholds=dict(min_score_window=10 ** 6), seed=1,
                         tick=2, rows_at_refresh=200, since_refresh_s=0.0,
                         score=({"pos": 5, "neg": 1}, {"pos": 9, "neg": 9})),
    "staleness": dict(thresholds=dict(feature=None, growth=None, score=None,
                                      staleness_s=100.0, min_new_rows=10),
                      seed=0, tick=1, rows_at_refresh=240,
                      since_refresh_s=150.0, score=(None, None)),
    "min_new_rows": dict(thresholds=dict(feature=None, growth=0.0001,
                                         score=None, min_new_rows=10 ** 6),
                         seed=0, tick=7, rows_at_refresh=1,
                         since_refresh_s=0.0, score=(None, None)),
    "feature_escape": dict(thresholds=dict(feature=0.05, jitter_frac=0.5),
                           seed=123456789, tick=30, rows_at_refresh=100,
                           since_refresh_s=3.25, score=(None, None),
                           shrink=True),
}


@pytest.mark.parametrize("case", sorted(_DRIFT_CASES))
def test_drift_report_bytes_equal_jax(tmp_path, case):
    c = _DRIFT_CASES[case]
    data, _ = _deploy(tmp_path)
    _grow(data)
    lo, hi = X[:240].min(0), X[:240].max(0)
    if c.get("shrink"):
        hi = lo + 0.5 * (hi - lo)
    base, cur = c["score"]
    kw = dict(fitted_min=lo, fitted_max=hi,
              rows_at_refresh=c["rows_at_refresh"],
              since_refresh_s=c["since_refresh_s"], score_baseline=base,
              score_current=cur, seed=c["seed"], tick=c["tick"])
    ours = evaluate(manifest=open_dataset(data).manifest,
                    thresholds=DriftThresholds(**c["thresholds"]), **kw)
    theirs = j_evaluate(manifest=j_open_dataset(data).manifest,
                        thresholds=JDriftThresholds(**c["thresholds"]), **kw)
    assert ours.to_json_bytes() == theirs.to_json_bytes()
    assert json.loads(ours.to_json_bytes())["schema_version"] == 1
    if case == "jittered":
        # another seed jitters the thresholds otherwise
        other = evaluate(manifest=open_dataset(data).manifest,
                         thresholds=DriftThresholds(**c["thresholds"]),
                         **{**kw, "seed": 10})
        assert other.to_json_bytes() != ours.to_json_bytes()


def test_drift_detector_math(tmp_path):
    data, _ = _deploy(tmp_path)
    ds = open_dataset(data)
    fd = feature_drift(ds.manifest, X[:240].min(0), X[:240].max(0), 0)
    assert fd["score"] == 0.0 and fd["appended_rows"] == ds.n_rows
    lo, hi = X[:240].min(0), X[:240].max(0)
    fd = feature_drift(ds.manifest, lo, lo + 0.5 * (hi - lo), 0)
    assert fd["score"] > 0.9 and fd["frac_escaped"] == 1.0
    assert feature_drift(ds.manifest, lo, hi, ds.n_rows) == \
        {"score": 0.0, "frac_escaped": 0.0, "appended_rows": 0}
    ss = score_shift({"pos": 60, "neg": 40}, {"pos": 80, "neg": 120})
    assert (ss["window"], ss["rate_base"], ss["rate_now"]) == (100, 0.6, 0.2)
    assert ss["score"] == pytest.approx(0.4)


# ------------------------------------------------ state: the JAX bytes
def _state_fields():
    return dict(seed=7, tick=3, consecutive_triggered=1,
                rows_at_refresh=240, last_refresh_t=1234.5,
                cooldown_until=1264.5, generation=2, refreshes=2,
                failures=1, stage="fitting", stage_rows=400,
                model_path="m.npz", score_baseline={"pos": 1, "neg": 2},
                breaker={"consecutive": 0, "opened_at": 0.0,
                         "recoveries": 0, "state": "closed", "trips": 0})


def test_state_file_bytes_equal_jax_and_load_across(tmp_path):
    from tpusvm.autopilot import load_state as j_load_state

    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    save_state(ours, AutopilotState(**_state_fields()))
    j_save_state(theirs, JAutopilotState(**_state_fields()))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert load_state(theirs) == AutopilotState(**_state_fields())
    assert j_load_state(ours) == JAutopilotState(**_state_fields())


@pytest.mark.parametrize("damage, match", [
    (lambda obj: obj.update(rows_at_refresh=9999), "CRC"),
    (lambda obj: obj.update(state_version=99), "version"),
    (lambda obj: obj.pop("state_version"), "state_version"),
], ids=["torn", "version", "not_a_state"])
def test_state_gates(tmp_path, damage, match):
    p = str(tmp_path / "s.json")
    save_state(p, AutopilotState(**_state_fields()))
    with open(p) as f:
        obj = json.load(f)
    damage(obj)
    with open(p, "w") as f:
        json.dump(obj, f)
    with pytest.raises(ValueError, match=match):
        load_state(p)


# ---------------------------------- the tick loop against JAX, one clock
@pytest.fixture(scope="module")
def both_loops(tmp_path_factory):
    """The same closed loop in both packages, artifact-drop mode, under
    one fake clock: deploy on [:240]; tick; grow to 400; tick (hysteresis
    1/2); tick (refresh 1); grow to 800 inside the cooldown; tick
    (hysteresis); tick (cooldown); past it, tick (refresh 2, seeded by
    refresh 1)."""
    runs = {}
    for pkg in ("torch", "jax"):
        td = tmp_path_factory.mktemp(f"loop_{pkg}")
        data = str(td / "data")
        deployed = str(td / "deployed.npz")
        if pkg == "torch":
            ingest_arrays(data, X[:240], Y[:240], rows_per_shard=64)
            BinarySVC(CFG, device="cpu").fit(X[:240], Y[:240]).save(deployed)
            thr, cfg_cls, pilot_cls, writer = (DriftThresholds,
                                               AutopilotConfig, Autopilot,
                                               ShardWriter)
            extra = dict(device="cpu")
        else:
            j_ingest_arrays(data, X[:240], Y[:240], rows_per_shard=64)
            JBinarySVC(JConfig(C=10.0, gamma=10.0),
                       dtype=jnp.float32).fit(X[:240], Y[:240]).save(deployed)
            thr, cfg_cls, pilot_cls, writer = (JDriftThresholds,
                                               JAutopilotConfig, JAutopilot,
                                               JShardWriter)
            extra = {}
        clock = [1000.0]
        cfg = cfg_cls(data_dir=data, model_path=deployed,
                      out_path=str(td / "m.refresh.npz"), name="m",
                      thresholds=thr(growth=0.5, feature=0.1, score=None,
                                     jitter_frac=0.1),
                      hysteresis=2, cooldown_s=30.0, seed=3, **extra)
        pilot = pilot_cls(cfg, clock=lambda: clock[0], log_fn=None)
        ticks, models = [], []

        def tick():
            out = pilot.tick()
            ticks.append((int(out["status"]), out["report"].to_json_bytes(),
                          out["rows"], out["generation"]))
            if out["status"] == AutopilotStatus.REFRESHED:
                models.append(BinarySVC.load(cfg.out_path, device="cpu"))

        tick()
        _grow(data, *GROWTHS[0], writer=writer)
        tick()
        tick()
        _grow(data, *GROWTHS[1], writer=writer)
        clock[0] += 10.0
        tick()
        tick()
        clock[0] += 30.0
        tick()
        with open(pilot.cfg.state_path) as f:
            state = json.load(f)
        runs[pkg] = (ticks, models, state)
    return runs


def test_tick_statuses_and_reports_equal_jax_under_one_clock(both_loops):
    ours, _, state = both_loops["torch"]
    theirs, _, j_state = both_loops["jax"]
    assert [t[0] for t in ours] == [
        AutopilotStatus.WATCHING, AutopilotStatus.TRIGGERED_HYSTERESIS,
        AutopilotStatus.REFRESHED, AutopilotStatus.TRIGGERED_HYSTERESIS,
        AutopilotStatus.SUPPRESSED_COOLDOWN, AutopilotStatus.REFRESHED]
    assert ours == theirs  # statuses, report bytes, rows, generations
    for obj in (state, j_state):
        obj.pop("crc32")
        obj.pop("model_path")
    assert state == j_state


@pytest.mark.parametrize("generation", [1, 2])
def test_refreshed_models_meet_jax_at_the_cross_engine_band(both_loops,
                                                             generation):
    ours = both_loops["torch"][1][generation - 1]
    theirs = both_loops["jax"][1][generation - 1]
    assert ours.status_ == theirs.status_ == Status.CONVERGED
    np.testing.assert_array_equal(ours.sv_ids_, theirs.sv_ids_)
    assert abs(ours.b_ - theirs.b_) <= 1e-4


# -------------------------------------------------- the port's own loop
def test_hysteresis_cooldown_and_swaps_into_a_live_server(tmp_path):
    data, deployed = _deploy(tmp_path)
    clock = [1000.0]
    with Server(ServeConfig(max_batch=8), device="cpu") as srv:
        srv.load_model("m", deployed)
        srv.warmup()
        pilot = Autopilot(_config(tmp_path, data, deployed, hysteresis=2,
                                  cooldown_s=30.0),
                          server=srv, clock=lambda: clock[0], log_fn=None)
        assert pilot.tick()["status"] == AutopilotStatus.WATCHING
        assert pilot.state.score_baseline == {"pos": 0, "neg": 0}
        _grow(data)
        assert pilot.tick()["status"] == AutopilotStatus.TRIGGERED_HYSTERESIS
        assert pilot.tick()["status"] == AutopilotStatus.REFRESHED
        assert srv.registry.generation("m") == 2
        scores, _ = srv.predict_direct("m", X[:8])
        offline = BinarySVC.load(pilot.cfg.out_path, device="cpu")
        assert scores.tobytes() == np.asarray(
            offline.decision_function(X[:8])).tobytes()
        # served traffic moves the score-shift detector's counters
        for i in range(24):
            assert srv.submit("m", X[i]).ok
        cur = srv.score_stats("m")
        assert cur["pos"] + cur["neg"] - sum(
            pilot.state.score_baseline.values()) == 24


def test_the_breaker_stops_a_failing_refresh_from_hot_looping(tmp_path):
    data, deployed = _deploy(tmp_path)
    clock = [0.0]
    pilot = Autopilot(_config(tmp_path, data, deployed, breaker_threshold=2,
                              breaker_cooldown_s=100.0),
                      clock=lambda: clock[0], log_fn=None)
    _grow(data)
    plan = faults.FaultPlan([faults.FaultRule(
        point="autopilot.refresh", kind="transient", p=1.0)], seed=0)
    with faults.active(plan):
        assert [pilot.tick()["status"] for _ in range(2)] == \
            [AutopilotStatus.REFRESH_FAILED] * 2
        for _ in range(3):
            assert pilot.tick()["status"] == \
                AutopilotStatus.SUPPRESSED_BREAKER
        assert plan.hits("autopilot.refresh") == 2
        clock[0] = 101.0  # one half-open probe
        assert pilot.tick()["status"] == AutopilotStatus.REFRESH_FAILED
        assert pilot.tick()["status"] == AutopilotStatus.SUPPRESSED_BREAKER
    clock[0] = 202.0
    assert pilot.tick()["status"] == AutopilotStatus.REFRESHED
    assert pilot.state.failures == 3 and os.path.exists(pilot.cfg.out_path)


@pytest.mark.parametrize("arm", ["watchdog", "kill"])
def test_a_stopped_refresh_resumes_bit_identical(tmp_path, arm):
    """The watchdog (deadline 0: the first durable segment stops the fit)
    or a kill at the first solver checkpoint, then a resumed tick: the
    artifact equals an uninterrupted refresh_fit's bit for bit."""
    data, deployed = _deploy(tmp_path)
    ck = str(tmp_path / "ck.npz")
    cfg = _config(tmp_path, data, deployed, checkpoint_path=ck,
                  checkpoint_every=1, breaker_threshold=100,
                  breaker_cooldown_s=0.0,
                  **({"deadline_s": 0.0} if arm == "watchdog" else {}))
    clock = [0.0]
    pilot = Autopilot(cfg, clock=lambda: clock[0], log_fn=None)
    _grow(data)
    if arm == "watchdog":
        assert pilot.tick()["status"] == AutopilotStatus.REFRESH_TIMEOUT
        assert pilot.state.stage == "fitting" and os.path.exists(ck)
        pilot.cfg = dataclasses.replace(pilot.cfg, deadline_s=None)
    else:
        plan = faults.FaultPlan([faults.FaultRule(
            point="solver.outer_checkpoint", kind="kill", at_hit=1)], seed=0)
        with pytest.raises(faults.SimulatedKill):
            with faults.active(plan):
                pilot.tick()
        st = load_state(cfg.resolved().state_path)
        assert st.stage == "fitting" and st.stage_rows == 400
        pilot = Autopilot(cfg, resume=True, clock=lambda: clock[0],
                          log_fn=None)
    assert pilot.tick()["status"] == AutopilotStatus.REFRESHED
    assert pilot.state.rows_at_refresh == 400 and not os.path.exists(ck)
    Xg, Yg = open_dataset(data).load_arrays()
    plain = refresh_fit(deployed, Xg, Yg, out_path=str(tmp_path / "p.npz"),
                        device="cpu")
    got = BinarySVC.load(pilot.cfg.out_path, device="cpu")
    assert got.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()
    assert np.array_equal(got.sv_ids_, plain.sv_ids_)
    assert got.b_ == plain.b_


def test_resume_refuses_another_seed(tmp_path):
    data, deployed = _deploy(tmp_path)
    cfg = _config(tmp_path, data, deployed, seed=1)
    Autopilot(cfg, log_fn=None)
    with pytest.raises(ValueError, match="seed"):
        Autopilot(dataclasses.replace(cfg, seed=2), resume=True, log_fn=None)
    with pytest.raises(ValueError, match="checkpoint_path"):
        Autopilot(dataclasses.replace(cfg, deadline_s=1.0), log_fn=None)


def test_counters_events_and_the_fleet_snapshot_drop(tmp_path):
    from tpusvm_torch.obs.fleet import read_snapshot_file
    from tpusvm_torch.obs.registry import (default_registry,
                                           reset_default_registry)

    reset_default_registry()
    events = []
    faults.set_event_sink(lambda name, **attrs: events.append((name, attrs)))
    try:
        data, deployed = _deploy(tmp_path)
        drop = str(tmp_path / "fleet.json")
        pilot = Autopilot(_config(tmp_path, data, deployed,
                                  metrics_snapshot_path=drop), log_fn=None)
        pilot.tick()
        _grow(data)
        pilot.tick()
        snap = {(e["name"], tuple(sorted(e["labels"].items()))): e
                for e in default_registry().snapshot()["metrics"]}
        assert snap[("autopilot.ticks", ())]["value"] == 2
        assert snap[("autopilot.refreshes_triggered", ())]["value"] == 1
        assert snap[("autopilot.data_staleness_rows", ())]["value"] == 160.0
        drift = [a for n, a in events if n == "autopilot.drift"]
        assert [d["decision"] for d in drift] == [False, True]
        payload = read_snapshot_file(drop)
        assert payload["role"] == "autopilot" and payload["instance"] == "m"
        assert payload["status"]["generation"] == 1
    finally:
        faults.set_event_sink(None)
        reset_default_registry()


# ------------------------------------ the seeded refresh and the box
def test_a_seeded_refresh_keeps_its_kernel_rounds_in_the_box():
    """A warm refresh's seed is float64 duals, and kernel #2 (its plain
    version here) rounds alpha through float32: without the pull-back onto
    [0, C] a member moved to a bound lands off it and this solve ends
    INFEASIBLE_UV; the refresh's seeded solve converges, every alpha in
    the box."""
    import tempfile

    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.tune.warm import deployed_seed

    Xm, Ym = mnist_like(n=2200, d=64, noise=30, label_noise=0.005, seed=587)
    opts = dict(q=256, wss=2, max_inner=512)
    cfg = SVMConfig(C=10.0, gamma=1.0 / 64)
    donor = BinarySVC(cfg, solver_opts=opts, device="cpu").fit(Xm[:2000],
                                                               Ym[:2000])
    a0 = deployed_seed(donor.sv_ids_, donor.sv_alpha_, 2200, Ym, cfg.C)
    Xs = MinMaxScaler().fit(Xm).transform(Xm).astype(np.float32)
    bare = blocked_smo_solve(torch.as_tensor(Xs), torch.as_tensor(Ym),
                             alpha0=a0, warm_start=True, C=cfg.C,
                             gamma=cfg.gamma, accum_dtype=torch.float64,
                             device="cpu", **opts)
    assert Status(int(bare.status)) == Status.INFEASIBLE_UV
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "donor.npz")
        donor.save(path)
        m = refresh_fit(path, Xm, Ym, out_path=os.path.join(td, "r.npz"),
                        solver_opts=opts, device="cpu")
    assert m.status_ == Status.CONVERGED
    alpha = m.result_.alpha.numpy()
    assert alpha.min() >= 0.0 and alpha.max() <= cfg.C
