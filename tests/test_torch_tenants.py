"""The multi-tenant tier in tpusvm_torch (tenants/), on the CPU, held
against the JAX package's tpusvm/tenants/.

Bands: views, fingerprints, tenant-store bytes and coalesce plans are the
JAX package's exactly; a launch's fingerprint is JAX's on every key but
the accumulator dtype (written by its numpy name here, by str() of a jax
type there). Within the port a coalesced lane equals its solo refresh
(the kernel engine, the fused f-update, the seeded pull-back onto [0, C])
bit for bit, and a killed coalesced refresh resumes bit for bit; each
tenant meets JAX's refresh at the cross-engine band (the same SV-ID set
and status, b within 1e-4, PARITY.md). A fleet checkpoint written by the
JAX package is refused by name.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm.tenants import TenantRecord as JTenantRecord
from tpusvm.tenants import TenantsState as JTenantsState
from tpusvm.tenants import coalesce_drifted as j_coalesce
from tpusvm.tenants import provision_tenants as j_provision
from tpusvm.tenants import refresh_drifted as j_refresh_drifted
from tpusvm.tenants import save_store as j_save_store
from tpusvm.tenants import tenant_labels as j_tenant_labels
from tpusvm.tenants import view_fingerprint as j_view_fingerprint
from tpusvm_torch import faults
from tpusvm_torch.autopilot import DriftThresholds
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.fleet.batch import pack_problems
from tpusvm_torch.fleet.solve import FleetState, fleet_smo_solve
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.serve.refresh import refresh_fit
from tpusvm_torch.status import Status, TenantsStatus
from tpusvm_torch.stream import ShardWriter, ingest_arrays
from tpusvm_torch.tenants import (TenantRecord, TenantsConfig, TenantsState,
                                  TenantsSupervisor, coalesce_drifted,
                                  is_tenant_store, load_fleet_checkpoint,
                                  load_store, provision_tenants,
                                  refresh_drifted, save_fleet_checkpoint,
                                  save_store, tenant_labels,
                                  view_fingerprint)
from tpusvm_torch.tenants.coalesce import _launch_fingerprint

# the JAX tests' corpus: K labelled blobs, the appended rows shifted
K, D = 4, 4
N0, GROW = 160, 96
_rng = np.random.default_rng(1807)
LABELS = _rng.integers(0, K, size=N0 + GROW).astype(np.int32)
_MEANS = _rng.normal(0.0, 2.5, size=(K, D))
XALL = _MEANS[LABELS] + _rng.normal(0.0, 1.0, size=(N0 + GROW, D))
XALL[N0:] += 0.6

C_PAL, G_PAL = (1.0, 3.0, 10.0), (0.5, 1.5, 5.0)
SOLVER_OPTS = {"q": 16, "max_inner": 8}
# the bitwise lane-against-solo arm: a solo refit on the fleet's engine, the
# subproblem kernel and the fused f-update (their plain versions here),
# which needs q % 128 == 0
KERNEL_OPTS = {"q": 128, "max_inner": 64}
SOLO_OPTS = dict(KERNEL_OPTS, inner="kernel", fused_fupdate=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(cls=TenantRecord, n=5):
    """n-1 full-view tenants and one row-subset tenant: one bucket (the
    subset view is a per-lane valid mask, not a static-key split)."""
    return [cls(tenant_id=f"t{i}", positive_label=i % K, C=C_PAL[i % 3],
                gamma=G_PAL[i % 3], row_mod=2 if i == 4 else None,
                row_ofs=1 if i == 4 else 0) for i in range(n)]


def _odd(cls=TenantRecord):
    """A tenant provisioned under another static template: it can never
    join the shared bucket and refreshes solo."""
    return cls(tenant_id="t5", positive_label=1, C=3.0, gamma=1.5)


# ---------------------------------------------------- views and stores
@pytest.mark.parametrize("spec", [
    dict(positive_label=2), dict(positive_label=1, row_mod=3, row_ofs=2),
    dict(positive_label=0, row_mod=2, row_ofs=1)],
    ids=["column", "subset3", "subset2"])
def test_views_and_fingerprints_equal_jax(spec):
    ours = tenant_labels(LABELS, TenantRecord("a", C=1.0, gamma=1.0, **spec))
    theirs = j_tenant_labels(LABELS, JTenantRecord("a", C=1.0, gamma=1.0,
                                                   **spec))
    assert ours[0].tobytes() == theirs[0].tobytes()
    assert (ours[1] is None) == (theirs[1] is None)
    if ours[1] is not None:
        assert ours[1].tobytes() == theirs[1].tobytes()
        assert set(np.unique(ours[0])) == {-1, 1}
    assert view_fingerprint(*ours) == j_view_fingerprint(*theirs)
    grown = np.concatenate([LABELS, [1]]).astype(np.int32)
    assert view_fingerprint(*tenant_labels(grown, TenantRecord(
        "a", C=1.0, gamma=1.0, **spec))) != view_fingerprint(*ours)


@pytest.mark.parametrize("labels, spec, match", [
    (np.zeros(16, np.int32), dict(positive_label=0), "degenerate"),
    (np.array([0, 1] * 8, np.int32), dict(positive_label=0, row_mod=2,
                                          row_ofs=0), "degenerate"),
    (LABELS, dict(positive_label=0, C=0.0), "C must be"),
    (LABELS, dict(positive_label=0, gamma=float("nan")), "gamma must be"),
    (LABELS, dict(positive_label=0, row_mod=2, row_ofs=2), "row_ofs"),
], ids=["one_class", "one_class_subset", "C", "gamma", "row_ofs"])
def test_degenerate_views_and_bad_records_are_refused(labels, spec, match):
    rec = TenantRecord("a", **{"C": 1.0, "gamma": 1.0, **spec})
    with pytest.raises(ValueError, match=match):
        rec.validate()
        tenant_labels(labels, rec)


def _state(state_cls=TenantsState, rec_cls=TenantRecord):
    st = state_cls(seed=7, tick=3, stage="fitting",
                   inflight={"tenant_ids": ["a"], "stage_rows": 12,
                             "plan": {"launches": [["a"]], "solos": []}},
                   generation=2, refreshes=5, failures=1,
                   breaker={"consecutive": 0, "opened_at": 0.0,
                            "recoveries": 0, "state": "closed", "trips": 0})
    st.tenants["b"] = rec_cls(tenant_id="b", positive_label=1, C=3.0,
                              gamma=0.5, row_mod=2, row_ofs=1,
                              last_refresh_t=12.25)
    st.tenants["a"] = rec_cls(tenant_id="a", positive_label=0, C=1.0,
                              gamma=2.0, model_path="/x/a.npz", generation=2,
                              rows_at_refresh=12, consecutive_triggered=1)
    return st


def test_store_bytes_equal_jax_and_load_across(tmp_path):
    from tpusvm.tenants import load_store as j_load_store

    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    save_store(ours, _state())
    j_save_store(theirs, _state(JTenantsState, JTenantRecord))
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert is_tenant_store(ours) and not is_tenant_store(str(tmp_path))
    assert load_store(theirs).to_json() == _state().to_json()
    assert j_load_store(ours).to_json() == _state().to_json()


@pytest.mark.parametrize("damage, match", [
    ("flip", "CRC|JSON"), ("version", "version"), ("unknown", "unknown"),
    ("stage", "inflight")])
def test_store_gates(tmp_path, damage, match):
    from tpusvm_torch.tenants.store import _canonical

    p = str(tmp_path / "store.json")
    st = _state()
    if damage == "stage":
        st.inflight = None
    save_store(p, st)
    if damage == "flip":
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0x20
        open(p, "wb").write(bytes(raw))
    elif damage in ("version", "unknown"):
        doc = json.load(open(p))
        doc.pop("crc32")
        if damage == "version":
            doc["store_version"] = 99
        else:
            doc["from_the_future"] = 1
        doc["crc32"] = zlib.crc32(_canonical(doc)) & 0xFFFFFFFF
        json.dump(doc, open(p, "w"))
    with pytest.raises(ValueError, match=match):
        load_store(p)


# -------------------------------------------------- the fleet checkpoint
def _paused_state():
    labels = [tenant_labels(LABELS[:N0], r) for r in _records()]
    batch = pack_problems([y for y, _ in labels], [1.0, 3.0, 10.0, 1.0, 3.0],
                          [0.5, 1.5, 5.0, 0.5, 1.5],
                          valids=[v for _, v in labels])
    X = torch.as_tensor(XALL[:N0], dtype=torch.float32)
    args = (X, torch.as_tensor(batch.Ys), torch.as_tensor(batch.valids),
            None)
    kw = dict(Cs=batch.Cs, gammas=batch.gammas, accum_dtype=torch.float64,
              device="cpu", **SOLVER_OPTS)
    return args, kw


def test_a_fleet_carry_round_trips_bit_for_bit_and_resumes(tmp_path):
    args, kw = _paused_state()
    whole = fleet_smo_solve(*args, **kw)
    _, st = fleet_smo_solve(*args, pause_at=3, return_state=True, **kw)
    p = str(tmp_path / "fleet.ck.npz")
    save_fleet_checkpoint(p, st, {"launch": "a", "rows": N0})
    back = load_fleet_checkpoint(p, {"launch": "a", "rows": N0})
    for f in dataclasses.fields(FleetState):
        a, b = getattr(st, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif f.name != "host_wait_s":
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), f.name
    res = fleet_smo_solve(*args, resume_states=back, **kw)
    assert torch.equal(res.alpha, whole.alpha)
    assert list(res.n_iter) == list(whole.n_iter)
    with pytest.raises(ValueError, match="rows"):
        load_fleet_checkpoint(p, {"launch": "a", "rows": 2 * N0})


def test_a_fleet_checkpoint_of_the_jax_package_is_refused_by_name(tmp_path):
    from tpusvm.solver.blocked import _OuterState
    from tpusvm.tenants import save_fleet_checkpoint as j_save

    p = str(tmp_path / "jax.ck.npz")
    rng = np.random.default_rng(0)
    j_save(p, _OuterState(*(np.asarray(rng.normal(size=(2, 8)), np.float32)
                            for _ in _OuterState._fields)),
           {"launch": "a"})
    with pytest.raises(ValueError, match="written by the JAX package"):
        load_fleet_checkpoint(p, {"launch": "a"})
    np.savez(str(tmp_path / "junk.npz"), x=np.zeros(2))
    with pytest.raises(ValueError, match="not a fleet checkpoint"):
        load_fleet_checkpoint(str(tmp_path / "junk.npz"), {})


def test_seeded_fleet_lanes_take_their_rounds_in_the_kernel():
    """A warm coalesced refresh near its seeds' optimum (nine one-vs-rest
    lanes over C in {2.5, 10, 40}, 1,500 rows grown to 1,700): every
    seeded round runs kernel #2's boxed subproblem and makes progress
    there, none is redone on the float64 loop engine (n_rescue), and each
    lane converges. Run on the seeds' float64 alphas themselves, kernel
    #2's float32 rounds stall on some of these lanes and are redone
    there."""
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like_multiclass
    from tpusvm_torch.tune.warm import deployed_seed

    n0, n1, d, lanes = 1500, 1700, 64, 9
    X, lab = mnist_like_multiclass(n=n1, d=d, seed=5, noise=30.0)
    X = torch.tensor(MinMaxScaler().fit(X).transform(X), dtype=torch.float32)
    Cs = [(2.5, 10.0, 40.0)[i % 3] for i in range(lanes)]
    gammas = [(0.5, 1.0, 2.0)[(i // 3) % 3] / d for i in range(lanes)]
    Ys = torch.tensor(np.stack([np.where(lab == i, 1, -1)
                                for i in range(lanes)]), dtype=torch.int32)
    kw = dict(Cs=Cs, gammas=gammas, q=128, wss=2, max_inner=512,
              max_iter=10**6, accum_dtype=torch.float64, device="cpu")
    cold = fleet_smo_solve(X[:n0], Ys[:, :n0], **kw)
    # each lane's deployed duals, scattered and projected feasible for the
    # grown rows, as a refresh seeds them
    C_t = torch.tensor(Cs, dtype=torch.float64)[:, None]
    seeds = torch.zeros((lanes, n1), dtype=torch.float64)
    for b in range(lanes):
        a = cold.alpha[b].numpy()
        sv = np.flatnonzero(a > 1e-8)
        seeds[b] = torch.from_numpy(deployed_seed(sv, a[sv], n1,
                                                  Ys[b].numpy(), Cs[b]))
    warm = fleet_smo_solve(X, Ys, alpha0s=seeds, warm_start=True, **kw)
    assert list(warm.status) == [int(Status.CONVERGED)] * lanes
    assert list(warm.n_rescue) == [0] * lanes
    assert bool(((warm.alpha >= 0) & (warm.alpha <= C_t)).all())


# ---------------------------------- coalesced refresh: both packages
@pytest.fixture(scope="module")
def platform(tmp_path_factory):
    """Donors provisioned on the N0-row prefix in each package (the odd
    tenant under its own template), then the refreshes over the grown
    corpus: the port's warm, cold and reversed-order coalesced arms and
    JAX's warm arm at the JAX tests' knobs, and a port arm at q=128 beside
    its solo controls on the fleet's engine."""
    td = tmp_path_factory.mktemp("tenants")
    out = {}
    for pkg in ("torch", "jax"):
        donors = str(td / pkg / "donors")
        os.makedirs(donors)
        if pkg == "torch":
            recs = _records()
            provision_tenants(XALL[:N0], LABELS[:N0], recs,
                              artifacts_dir=donors, solver_opts=SOLVER_OPTS,
                              device="cpu")
            provision_tenants(XALL[:N0], LABELS[:N0], [_odd()],
                              artifacts_dir=donors,
                              config=SVMConfig(eps=1e-11),
                              solver_opts=SOLVER_OPTS, device="cpu")
        else:
            recs = _records(JTenantRecord)
            j_provision(XALL[:N0], LABELS[:N0], recs, artifacts_dir=donors,
                        solver_opts=SOLVER_OPTS)
            j_provision(XALL[:N0], LABELS[:N0], [_odd(JTenantRecord)],
                        artifacts_dir=donors, config=JConfig(eps=1e-11),
                        solver_opts=SOLVER_OPTS)
        out[pkg + "_donors"] = donors

    def arm(pkg, name, warm=True, order=1, opts=SOLVER_OPTS):
        adir = str(td / pkg / name)
        cls = TenantRecord if pkg == "torch" else JTenantRecord
        recs = (_records(cls) + [_odd(cls)])[::order]
        for r in recs:
            r.model_path = os.path.join(out[pkg + "_donors"],
                                        r.tenant_id + ".npz")
        if pkg == "torch":
            res = refresh_drifted(XALL, LABELS, recs, artifacts_dir=adir,
                                  warm=warm, solver_opts=opts, device="cpu")
        else:
            res = j_refresh_drifted(XALL, LABELS, recs, artifacts_dir=adir,
                                    warm=warm, solver_opts=SOLVER_OPTS)
        return res, adir

    out["warm"] = arm("torch", "warm")
    out["cold"] = arm("torch", "cold", warm=False)
    out["warm_rev"] = arm("torch", "warm_rev", order=-1)
    out["jax_warm"] = arm("jax", "warm")
    out["kernel"] = arm("torch", "kernel", opts=KERNEL_OPTS)
    solo = {}
    for rec in _records() + [_odd()]:
        Y, valid = tenant_labels(LABELS, rec)
        opts = dict(SOLO_OPTS)
        if valid is not None:
            opts["valid"] = valid
        solo[rec.tenant_id] = refresh_fit(
            os.path.join(out["torch_donors"], rec.tenant_id + ".npz"), XALL, Y,
            out_path=str(td / f"solo_{rec.tenant_id}.npz"),
            solver_opts=opts, device="cpu")
    out["solo"] = solo
    return out


def _load(adir, tid):
    return BinarySVC.load(os.path.join(adir, tid + ".npz"), device="cpu")


def test_the_plan_and_fingerprint_equal_jax(platform):
    from tpusvm.tenants.coalesce import _launch_fingerprint as j_fp

    recs = _records() + [_odd()]
    jrecs = _records(JTenantRecord) + [_odd(JTenantRecord)]
    donors = {r.tenant_id: _load(platform["torch_donors"], r.tenant_id)
              for r in recs}
    jdonors = {r.tenant_id: JBinarySVC.load(os.path.join(
        platform["jax_donors"], r.tenant_id + ".npz")) for r in jrecs}
    plan = coalesce_drifted(recs, donors)
    assert plan.to_json() == j_coalesce(jrecs, jdonors).to_json()
    assert plan.to_json() == {"launches": [["t0", "t1", "t2", "t3", "t4"]],
                              "solos": ["t5"]}
    ids = plan.launches[0]
    labels = [tenant_labels(LABELS, r) for r in recs[:5]]
    batch = pack_problems([y for y, _ in labels], [r.C for r in recs[:5]],
                          [r.gamma for r in recs[:5]],
                          valids=[v for _, v in labels])
    opts = dict(eps=1e-12, tau=1e-5, max_iter=100000, kernel="rbf",
                degree=3, coef0=0.0, **SOLVER_OPTS)
    ours = _launch_fingerprint(XALL, batch, ids,
                               dict(opts, accum_dtype=torch.float64))
    theirs = j_fp(XALL, batch, ids, dict(opts, accum_dtype=np.float64))
    assert ours.pop("accum_dtype") == "float64"
    theirs.pop("accum_dtype")
    assert ours == theirs


def test_coalesced_lanes_equal_their_solo_refreshes_bit_for_bit(platform):
    outcomes, adir = platform["kernel"]
    assert {t: o["mode"] for t, o in outcomes.items()} == {
        "t0": "fleet", "t1": "fleet", "t2": "fleet", "t3": "fleet",
        "t4": "fleet", "t5": "solo"}
    for tid, solo in platform["solo"].items():
        m = _load(adir, tid)
        assert m.status_ == solo.status_ == Status.CONVERGED, tid
        assert m.sv_alpha_.tobytes() == solo.sv_alpha_.tobytes(), tid
        assert np.array_equal(m.sv_ids_, solo.sv_ids_), tid
        assert m.sv_X_.tobytes() == solo.sv_X_.tobytes(), tid
        assert (m.b_, outcomes[tid]["n_iter"]) == (solo.b_, solo.n_iter_), \
            tid


def test_lane_order_is_bitwise_invariant(platform):
    _, fwd = platform["warm"]
    _, rev = platform["warm_rev"]
    for tid in platform["solo"]:
        a = np.load(os.path.join(fwd, tid + ".npz"))
        b = np.load(os.path.join(rev, tid + ".npz"))
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), f"{tid}:{k}"
    # the cold arm converges to the warm arm's solutions
    for tid, o in platform["cold"][0].items():
        assert int(o["status"]) == Status.CONVERGED, tid
        warm = _load(fwd, tid)
        cold = _load(platform["cold"][1], tid)
        np.testing.assert_array_equal(warm.sv_ids_, cold.sv_ids_)


def test_each_tenant_meets_jax_at_the_cross_engine_band(platform):
    ours, adir = platform["warm"]
    theirs, jdir = platform["jax_warm"]
    for tid in platform["solo"]:
        assert ours[tid]["mode"] == theirs[tid]["mode"], tid
        m = _load(adir, tid)
        j = JBinarySVC.load(os.path.join(jdir, tid + ".npz"))
        assert int(m.status_) == int(theirs[tid]["status"]) \
            == Status.CONVERGED, tid
        np.testing.assert_array_equal(m.sv_ids_, j.sv_ids_)
        assert abs(m.b_ - j.b_) <= 1e-4, tid


def test_a_killed_coalesced_refresh_resumes_bit_for_bit(tmp_path, platform):
    donors = platform["torch_donors"]

    def run(name, plan=None):
        recs = _records() + [_odd()]
        for r in recs:
            r.model_path = os.path.join(donors, r.tenant_id + ".npz")
        outdir, ckdir = str(tmp_path / name), str(tmp_path / (name + "_ck"))
        kw = dict(artifacts_dir=outdir, checkpoint_dir=ckdir,
                  checkpoint_every=2, resume=True, solver_opts=SOLVER_OPTS,
                  device="cpu")
        if plan is not None:
            with pytest.raises(faults.SimulatedKill):
                with faults.active(plan):
                    refresh_drifted(XALL, LABELS, recs, **kw)
            assert any(f.endswith(".ck.npz") for f in os.listdir(ckdir))
        refresh_drifted(XALL, LABELS, recs, **kw)
        return outdir

    ctl = run("ctl")
    killed = run("kill", faults.FaultPlan([faults.FaultRule(
        point="tenants.store", kind="kill", at_hit=2)], seed=5))
    for tid in platform["solo"]:
        a = np.load(os.path.join(ctl, tid + ".npz"))
        b = np.load(os.path.join(killed, tid + ".npz"))
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), f"{tid}:{k}"
        # a segmented launch equals the one-segment launch
        c = np.load(os.path.join(platform["warm"][1], tid + ".npz"))
        assert a["sv_alpha"].tobytes() == c["sv_alpha"].tobytes(), tid


# -------------------------------------------------------- the supervisor
def _platform_dir(tmp_path, n_tenants=3):
    data = str(tmp_path / "data")
    ingest_arrays(data, XALL[:N0], LABELS[:N0], rows_per_shard=64)
    donors = str(tmp_path / "donors")
    recs = _records(n=n_tenants)
    provision_tenants(XALL[:N0], LABELS[:N0], recs, artifacts_dir=donors,
                      solver_opts=SOLVER_OPTS, device="cpu")
    return data, recs


def _cfg(tmp_path, data, **kw):
    base = dict(data_dir=data, store_path=str(tmp_path / "store.json"),
                artifacts_dir=str(tmp_path / "artifacts"),
                thresholds=DriftThresholds(growth=0.25, feature=None,
                                           score=None, jitter_frac=0.0),
                hysteresis=1, cooldown_s=0.0, checkpoint_every=4,
                min_fleet=2, seed=11, solver_opts=SOLVER_OPTS, device="cpu")
    base.update(kw)
    return TenantsConfig(**base)


def _grow(data):
    w = ShardWriter.open_append(data)
    w.append(XALL[N0:], LABELS[N0:])
    w.close()


def test_the_supervisor_watches_refreshes_and_resumes(tmp_path):
    data, recs = _platform_dir(tmp_path)
    sup = TenantsSupervisor(_cfg(tmp_path, data, hysteresis=2), log_fn=None)
    for rec in recs:
        sup.register(rec)
    with pytest.raises(ValueError, match="already registered"):
        sup.register(dataclasses.replace(recs[0]))
    assert sup.tick()["status"] == TenantsStatus.WATCHING
    _grow(data)
    assert sup.tick()["status"] == TenantsStatus.TRIGGERED_HYSTERESIS
    out = sup.tick()
    assert out["status"] == TenantsStatus.REFRESHED
    assert sorted(out["drifted"]) == [r.tenant_id for r in recs]
    for rec in recs:
        st = sup.state.tenants[rec.tenant_id]
        assert st.generation == 1 and st.rows_at_refresh == N0 + GROW
        assert os.path.exists(st.model_path)
    # the checkpoints are gone after the swapping-stage commit
    assert not [f for f in os.listdir(sup.cfg.artifacts_dir)
                if f.endswith(".ck.npz")]
    assert sup.tick()["status"] == TenantsStatus.WATCHING
    again = TenantsSupervisor(_cfg(tmp_path, data, hysteresis=2),
                              resume=True, log_fn=None)
    assert again.state.to_json() == sup.state.to_json()
    with pytest.raises(ValueError, match="seed"):
        TenantsSupervisor(_cfg(tmp_path, data, seed=12), resume=True,
                          log_fn=None)


def test_the_breaker_suppresses_a_failing_refresh_stage(tmp_path,
                                                        monkeypatch):
    data, recs = _platform_dir(tmp_path, n_tenants=2)
    sup = TenantsSupervisor(_cfg(tmp_path, data, breaker_threshold=1,
                                 breaker_cooldown_s=3600.0), log_fn=None)
    for rec in recs:
        sup.register(rec)

    def boom(*a, **kw):
        raise RuntimeError("refresh infra down")

    monkeypatch.setattr("tpusvm_torch.tenants.loop.refresh_drifted", boom)
    _grow(data)
    assert sup.tick()["status"] == TenantsStatus.REFRESH_FAILED
    assert sup.state.failures >= 1
    assert sup.tick()["status"] == TenantsStatus.SUPPRESSED_BREAKER
