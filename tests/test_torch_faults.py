"""The port's fault machinery against the JAX package's copies, on the CPU.

Band: exact. The same plan fires the same rules on the same hits in both
packages (transient, latency, at_hit, max_hits, p-draws, and the corrupt
rule's byte offset); a retry policy's backoff schedule is the same list
of floats; plans and rules are refused by the same checks; the metrics
registries' snapshots merge alike. The solver checkpoint writer retries
a transient fault to the uninterrupted bits, and a simulated kill at
EVERY checkpoint resumes to them (the port's counterpart of
tests/test_faults.py::test_kill_at_every_checkpoint_resume_bit_identical).
"""

import dataclasses
import json
import os

import pytest
import torch

from tpusvm import faults as jfaults
from tpusvm.obs import registry as jreg
from tpusvm_torch import faults
from tpusvm_torch.data import MinMaxScaler, rings
from tpusvm_torch.obs import registry as treg
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.checkpoint import checkpointed_blocked_solve
from tpusvm_torch.status import Status


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.deactivate()
    faults.set_event_sink(None)
    jfaults.deactivate()


_PLANS = [
    {"rules": [{"point": "stream.read_shard", "kind": "transient",
                "p": 0.4}], "seed": 7},
    {"rules": [{"point": "solver.outer_checkpoint", "kind": "kill",
                "at_hit": 3},
               {"point": "stream.read_shard", "kind": "transient",
                "max_hits": 2}], "seed": 0},
    {"rules": [{"point": "ingest.write_shard", "kind": "corrupt", "p": 0.5},
               {"point": "ingest.write_shard", "kind": "latency",
                "delay_ms": 0.01, "p": 0.3}], "seed": 11},
    {"rules": [{"point": "stream.journal", "kind": "transient",
                "p": 0.5, "max_hits": 3},
               {"point": "cascade.round", "kind": "kill", "p": 0.2}],
     "seed": 3},
]


def _drive(pkg, plan_json, hits=24):
    """Outcome of every hit of every point the plan names."""
    plan = pkg.FaultPlan.from_json(dict(plan_json, format_version=1))
    points = sorted({r["point"] for r in plan_json["rules"]})
    payload = bytes(range(256)) * 2
    out = []
    with pkg.active(plan):
        for _ in range(hits):
            for p in points:
                try:
                    got = pkg.point(p, payload=payload)
                    out.append((p, "ok" if got == payload else
                                bytes(a ^ b for a, b in zip(got, payload))
                                .hex()))
                except pkg.TransientIOError:
                    out.append((p, "transient"))
                except pkg.SimulatedKill:
                    out.append((p, "kill"))
    return out, {p: plan.hits(p) for p in points}


@pytest.mark.parametrize("i", range(len(_PLANS)))
def test_the_same_rules_fire_on_the_same_hits(i):
    got = _drive(faults, _PLANS[i])
    want = _drive(jfaults, _PLANS[i])
    assert got == want
    assert any(o != "ok" for _, o in got[0])


def test_plan_file_and_validation_are_the_jax_packages(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(dict(_PLANS[1], format_version=1)))
    assert [dataclasses.asdict(r) for r in faults.load_plan(str(path)).rules] \
        == [dataclasses.asdict(r) for r in jfaults.load_plan(str(path)).rules]
    assert faults.POINTS == jfaults.POINTS and faults.KINDS == jfaults.KINDS
    bad = [({"format_version": 2}, "unsupported fault plan format_version"),
           ({}, "no format_version"),
           ({"format_version": 1, "rules": [{"point": "nope",
                                            "kind": "kill"}]},
            "unknown injection point"),
           ({"format_version": 1, "rules": [{"point": "stream.read_shard",
                                            "kind": "melt"}]},
            "unknown kind"),
           ({"format_version": 1, "rules": [{"point": "stream.read_shard",
                                            "kind": "kill", "when": 1}]},
            "unknown keys"),
           ({"format_version": 1, "rules": [{"point": "stream.read_shard",
                                            "kind": "kill", "p": 2}]},
            "p must be in"),
           ({"format_version": 1, "rules": [{"point": "stream.read_shard",
                                            "kind": "kill", "at_hit": 0}]},
            "at_hit must be")]
    for obj, msg in bad:
        for pkg in (faults, jfaults):
            with pytest.raises(ValueError, match=msg):
                pkg.FaultPlan.from_json(obj)
    path.write_text("not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        faults.load_plan(str(path))
    assert faults.point("stream.read_shard") is None
    with faults.active(faults.FaultPlan([])):
        with pytest.raises(ValueError, match="unregistered"):
            faults.point("stream.reed_shard")
    corrupt = faults.FaultPlan([faults.FaultRule(point="stream.read_shard",
                                                 kind="corrupt")])
    with faults.active(corrupt):
        with pytest.raises(ValueError, match="carries no byte payload"):
            faults.point("stream.read_shard")


@pytest.mark.parametrize("seed,jitter", [(0, 0.5), (3, 0.25), (9, 0.0)])
def test_retry_schedule_is_the_jax_packages(seed, jitter):
    kw = dict(max_attempts=6, base_delay_s=0.01, max_delay_s=0.05,
              multiplier=2.0, jitter=jitter, seed=seed)

    def schedule(pkg, reg):
        sleeps, calls = [], {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 6:
                raise pkg.TransientIOError("flaky")
            return "done"

        r = pkg.Retry(pkg.RetryPolicy(**kw), op="t", metrics=reg,
                      sleep=sleeps.append)
        assert r(flaky) == "done"
        return sleeps

    reg = treg.MetricsRegistry()
    assert schedule(faults, reg) == schedule(jfaults, jreg.MetricsRegistry())
    assert reg.counter("retry.recovered", op="t").value == 1
    assert reg.counter("retry.attempts", op="t").value == 6


def test_retry_exhaustion_and_classification():
    reg = treg.MetricsRegistry()
    events = []
    faults.set_event_sink(lambda name, **a: events.append(name))
    r = faults.Retry(faults.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                        jitter=0.0), op="x", metrics=reg,
                     sleep=lambda s: None)

    def always():
        raise faults.TransientIOError("nope")

    with pytest.raises(faults.RetryExhaustedError) as ei:
        r(always)
    jr = jfaults.Retry(jfaults.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                           jitter=0.0), op="x",
                       metrics=jreg.MetricsRegistry(), sleep=lambda s: None)
    with pytest.raises(jfaults.RetryExhaustedError) as ej:
        jr(lambda: (_ for _ in ()).throw(jfaults.TransientIOError("nope")))
    assert str(ei.value) == str(ej.value)
    assert ei.value.attempts == 3
    assert reg.counter("retry.exhausted", op="x").value == 1
    assert events == ["retry.failed_attempt"] * 3 + ["retry.exhausted"]
    with pytest.raises(KeyError):
        r(lambda: {}["real bug"])
    with pytest.raises(faults.SimulatedKill):
        r(lambda: (_ for _ in ()).throw(faults.SimulatedKill("die")))
    with pytest.raises(ValueError, match="max_attempts"):
        faults.RetryPolicy(max_attempts=0)


def test_registry_snapshots_merge_like_the_jax_packages():
    def fill(mod):
        a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
        a.counter("retry.attempts", op="r").inc(3)
        b.counter("retry.attempts", op="r").inc(4)
        a.gauge("stream.live_shards").set_max(2)
        b.gauge("stream.live_shards").set_max(3)
        for v in (0.002, 0.2, 7.0):
            a.histogram("h", bounds=(0.01, 1.0)).observe(v)
        b.histogram("h", bounds=(0.01, 1.0)).observe(0.5)
        merged = mod.merge_snapshots(a.snapshot(), b.snapshot())
        return merged, mod.render_snapshot_text(merged)

    assert fill(treg) == fill(jreg)
    with pytest.raises(TypeError, match="already registered"):
        r = treg.MetricsRegistry()
        r.counter("x")
        r.gauge("x")


def _solve_args():
    X, Y = rings(n=400, seed=11)
    Xs = torch.as_tensor(MinMaxScaler().fit_transform(X), dtype=torch.float32)
    return Xs, torch.as_tensor(Y), dict(C=10.0, gamma=10.0, q=16,
                                        accum_dtype=torch.float64,
                                        device="cpu")


def test_checkpoint_write_transients_are_retried(tmp_path):
    Xs, Y, kw = _solve_args()
    plain = blocked_smo_solve(Xs, Y, **kw)
    reg = treg.default_registry()
    before = reg.counter("retry.recovered", op="solver.outer_checkpoint").value
    plan = faults.FaultPlan([faults.FaultRule(
        point="solver.outer_checkpoint", kind="transient", max_hits=2)])
    with faults.active(plan):
        res = checkpointed_blocked_solve(
            Xs, Y, checkpoint_path=str(tmp_path / "ck.npz"),
            checkpoint_every=4, **kw)
    assert Status(int(res.status)) == Status.CONVERGED
    assert res.alpha.numpy().tobytes() == plain.alpha.numpy().tobytes()
    assert float(res.b) == float(plain.b)
    assert reg.counter("retry.recovered",
                       op="solver.outer_checkpoint").value > before
    assert reg.counter("faults.injected", point="solver.outer_checkpoint",
                       kind="transient").value >= 2


def test_kill_at_every_checkpoint_resume_bit_identical(tmp_path):
    Xs, Y, kw = _solve_args()
    plain = blocked_smo_solve(Xs, Y, **kw)
    ref = plain.alpha.numpy()
    n_ckpts = int(plain.n_outer) // 4
    assert n_ckpts >= 2, "problem too easy to exercise checkpoints"
    for k in range(1, n_ckpts + 1):
        ck = str(tmp_path / f"ck{k}.npz")
        plan = faults.FaultPlan([faults.FaultRule(
            point="solver.outer_checkpoint", kind="kill", at_hit=k)])
        with pytest.raises(faults.SimulatedKill):
            with faults.active(plan):
                checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                           checkpoint_every=4, **kw)
        # the kill dies before the rename: checkpoint k - 1 is on disk
        assert os.path.exists(ck) == (k > 1)
        assert not os.path.exists(ck + ".tmp.npz") or k > 1
        res = checkpointed_blocked_solve(Xs, Y, checkpoint_path=ck,
                                         checkpoint_every=4, resume=True,
                                         **kw)
        assert res.alpha.numpy().tobytes() == ref.tobytes(), f"kill at {k}"
        assert float(res.b) == float(plain.b)
        assert int(res.n_outer) == int(plain.n_outer)
        assert not os.path.exists(ck)
