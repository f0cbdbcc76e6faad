"""The port's cascade and model-save fault points, its chaos command line,
and its blocked solver in X's own dtype, against the JAX package.

Bands: exact for the fault points (a plan fires on ``cascade.round``,
``cascade.checkpoint`` and ``models.save`` as many times in the port as in
the JAX package; two transient hits at ``cascade.round`` and a kill there
followed by a resume give the uninterrupted cascade's bits) and for
``validate`` (the same plans accepted and refused, the same lines
printed). The float64 blocked solve against the JAX solver at float64 on
the CPU: the same status and SV-ID set, |db| <= 1e-4, with K computed in
float64; an explicit kernel engine on float64 features is refused by name.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm import faults as jfaults
from tpusvm.config import CascadeConfig as JCascadeConfig
from tpusvm.config import SVMConfig as JSVMConfig
from tpusvm.faults.__main__ import main as j_faults_main
from tpusvm.models.serialization import save_model as j_save_model
from tpusvm.parallel.cascade import cascade_fit as j_cascade_fit
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch import faults, kernels
from tpusvm_torch.config import CascadeConfig, SVMConfig
from tpusvm_torch.data import MinMaxScaler, rings
from tpusvm_torch.faults.__main__ import main as faults_main
from tpusvm_torch.models.serialization import save_model
from tpusvm_torch.oracle import get_sv_indices
from tpusvm_torch.parallel.cascade import cascade_fit
from tpusvm_torch.solver.blocked import (blocked_smo_solve,
                                         resolve_solver_config)
from tpusvm_torch.status import Status

CFG = SVMConfig(C=10.0, gamma=10.0, max_rounds=12)
JCFG = JSVMConfig(C=10.0, gamma=10.0, max_rounds=12)
CC = CascadeConfig(n_shards=4, sv_capacity=128, topology="tree")
JCC = JCascadeConfig(n_shards=4, sv_capacity=128, topology="tree")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.deactivate()
    jfaults.deactivate()


@pytest.fixture(scope="module")
def data():
    X, Y = rings(n=192, seed=3)
    return MinMaxScaler().fit_transform(X), Y


@pytest.fixture(scope="module")
def control(data):
    Xs, Y = data
    return cascade_fit(Xs, Y, CFG, CC, device="cpu")


def _same_bits(res, ctrl):
    assert np.array_equal(res.sv_ids, ctrl.sv_ids)
    assert res.sv_alpha.tobytes() == ctrl.sv_alpha.tobytes()
    assert res.b == ctrl.b and res.rounds == ctrl.rounds


# ----------------------------------------------------------- cascade.round
def test_cascade_round_transients_are_retried_to_the_same_bits(data,
                                                               control):
    Xs, Y = data
    plan = faults.FaultPlan([faults.FaultRule(
        point="cascade.round", kind="transient", max_hits=2)])
    with faults.active(plan):
        res = cascade_fit(Xs, Y, CFG, CC, device="cpu")
    assert plan.rules[0].fires == 2
    _same_bits(res, control)


def test_cascade_kill_at_round_then_resume_bit_identical(data, control,
                                                         tmp_path):
    Xs, Y = data
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(faults.SimulatedKill):
        with faults.active(faults.FaultPlan([faults.FaultRule(
                point="cascade.round", kind="kill", at_hit=2)])):
            cascade_fit(Xs, Y, CFG, CC, checkpoint_path=ck, device="cpu")
    assert os.path.exists(ck)  # round 1's state, written before the kill
    res = cascade_fit(Xs, Y, CFG, CC, checkpoint_path=ck, resume=True,
                      device="cpu")
    _same_bits(res, control)


def test_kill_at_cascade_checkpoint_leaves_the_previous_round(data, control,
                                                              tmp_path):
    Xs, Y = data
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(faults.SimulatedKill):
        with faults.active(faults.FaultPlan([faults.FaultRule(
                point="cascade.checkpoint", kind="kill", at_hit=2)])):
            cascade_fit(Xs, Y, CFG, CC, checkpoint_path=ck, device="cpu")
    with np.load(ck) as z:
        assert int(z["round"]) == 1
    res = cascade_fit(Xs, Y, CFG, CC, checkpoint_path=ck, resume=True,
                      device="cpu")
    _same_bits(res, control)


# ------------------------------------- the same hits in both packages
def test_points_fire_as_often_as_in_jax(data, tmp_path):
    Xs, Y = data
    rules = [dict(point=p, kind="latency", delay_ms=0.0)
             for p in ("cascade.round", "cascade.checkpoint", "models.save")]
    plan = faults.FaultPlan([faults.FaultRule(**r) for r in rules])
    jplan = jfaults.FaultPlan([jfaults.FaultRule(**r) for r in rules])
    state = {"sv_X": np.zeros((1, 2), np.float32), "b": 0.0}
    with faults.active(plan):
        res = cascade_fit(Xs, Y, CFG, CC, checkpoint_path=str(
            tmp_path / "t.npz"), device="cpu")
        save_model(str(tmp_path / "m"), state, CFG)
    with jfaults.active(jplan):
        jres = j_cascade_fit(Xs, Y, JCFG, JCC, checkpoint_path=str(
            tmp_path / "j.npz"))
        j_save_model(str(tmp_path / "jm"), state, JCFG)
    assert res.rounds == jres.rounds
    for p in ("cascade.round", "cascade.checkpoint", "models.save"):
        assert plan.hits(p) == jplan.hits(p), p
    assert plan.hits("cascade.checkpoint") == res.rounds
    assert plan.hits("models.save") == 1


def test_kill_at_models_save_leaves_no_artifact(tmp_path):
    state = {"sv_X": np.zeros((1, 2), np.float32), "b": 0.0}
    for pkg, save, cfg, name in ((faults, save_model, CFG, "m"),
                                 (jfaults, j_save_model, JCFG, "jm")):
        with pytest.raises(pkg.SimulatedKill):
            with pkg.active(pkg.FaultPlan([pkg.FaultRule(
                    point="models.save", kind="kill", at_hit=1)])):
                save(str(tmp_path / name), state, cfg)
        # the kill comes before the staged write: no artifact, no temp file
        assert os.listdir(tmp_path) == []


# ------------------------------------------------- the chaos command line
_VALIDATE_PLANS = [
    {"format_version": 1, "seed": 3, "rules": [
        {"point": "cascade.round", "kind": "transient", "max_hits": 2},
        {"point": "pod.worker", "kind": "kill", "at_hit": 2},
        {"point": "models.save", "kind": "latency", "delay_ms": 5,
         "p": 0.5}]},
    {"format_version": 1, "rules": [{"point": "cascade.rounds",
                                     "kind": "kill"}]},
    {"format_version": 1, "rules": [{"point": "pod.merge",
                                     "kind": "explode"}]},
    {"format_version": 2, "rules": []},
    {"format_version": 1, "rules": [{"point": "pod.round", "kind": "kill",
                                     "p": 1.5}]},
]


def _outcome(main, path):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(["validate", path])
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return "refused", type(e).__name__
    return rc, out.getvalue()


@pytest.mark.parametrize("plan", _VALIDATE_PLANS)
def test_validate_accepts_and_refuses_as_jax(plan, tmp_path):
    path = str(tmp_path / "plan.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    assert _outcome(faults_main, path) == _outcome(j_faults_main, path)


def test_chaos_commands_of_unported_tiers_exit_2(capsys):
    from tpusvm_torch.faults.__main__ import NOT_PORTED

    # every chaos command of the JAX package is ported: router-chaos-smoke
    # (the last one) now parses its own flags instead of naming its item
    assert NOT_PORTED == {}
    with pytest.raises(SystemExit) as e:
        faults_main(["router-chaos-smoke", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "router-chaos-smoke" in out and "--device" in out
    assert "ROADMAP" not in out
    assert faults_main(["no-such-command"]) == 2


def test_kill_resume_smoke_on_the_cpu(capsys):
    assert faults_main(["kill-resume-smoke", "--device", "cpu"]) == 0
    assert "kill-resume smoke ok" in capsys.readouterr().out


def test_chaos_smokes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not "
                    "reachable")
    for cmd in ("kill-resume-smoke", "pod-chaos-smoke", "swap-chaos-smoke",
                "autopilot-chaos-smoke", "tenant-chaos-smoke",
                "router-chaos-smoke"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            faults_main([cmd])


# ------------------------------------------------ the solve in X's dtype
def _f64_problem():
    X, Y = rings(n=256, seed=5)
    return MinMaxScaler().fit_transform(X).astype(np.float64), Y


def test_float64_blocked_solve_agrees_with_jax_at_float64(monkeypatch):
    X, Y = _f64_problem()
    dtypes = []
    cross = kernels.cross

    def recording_cross(*a, **kw):
        K = cross(*a, **kw)
        dtypes.append(K.dtype)
        return K

    monkeypatch.setattr(kernels, "cross", recording_cross)
    kw = dict(C=10.0, gamma=10.0, q=128, max_inner=256)
    r = blocked_smo_solve(torch.as_tensor(X), torch.as_tensor(Y),
                          accum_dtype=torch.float64, device="cpu", **kw)
    j = j_solve(jnp.asarray(X), jnp.asarray(Y), accum_dtype=jnp.float64,
                **kw)
    assert dtypes and set(dtypes) == {torch.float64}
    assert r.alpha.dtype == torch.float64
    assert Status(int(r.status)) == Status(int(j.status)) == Status.CONVERGED
    assert set(get_sv_indices(r.alpha.numpy(), 1e-8).tolist()) == \
        set(get_sv_indices(np.asarray(j.alpha), 1e-8).tolist())
    assert abs(float(r.b) - float(j.b)) <= 1e-4
    # q=128 is aligned, yet float64 features resolve to the plain engines
    assert resolve_solver_config(256, 128, dtype=torch.float64) == \
        (128, "loop", False)
    assert resolve_solver_config(256, 128) == (128, "kernel", True)


@pytest.mark.parametrize("kw,name", [
    (dict(inner="kernel"), "inner_smo"),
    (dict(fused_fupdate=True), "rbf_cross_matvec"),
])
def test_explicit_kernel_engine_refused_for_float64(kw, name):
    X, Y = _f64_problem()
    with pytest.raises(ValueError, match=f"{name}.*float64"):
        blocked_smo_solve(X, Y, q=128, device="cpu", **kw)
