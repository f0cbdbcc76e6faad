"""The fleet (B SVM problems over one X in one lockstep solve) in the port,
on the CPU, mirroring tests/test_fleet.py.

Bitwise where the port's design gives it: every per-lane computation is
the solo solver's on that lane's data, so a lane's bits do not depend on
its companions or its position, a frozen lane equals its solo solve,
compact_every is accepted and inert (a frozen lane already costs nothing),
and each lane equals the
port's solo blocked solve at inner="kernel" with the fused f-update (on
the CPU the kernels' plain versions run). Against the JAX fleet on the
same numpy problems (made from a seed), at the solution level: the same
SV sets and statuses, b within 1e-4 (the two packages' f-updates round
their f32 sums differently, and the JAX fleet runs its XLA loop engine).
test_one_compile_per_bucket_across_cg_sweep has no counterpart here: the
port compiles nothing per shape (its kernels are built once). The tune
and tenant consumers wait for ROADMAP Queue 1 item 11.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.fleet import fleet_train as j_fleet_train
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (BENCH_NOISE_MULTICLASS,
                                         mnist_like_multiclass, rings)
from tpusvm_torch.fleet import (bucket_for, fleet_convergence_summary,
                                fleet_opt_errors, fleet_smo_solve,
                                fleet_train, pack_problems, unpack_results)
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.status import Status

jax.config.update("jax_enable_x64", True)

KW = dict(q=128, accum_dtype=torch.float64)
SOLO = dict(KW, inner="kernel", fused_fupdate=True)


@pytest.fixture(scope="module")
def rings_problem():
    X, Y = rings(n=256, seed=5)
    return MinMaxScaler().fit_transform(X).astype(np.float32), np.asarray(Y)


def _fleet(X, Ys, Cs, gs, **kw):
    return fleet_smo_solve(X, np.stack(Ys), Cs=Cs, gammas=gs, device="cpu",
                           **{**KW, **kw})


def _train(X, Ys, Cs, gs, **kw):
    return fleet_train(X, Ys, Cs, gs, device="cpu", **{**KW, **kw})


def _solo(X, y, C, g, **kw):
    return blocked_smo_solve(X, y, C=C, gamma=g, device="cpu",
                             **{**SOLO, **kw})


def _sv(alpha):
    return np.nonzero(np.asarray(alpha) > 1e-8)[0]


def _same_lane(a, b):
    """Two per-problem results, bit for bit."""
    assert torch.equal(a.alpha, b.alpha)
    assert (float(a.b), int(a.n_iter), int(a.status), int(a.n_outer)) == (
        float(b.b), int(b.n_iter), int(b.status), int(b.n_outer))


# ------------------------------------------------------------- bucketing
def test_bucket_for_powers_of_two():
    assert [bucket_for(b) for b in (1, 2, 3, 5, 8, 9, 16, 17)] == \
        [1, 2, 4, 8, 8, 16, 16, 32]
    with pytest.raises(ValueError):
        bucket_for(0)


def test_pack_validation_errors(rings_problem):
    _, Y = rings_problem
    with pytest.raises(ValueError, match="empty problem list"):
        pack_problems([], [], [])
    with pytest.raises(ValueError, match="C values"):
        pack_problems([Y], [1.0, 2.0], [1.0])
    with pytest.raises(ValueError, match="positive finite"):
        pack_problems([Y], [-1.0], [1.0])
    with pytest.raises(ValueError, match="outside"):
        pack_problems([np.full_like(Y, 2)], [1.0], [1.0])
    with pytest.raises(ValueError, match="zero labels on live rows"):
        y0 = Y.copy()
        y0[3] = 0
        pack_problems([y0], [1.0], [1.0])
    valid = np.ones(len(Y), bool)
    valid[3] = False
    y0 = Y.copy()
    y0[3] = 0
    batch = pack_problems([y0], [1.0], [1.0], valids=[valid])
    assert batch.bucket == 1 and batch.n_problems == 1
    with pytest.raises(ValueError, match="power of two"):
        pack_problems([Y, Y, Y], [1.0] * 3, [1.0] * 3, bucket=3)


@pytest.mark.parametrize("bad", [dict(krow_cache=64), dict(inner="pallas"),
                                 dict(shrink_stable=3),
                                 dict(fused_fupdate=True),
                                 dict(pallas_fused_selection=True),
                                 dict(pallas_multipair=2),
                                 dict(pause_at=3)])
def test_unsupported_fleet_opts_rejected(rings_problem, bad):
    X, Y = rings_problem
    with pytest.raises(ValueError, match="not fleet-compatible"):
        _train(X, [Y], [10.0], [10.0], **bad)
    with pytest.raises(ValueError, match="not fleet-compatible"):
        j_fleet_train(jnp.asarray(X), [Y], [10.0], [10.0], q=128, **bad)
    assert fleet_opt_errors(dict(inner="xla", krow_cache=0)) == []


# ------------------------------------- masking / padding / lane invariance
def test_companion_and_lane_invariance_bitwise(rings_problem):
    X, Y = rings_problem
    P, Q, D = Y, -Y, np.zeros_like(Y)
    r1 = _fleet(X, [P, Q], [10.0, 1.0], [10.0, 5.0])
    r2 = _fleet(X, [P, D], [10.0, 1.0], [10.0, 5.0])
    r3 = _fleet(X, [Q, P], [1.0, 10.0], [5.0, 10.0])
    a = r1.alpha[0]
    assert torch.equal(a, r2.alpha[0]) and torch.equal(a, r3.alpha[1])
    assert float(r1.b[0]) == float(r2.b[0]) == float(r3.b[1])
    assert int(r1.n_outer[0]) == int(r3.n_outer[1])
    assert torch.equal(r1.alpha[1], r3.alpha[0])


def test_padding_lanes_inert(rings_problem):
    X, Y = rings_problem
    res = _train(X, [Y, -Y, Y], [10.0, 1.0, 5.0], [10.0, 5.0, 2.0])
    raw = _fleet(X, [Y, -Y, Y, np.zeros_like(Y)], [10.0, 1.0, 5.0, 1.0],
                 [10.0, 5.0, 2.0, 1.0])
    assert int(raw.status[3]) == Status.NO_WORKING_SET
    assert int(raw.n_iter[3]) == 1 and int(raw.n_outer[3]) == 0
    assert (raw.alpha[3] == 0).all()
    for i, r in enumerate(unpack_results(raw, 3)):
        _same_lane(r, res[i])


def test_fast_problem_frozen_next_to_slow_matches_solo(rings_problem):
    """An easy (warm-started) lane converges at the first check beside a
    slow cold lane: it equals itself beside an inert dummy bit for bit and
    keeps its seed; the slow lane equals its solo solve bit for bit."""
    X, Y = rings_problem
    solo = _solo(X, Y, 10.0, 10.0)
    seed = solo.alpha.numpy()
    fast_slow = _train(X, [Y, -Y], [10.0, 1.0], [10.0, 5.0],
                       alpha0s=[seed, None])
    fast_dummy = fleet_smo_solve(
        X, np.stack([Y, np.zeros_like(Y)]), np.ones((2, len(Y)), bool),
        np.stack([seed, np.zeros_like(seed)]), Cs=[10.0, 1.0],
        gammas=[10.0, 5.0], warm_start=True, device="cpu", **KW)
    fast = fast_slow[0]
    assert int(fast.status) == Status.CONVERGED and int(fast.n_iter) == 1
    assert torch.equal(fast.alpha, fast_dummy.alpha[0])
    np.testing.assert_array_equal(_sv(fast.alpha), _sv(seed))
    np.testing.assert_allclose(fast.alpha.numpy(), seed, atol=1e-10)
    _same_lane(fast_slow[1], _solo(X, -Y, 1.0, 5.0))


@pytest.mark.parametrize("wss", [1, 2])
def test_fleet_lanes_equal_solo_solves(rings_problem, wss):
    """Each lane equals the port's solo blocked solve (the kernel engine,
    the fused f-update) bit for bit, and meets the JAX solo solve at the
    solution level."""
    from tpusvm.solver import blocked_smo_solve as j_solve

    X, Y = rings_problem
    problems = [(Y, 10.0, 10.0), (-Y, 1.0, 5.0), (Y, 5.0, 2.0)]
    fl = _train(X, [p[0] for p in problems], [p[1] for p in problems],
                [p[2] for p in problems], wss=wss)
    for (y, C, g), r in zip(problems, fl):
        _same_lane(r, _solo(X, y, C, g, wss=wss))
        j = j_solve(jnp.asarray(X), jnp.asarray(y), C=C, gamma=g, q=128,
                    wss=wss, accum_dtype=jnp.float64)
        assert int(r.status) == int(j.status) == Status.CONVERGED
        np.testing.assert_array_equal(_sv(r.alpha), _sv(j.alpha))
        assert abs(float(r.b) - float(j.b)) <= 1e-4


def test_compaction_is_exact_per_lane(rings_problem):
    X, Y = rings_problem
    rng = np.random.default_rng(0)
    B = 6
    Cs = [float(c) for c in rng.choice([0.5, 1.0, 5.0, 10.0], B)]
    gs = [float(g) for g in rng.choice([2.0, 5.0, 10.0], B)]
    stats_m, stats_c = {}, {}
    mono = _train(X, [Y] * B, Cs, gs, stats=stats_m)
    comp = _train(X, [Y] * B, Cs, gs, compact_every=3, stats=stats_c)
    for m, c in zip(mono, comp):
        assert int(m.status) == Status.CONVERGED
        _same_lane(m, c)
    # compaction is inert in the port: a frozen lane already runs nothing,
    # so the compacted call solves the same subproblems in the same rounds
    for k in ("rounds", "lane_rounds", "bucket_rounds", "host_syncs"):
        assert stats_c[k] == stats_m[k], k
    with pytest.raises(ValueError, match="compact_every must be >= 0"):
        _train(X, [Y], [1.0], [1.0], compact_every=-1)
    # frozen lanes cost nothing: the lanes' subproblems are the same
    assert stats_m["lane_rounds"] == sum(int(r.n_outer) for r in mono)
    assert stats_m["bucket_rounds"] == 8 * stats_m["rounds"]
    # two host syncs a round at most, for the whole fleet
    assert stats_m["host_syncs"] <= 2 * stats_m["rounds"]


def test_pause_and_resume_is_exact_per_lane(rings_problem):
    """fleet_smo_solve's JAX resume surface: paused at each lane's third
    outer round and resumed from the returned FleetState, every lane
    equals the uninterrupted solve bit for bit."""
    X, Y = rings_problem
    Ys, Cs, gs = [Y, -Y, Y], [10.0, 1.0, 0.5], [10.0, 5.0, 2.0]
    full = _fleet(X, Ys, Cs, gs, telemetry=8)
    part, st = _fleet(X, Ys, Cs, gs, telemetry=8, pause_at=3,
                      return_state=True)
    assert all(int(k) <= 3 for k in part.n_outer)
    assert any(s == Status.RUNNING for s in part.status)
    done = _fleet(X, Ys, Cs, gs, telemetry=8, resume_states=st)
    for a, b in zip(unpack_results(full, 3), unpack_results(done, 3)):
        _same_lane(a, b)
        assert torch.equal(a.telemetry.gap.nan_to_num(7.0),
                           b.telemetry.gap.nan_to_num(7.0))


def test_valid_mask_padding_rows(rings_problem):
    X, Y = rings_problem
    n = len(Y)
    valid = np.ones(n, bool)
    valid[200:] = False
    y_masked = Y.copy()
    y_masked[200:] = 0
    res = _train(X, [y_masked, Y], [10.0, 10.0], [10.0, 10.0],
                 valids=[valid, None])
    assert (res[0].alpha[200:] == 0).all()
    solo = blocked_smo_solve(X[:200], Y[:200], C=10.0, gamma=10.0,
                             device="cpu", **KW)
    np.testing.assert_array_equal(_sv(res[0].alpha[:200]), _sv(solo.alpha))
    _same_lane(res[1], _solo(X, Y, 10.0, 10.0))


# ----------------------------------------------------- telemetry + results
def test_per_problem_telemetry_and_summary(rings_problem):
    from tpusvm_torch.obs.convergence import materialize

    X, Y = rings_problem
    res = _train(X, [Y, -Y], [10.0, 1.0], [10.0, 5.0], telemetry=8)
    for r, (y, C, g) in zip(res, ((Y, 10.0, 10.0), (-Y, 1.0, 5.0))):
        assert int(r.telemetry.count) == int(r.n_outer) + 1
        solo = _solo(X, y, C, g, telemetry=8)
        a, b = materialize(r.telemetry), materialize(solo.telemetry)
        for k in ("gap", "updates", "status", "active"):
            assert np.array_equal(a[k], b[k], equal_nan=k == "gap")
    summary = fleet_convergence_summary(res)
    assert summary["problems"] == 2 and summary["converged"] == 2
    assert summary["statuses"] == ["CONVERGED", "CONVERGED"]
    assert summary["telemetry_rounds"] == [int(r.telemetry.count)
                                           for r in res]


def test_fleet_train_matches_jax(rings_problem):
    """The port's fleet_train against the JAX fleet_train on the same
    problems: the same SV sets and statuses, b within 1e-4, both with and
    without compaction."""
    X, Y = rings_problem
    rng = np.random.default_rng(7)
    Ys = [Y, -Y, np.where(rng.random(len(Y)) < 0.5, Y, -Y).astype(np.int32)]
    Cs, gs = [10.0, 1.0, 1.0], [10.0, 5.0, 2.0]
    for compact in (0, 2):
        t = _train(X, Ys, Cs, gs, compact_every=compact, max_iter=10**6)
        j = j_fleet_train(jnp.asarray(X), Ys, Cs, gs, q=128,
                          accum_dtype=jnp.float64, compact_every=compact,
                          max_iter=10**6)
        for a, b in zip(t, j):
            assert int(a.status) == int(b.status)
            np.testing.assert_array_equal(_sv(a.alpha), _sv(b.alpha))
            assert abs(float(a.b) - float(b.b)) <= 1e-4


def test_bf16_fleet_needs_refine_and_meets_the_gates(rings_problem):
    """The fleet has no shrinking driver, so a bf16 rung needs refine; with
    it, each lane meets benchmarks/solver_ladder.py's gates against the f32
    fleet, on the ladder's workload (mnist_like at the bench recipe's noise,
    gamma scaled to d)."""
    from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                             mnist_like)

    X, Y = rings_problem
    with pytest.raises(ValueError, match="bf16_f32"):
        _train(X, [Y], [10.0], [10.0], matmul_precision="bf16_f32")
    X, Y = mnist_like(n=256, d=16, noise=BENCH_NOISE,
                      label_noise=BENCH_LABEL_NOISE, seed=587)
    X = MinMaxScaler().fit_transform(X).astype(np.float32)
    Ys, Cs, gs = [Y, -Y], [10.0, 1.0], [0.06125, 0.06125]
    f32 = _train(X, Ys, Cs, gs, max_iter=10**7)
    bf = _train(X, Ys, Cs, gs, max_iter=10**7, matmul_precision="bf16_f32",
                refine=256)
    for a, b in zip(f32, bf):
        assert int(a.status) == int(b.status) == Status.CONVERGED
        assert int(b.n_refines) >= 1
        assert len(set(_sv(a.alpha)) ^ set(_sv(b.alpha))) <= max(
            2, len(_sv(a.alpha)) // 25)
        assert abs(float(a.b) - float(b.b)) <= 1e-3


# --------------------------------------------------------- OvR consumer
@pytest.fixture(scope="module")
def ovr_data():
    X, labels = mnist_like_multiclass(n=460, d=32,
                                      noise=BENCH_NOISE_MULTICLASS, seed=3)
    return X[:400], labels[:400], X[400:], labels[400:]


def _ovr(solver, data, **opts):
    from tpusvm_torch.models import OneVsRestSVC

    Xtr, ytr, _, _ = data
    cfg = SVMConfig(C=10.0, gamma=1.0 / 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return OneVsRestSVC(config=cfg, solver=solver,
                            solver_opts=dict(q=128, **opts),
                            device="cpu").fit(Xtr, ytr)


@pytest.fixture(scope="module")
def ovr_fleet(ovr_data):
    return _ovr("fleet", ovr_data)


def test_ovr_fleet_vs_loop_parity(ovr_data, ovr_fleet):
    """solver='fleet' against solver='blocked' on the same knobs (the
    kernel engine, the fused f-update): every head bit for bit, so equal
    statuses, SV unions, coefficients, b and held-out accuracy."""
    loop = _ovr("blocked", ovr_data, inner="kernel", fused_fupdate=True)
    fleet = ovr_fleet
    assert (loop.statuses_ == fleet.statuses_).all()
    assert np.array_equal(loop.X_sv_, fleet.X_sv_)
    assert np.array_equal(loop.coef_, fleet.coef_)
    assert np.array_equal(loop.b_, fleet.b_)
    _, _, Xte, yte = ovr_data
    assert loop.score(Xte, yte) == fleet.score(Xte, yte)
    stats = fleet.fleet_stats_
    assert stats["host_syncs"] <= 2 * stats["rounds"]


def test_ovr_fleet_matches_the_jax_fleet(ovr_data, ovr_fleet):
    from tpusvm.config import SVMConfig as JCfg
    from tpusvm.models import OneVsRestSVC as JOvR

    fleet = ovr_fleet
    Xtr, ytr, Xte, yte = ovr_data
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = JOvR(config=JCfg(C=10.0, gamma=1.0 / 32), solver="fleet",
                 solver_opts=dict(q=128)).fit(Xtr, ytr)
    assert (fleet.statuses_ == np.asarray(j.statuses_)).all()
    assert np.array_equal(fleet.sv_ids_, np.asarray(j.sv_ids_))
    assert np.array_equal(fleet.coef_ != 0, np.asarray(j.coef_) != 0)
    np.testing.assert_allclose(fleet.b_, np.asarray(j.b_), atol=1e-4)
    assert fleet.score(Xte, yte) == j.score(Xte, yte)


def test_fleet_ovr_artifact_loads_and_scores_in_jax(ovr_data, ovr_fleet,
                                                    tmp_path):
    from tpusvm.models import load_any as j_load_any

    fleet = ovr_fleet
    path = str(tmp_path / "ovr.npz")
    fleet.save(path)
    _, _, Xte, _ = ovr_data
    j = j_load_any(path)
    np.testing.assert_allclose(np.asarray(j.decision_function(Xte)),
                               fleet.decision_function(Xte), atol=1e-4)
    assert np.array_equal(np.asarray(j.predict(Xte)), fleet.predict(Xte))


def test_cli_fleet(capsys):
    from tpusvm_torch.cli import main

    base = ["train", "--synthetic", "mnist_like_multiclass", "--multiclass",
            "--n", "200", "--n-test", "60", "--d", "16", "--gamma", "0.06",
            "--q", "128", "--device", "cpu"]
    assert main(base + ["--fleet", "--fleet-compact", "2"]) == 0
    out = capsys.readouterr().out
    assert "status = ['CONVERGED'" in out
    for bad, msg in ((["--fleet", "--solver", "pair"], "conflict"),
                     (["--fleet-compact", "2"], "needs --fleet"),
                     (["--fleet", "--solver-opt", "foo=1"], "unknown"),
                     (["--fleet", "--fleet-compact", "2", "--solver-opt",
                       "compact_every=3"], "same knob"),
                     (["--fleet", "--precision", "bf16_f32"], "ladder knob")):
        with pytest.raises(SystemExit, match=msg):
            main(base + bad)
    with pytest.raises(SystemExit, match="requires --multiclass"):
        main(["train", "--synthetic", "rings", "--n", "100", "--fleet",
              "--device", "cpu"])
