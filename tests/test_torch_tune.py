"""The port's tune/ against the JAX package's, on the CPU, on
tests/test_tune.py's fixtures at their smallest (rings(n=240, noise=0.25,
seed=3), 2 folds, fold seed 1).

Bands: grid, warm and results equal JAX's value for value (a results JSON
written by either package loads in the other and format_table prints the
same text). tune equals JAX's tune in its point table (status, rung,
subset size, per-fold accuracies, mean SV count) and its winner, in the
grid and halving schedules, with and without the fleet; update counts and
wall seconds are not compared (the engines differ). Inside the port,
every lane of a fleet rung equals a one-lane fleet_train of its problem
with the same seed bit for bit (alpha, b, n_iter, status).
"""

import json

import numpy as np
import pytest
import torch

from tpusvm.data import rings
from tpusvm.solver.blocked import pad_alpha0 as j_pad_alpha0
from tpusvm.tune import TuneConfig as JTuneConfig
from tpusvm.tune import format_table as j_format_table
from tpusvm.tune import load_tune_result as j_load
from tpusvm.tune import save_tune_result as j_save
from tpusvm.tune import tune as j_tune
from tpusvm.tune.grid import log_distance as j_log_distance
from tpusvm.tune.grid import log_grid as j_log_grid
from tpusvm.tune.grid import make_grid as j_make_grid
from tpusvm.tune.grid import nearest_point as j_nearest_point
from tpusvm.tune.search import _rung_sizes as j_rung_sizes
from tpusvm.tune.warm import WarmStore as JWarmStore
from tpusvm.tune.warm import feasible_seed as j_feasible_seed
from tpusvm_torch import fleet
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.solver.blocked import pad_alpha0
from tpusvm_torch.status import TuneStatus
from tpusvm_torch.tune import (TuneConfig, format_table, is_tune_result,
                               load_tune_result, make_grid,
                               normalize_kernel_specs, save_tune_result, tune)
from tpusvm_torch.tune.grid import log_distance, log_grid, nearest_point
from tpusvm_torch.tune.search import _rung_sizes
from tpusvm_torch.tune.warm import WarmStore, feasible_seed

# what the engines do differently: how many updates, how long
NOT_COMPARED = ("n_updates", "wall_s")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rings_data():
    return rings(n=240, noise=0.25, seed=3)


def test_grid_geometry_equals_jax():
    for Cs, gs in (([1.0, 4.0, 16.0], [0.5, 2.0]), ([3.0], [1e-3, 1e-2])):
        assert make_grid(Cs, gs).points() == j_make_grid(Cs, gs).points()
    assert log_grid(10.0, 0.00125).points() == j_log_grid(10.0,
                                                         0.00125).points()
    assert log_grid(2.0, 3.0, span=1, step=3.0) == tuple(
        j_log_grid(2.0, 3.0, span=1, step=3.0))
    pts = [(1.0, 1.0), (4.0, 0.25), (0.5, 8.0), (4.0, 4.0)]
    for target in ((2.0, 2.0), (1.0, 1.0), (16.0, 0.1)):
        assert nearest_point(target, pts) == j_nearest_point(target, pts)
        assert log_distance(target, pts[1]) == j_log_distance(target, pts[1])
    for args in ((1000, 256, 3), (256, 256, 3), (100, 32, 2)):
        assert _rung_sizes(*args) == j_rung_sizes(*args)
    for bad in (([], [1.0]), ([1.0, -1.0], [1.0]), ([1.0, 1.0], [2.0])):
        with pytest.raises(ValueError):
            make_grid(*bad)


def test_warm_seeding_and_pad_alpha0_equal_jax():
    rng = np.random.default_rng(0)
    Y = np.where(rng.random(50) < 0.4, 1, -1).astype(np.int32)
    donor = rng.random(40) * 3.0
    for C in (0.5, 2.0, 10.0):
        a = feasible_seed(pad_alpha0(donor, 50), Y, C)
        assert a.tobytes() == j_feasible_seed(j_pad_alpha0(donor, 50), Y,
                                              C).tobytes()
    assert not feasible_seed(np.ones(4), np.ones(4, np.int32), 1.0).any()
    t = pad_alpha0(torch.as_tensor(donor), 45)
    assert torch.is_tensor(t) and t.shape == (45,)
    assert t.numpy().tobytes() == j_pad_alpha0(donor, 45).tobytes()
    assert pad_alpha0(donor, 30).tobytes() == donor[:30].tobytes()
    store, j_store = WarmStore(), JWarmStore()
    for s in (store, j_store):
        s.record(0, (1.0, 1.0), donor[:30])
        s.record(0, (4.0, 4.0), donor)
    for point, n in (((1.0, 1.0), 50), ((2.0, 1.0), 50), ((8.0, 8.0), 40)):
        a = store.seed(0, point, n, Y[:n], point[0])
        b = j_store.seed(0, point, n, Y[:n], point[0])
        assert a.tobytes() == b.tobytes()
    assert store.seed(1, (1.0, 1.0), 50, Y, 1.0) is None


def _table(res):
    return [{k: v for k, v in p.items() if k not in NOT_COMPARED}
            for p in res.points]


@pytest.mark.parametrize("schedule,fleet_on", [("grid", False),
                                               ("grid", True),
                                               ("halving", False),
                                               ("halving", True)])
def test_tune_equals_jax(rings_data, schedule, fleet_on):
    X, Y = rings_data
    kw = dict(folds=2, seed=1, schedule=schedule, fleet=fleet_on)
    g = [1.0, 4.0]
    if schedule == "halving":
        kw.update(min_rung=32, eta=3)
        g = [0.5, 2.0, 8.0]
    mine = tune(X, Y, make_grid(g, g), TuneConfig(**kw), device="cpu")
    theirs = j_tune(X, Y, j_make_grid(g, g), JTuneConfig(**kw))
    assert _table(mine) == _table(theirs)
    assert mine.winner == theirs.winner
    statuses = [p["status"] for p in mine.points]
    if schedule == "halving":
        assert TuneStatus.PRUNED.name in statuses
    assert TuneStatus.EVALUATED.name in statuses
    assert mine.fleet == fleet_on
    assert mine.total_updates == sum(p["n_updates"] for p in mine.points)


def test_fleet_rung_lanes_equal_their_one_lane_fits(rings_data, monkeypatch):
    X, Y = rings_data
    calls = []
    real = fleet.fleet_train

    def record(Xr, Ys, Cs, gammas, **kw):
        outs = real(Xr, Ys, Cs, gammas, **kw)
        calls.append((Xr, Ys, Cs, gammas, kw, outs))
        return outs

    monkeypatch.setattr(fleet, "fleet_train", record)
    g = [0.5, 2.0, 8.0]
    tune(X, Y, make_grid(g, g), TuneConfig(folds=2, seed=1,
                                            schedule="halving", min_rung=32,
                                            eta=3, fleet=True),
         device="cpu")
    monkeypatch.undo()
    assert len(calls) == 2 * 3  # a fleet a fold and rung
    # the last rung's seeded lanes and a first-rung cold one
    for Xr, Ys, Cs, gammas, kw, outs in (calls[-1], calls[0]):
        for j in range(len(Cs)):
            one = dict(kw)
            if kw.get("alpha0s") is not None:
                one["alpha0s"] = [kw["alpha0s"][j]]
            solo = real(Xr, [Ys[j]], [Cs[j]], [gammas[j]], **one)[0]
            assert torch.equal(solo.alpha, outs[j].alpha), j
            assert (float(solo.b), int(solo.n_iter), int(solo.status)) == (
                float(outs[j].b), int(outs[j].n_iter), int(outs[j].status))
    assert calls[-1][4]["alpha0s"] is not None


def test_a_warm_seeded_fleet_lane_keeps_alpha_in_the_box():
    # a halving rung's seed (a solution on half the rows, padded and made
    # feasible for the new box) is not made of float32 values; kernel #2
    # takes alpha in float32, and its deltas once landed members it moved
    # to a bound up to half an f32 ulp of C outside [0, C] (a full-width
    # tune rung then ended INFEASIBLE_UV on the card)
    from tpusvm_torch.data import MinMaxScaler
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.status import Status

    X, Y = mnist_like(n=1200, d=64, noise=30.0, label_noise=0.005, seed=587)
    Xs = torch.as_tensor(MinMaxScaler().fit_transform(X), dtype=torch.float32)
    kw = dict(device="cpu", q=256, max_inner=1024, wss=2,
              accum_dtype=torch.float64)
    half = fleet.fleet_train(Xs[:600], [Y[:600]], [10.0], [5.0 / 64], **kw)
    seed = feasible_seed(pad_alpha0(half[0].alpha.numpy(), 1200), Y, 2.5)
    res = fleet.fleet_train(Xs, [Y], [2.5], [5.0 / 64], alpha0s=[seed],
                            **kw)[0]
    assert Status(int(res.status)) == Status.CONVERGED
    assert float(res.alpha.min()) >= 0.0 and float(res.alpha.max()) <= 2.5


def test_results_cross_between_the_packages(tmp_path, rings_data):
    X, Y = rings_data
    res = tune(X, Y, make_grid([1.0, 4.0], [1.0, 4.0]),
               TuneConfig(folds=2, seed=1), device="cpu")
    mine, theirs = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    save_tune_result(mine, res)
    back = j_load(mine)
    assert j_format_table(back) == format_table(res)
    j_save(theirs, back)
    assert open(theirs).read() == open(mine).read()
    assert format_table(load_tune_result(theirs)) == format_table(res)
    assert is_tune_result(mine) and not is_tune_result(str(tmp_path / "x"))
    raw = json.load(open(mine))
    raw["format_version"] = 1
    json.dump(raw, open(mine, "w"))
    with pytest.raises(ValueError, match="unsupported tune-results format"):
        load_tune_result(mine)


def test_kernel_specs_and_config_refusals():
    base = SVMConfig()
    assert normalize_kernel_specs(None, base) == [
        {"kernel": "rbf", "degree": 3, "coef0": 0.0}]
    with pytest.raises(ValueError, match="approximate kernel families"):
        normalize_kernel_specs(["rff"], base)
    with pytest.raises(ValueError, match="duplicate"):
        normalize_kernel_specs(["rbf", {"kernel": "rbf"}], base)
    with pytest.raises(ValueError, match="patience"):
        TuneConfig(fleet=True, patience=2)
    with pytest.raises(ValueError, match="schedule"):
        TuneConfig(schedule="random")


def test_cli_tune_smoke_and_info(tmp_path, capsys):
    from tpusvm_torch.cli import main
    from tpusvm_torch.obs.trace import read_trace

    results = str(tmp_path / "tune.json")
    assert main(["tune", "--smoke", "--device", "cpu", "--results", results,
                 "--save", str(tmp_path / "w.npz")]) == 0
    out = capsys.readouterr().out
    assert "tune smoke ok" in out and "winner:" in out
    assert main(["info", results]) == 0
    info = capsys.readouterr().out
    assert info.strip() == format_table(load_tune_result(results))
    assert "EVALUATED" in info and "grid=2x2" in info
    with pytest.raises(SystemExit, match="both --C-grid and --gamma-grid"):
        main(["tune", "--synthetic", "rings", "--n", "64", "--C-grid", "1,2",
              "--device", "cpu"])
    # --trace is ported: a tune.point event a scored point, the winner
    trace = str(tmp_path / "t.jsonl")
    assert main(["tune", "--smoke", "--trace", trace, "--device", "cpu",
                 "-q"]) == 0
    recs = read_trace(trace)
    events = [r["name"] for r in recs if r["kind"] == "event"]
    assert events.count("tune.point") == 4 and "tune.winner" in events
    assert [r["name"] for r in recs if r["kind"] == "span"] == [
        "data", "search", "final-train"]
