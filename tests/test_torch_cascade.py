"""The port's cascade (one-process engine) against the f64 oracle and the
JAX package's cascade, on the cases of tests/test_cascade.py.

Band: across packages, the oracle's SV-ID set exactly, b within 1e-4 of
the oracle's and alpha within 1e-3 on the SV set; against the JAX
cascade_fit on the same data (its simulated 8-device CPU mesh, f64): both
converged, the same final SV-ID set, rounds within +-1, b within 1e-4, the
same history keys and diag shapes; the same at float32 features on a
row cut of chip_smoke.py phase 14's job. Pair trajectories are not bit-equal
across frameworks (ROADMAP Queue 3), so per-round SV counts are printed
(run with -s), not gated. Inside the port the tight star capacity equals
the wide one bit for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import CascadeConfig as JCascadeConfig
from tpusvm.config import SVMConfig as JSVMConfig
from tpusvm.parallel import cascade_fit as j_cascade_fit
from tpusvm_torch.config import CascadeConfig, SVMConfig
from tpusvm_torch.data import MinMaxScaler, blobs, mnist_like, rings
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.oracle import get_sv_indices, smo_train
from tpusvm_torch.parallel import cascade_fit

CFG = SVMConfig(C=10.0, gamma=10.0)


def _ring_data(n=512, seed=5):
    X, Y = rings(n=n, seed=seed)
    return MinMaxScaler().fit_transform(X), Y


@pytest.fixture(scope="module")
def oracle_rings():
    Xs, Y = _ring_data()
    o = smo_train(Xs, Y, CFG)
    return Xs, Y, o


def _fit(Xs, Y, cfg, cc, **kw):
    return cascade_fit(Xs, Y, cfg, cc, dtype=torch.float64, device="cpu",
                       **kw)


def _jax_fit(Xs, Y, cfg, cc, **kw):
    return j_cascade_fit(
        Xs, Y, JSVMConfig(C=cfg.C, gamma=cfg.gamma),
        JCascadeConfig(n_shards=cc.n_shards, sv_capacity=cc.sv_capacity,
                       topology=cc.topology), dtype=jnp.float64, **kw)


def _holds_oracle(res, o, alpha=True):
    assert res.converged
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(res.b, o.b, atol=1e-4)
    if alpha:
        order = np.argsort(res.sv_ids)
        np.testing.assert_allclose(res.sv_alpha[order],
                                   o.alpha[np.sort(res.sv_ids)], atol=1e-3)


def _agrees_with_jax(res, jres, label):
    print(f"{label}: port rounds {res.rounds} SVs/round "
          f"{[h['sv_count'] for h in res.history]}; JAX rounds "
          f"{jres.rounds} SVs/round {[h['sv_count'] for h in jres.history]}")
    assert res.converged and jres.converged
    assert set(res.sv_ids.tolist()) == set(jres.sv_ids.tolist())
    assert abs(res.rounds - jres.rounds) <= 1
    np.testing.assert_allclose(res.b, jres.b, atol=1e-4)
    for h, jh in zip(res.history, jres.history):
        assert set(h) == set(jh)
        assert h["iters"].shape == np.asarray(jh["iters"]).shape
        assert h["status"].shape == np.asarray(jh["status"]).shape


@pytest.mark.parametrize("topology", ["tree", "star"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_cascade_recovers_oracle_sv_set(oracle_rings, topology, n_shards):
    Xs, Y, o = oracle_rings
    cc = CascadeConfig(n_shards=n_shards, sv_capacity=256, topology=topology)
    res = _fit(Xs, Y, CFG, cc)
    _holds_oracle(res, o)
    _agrees_with_jax(res, _jax_fit(Xs, Y, CFG, cc), f"{topology} P={n_shards}")


@pytest.mark.parametrize("topology,n_shards", [("tree", 4), ("star", 3)])
def test_cascade_blocked_solver_recovers_oracle(oracle_rings, topology,
                                                n_shards):
    # blocked leaves: another trajectory, the same SV-set fixed point
    Xs, Y, o = oracle_rings
    cc = CascadeConfig(n_shards=n_shards, sv_capacity=256, topology=topology)
    res = _fit(Xs, Y, CFG, cc, solver="blocked", solver_opts={"q": 64})
    _holds_oracle(res, o, alpha=False)
    _agrees_with_jax(res, _jax_fit(Xs, Y, CFG, cc, solver="blocked",
                                   solver_opts={"q": 64}),
                     f"blocked {topology} P={n_shards}")


def test_f32_blocked_tree_agrees_with_jax():
    # the precision of chip_smoke.py phase 14 (float32 features, f64
    # accumulators, alpha carried between rounds in float32, the blocked
    # warm start rebuilding f in float32) on a row cut of its job: both
    # packages' tree at P=4, rounds and per-round SV counts printed
    X, Y = mnist_like(n=2000, d=784, noise=30.0, label_noise=0.005,
                      seed=587)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    cfg = SVMConfig(C=10.0, gamma=0.00125)
    cc = CascadeConfig(n_shards=4, sv_capacity=1024, topology="tree")
    opts = {"q": 256, "wss": 2, "max_inner": 4096}
    res = cascade_fit(Xs, Y, cfg, cc, dtype=torch.float32, device="cpu",
                      solver="blocked", solver_opts=opts)
    jres = j_cascade_fit(
        Xs, Y, JSVMConfig(C=cfg.C, gamma=cfg.gamma),
        JCascadeConfig(n_shards=4, sv_capacity=1024, topology="tree"),
        dtype=jnp.float32, solver="blocked", solver_opts=opts)
    _agrees_with_jax(res, jres, "f32 blocked tree P=4, n=2000 d=784")


@pytest.mark.parametrize("topology,n_shards", [("tree", 4), ("star", 3)])
def test_estimator_fit_cascade_recovers_oracle(oracle_rings, topology,
                                               n_shards):
    # BinarySVC.fit_cascade scales on the full array and runs its own
    # solver (blocked by default) on every leaf
    Xs, Y, o = oracle_rings
    X, _ = rings(n=512, seed=5)
    cc = CascadeConfig(n_shards=n_shards, sv_capacity=256, topology=topology)
    m = BinarySVC(CFG, solver_opts={"q": 64}, device="cpu").fit_cascade(
        X, Y, cc)
    assert m.status_.name == "CONVERGED"
    assert set(m.sv_ids_.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(m.b_, o.b, atol=1e-4)
    assert m.cascade_topology_ == topology
    assert m.cascade_leaves_ == n_shards
    assert m.cascade_rounds_ == len(m.cascade_history_)
    assert m.n_iter_ == sum(int(h["iters"].sum()) for h in m.cascade_history_)
    assert m.score(X, Y) == BinarySVC(CFG, device="cpu").fit(X, Y).score(X, Y)


def test_cascade_unknown_solver_rejected():
    Xs, Y = _ring_data(n=64)
    with pytest.raises(ValueError, match="solver"):
        _fit(Xs, Y, CFG, CascadeConfig(n_shards=2, topology="star"),
             solver="newton")


def test_refusals(tmp_path):
    from tpusvm_torch.obs.trace import Tracer, read_trace

    Xs, Y = _ring_data(n=64)
    cc = CascadeConfig(n_shards=2, topology="star")
    with pytest.raises(ValueError, match="shrinking driver"):
        _fit(Xs, Y, CFG, cc, solver="blocked",
             solver_opts={"shrink_every": 2, "shrink_min": 8})
    # the tracer is ported: a traced fit writes one cascade.round span and
    # event a round and keeps the untraced fit's bits (small buffers and
    # working sets keep the two fits cheap)
    small = CascadeConfig(n_shards=2, topology="star", sv_capacity=64)
    kw = dict(solver="blocked", solver_opts={"q": 16})
    path = str(tmp_path / "t.jsonl")
    with Tracer(path) as tracer:
        traced = _fit(Xs, Y, CFG, small, tracer=tracer, **kw)
    plain = _fit(Xs, Y, CFG, small, **kw)
    assert traced.sv_alpha.tobytes() == plain.sv_alpha.tobytes()
    assert traced.b == plain.b and traced.rounds == plain.rounds
    recs = read_trace(path)
    for kind in ("span", "event"):
        assert [r["attrs"]["round"] for r in recs if r["kind"] == kind
                and r["name"] == "cascade.round"] == list(
                    range(1, plain.rounds + 1))
    # the streaming twin is ported (stream/); it refuses the approximate
    # families, as the JAX package does
    with pytest.raises(ValueError, match="approximate"):
        BinarySVC(SVMConfig(kernel="rff"), device="cpu").fit_cascade_stream(
            None)
    # so is the pod (pod/), which refuses them alike
    with pytest.raises(ValueError, match="approximate"):
        BinarySVC(SVMConfig(kernel="rff"), device="cpu").fit_pod("data")
    with pytest.raises(ValueError, match="prebuilt partition has 2 leaves"):
        from tpusvm_torch.data.partition import partition
        _fit(None, None, CFG, CascadeConfig(n_shards=4, topology="star"),
             partition=partition(Xs, Y, 2))


def test_star_non_power_of_two_shards(oracle_rings):
    # the tree needs P = 2^k (mpi_svm_main3.cpp:420-428); the star runs at
    # any P
    Xs, Y, o = oracle_rings
    res = _fit(Xs, Y, CFG, CascadeConfig(n_shards=3, sv_capacity=256,
                                         topology="star"))
    _holds_oracle(res, o, alpha=False)


def test_tree_requires_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        CascadeConfig(n_shards=3, topology="tree")


def test_unknown_topology_rejected():
    with pytest.raises(ValueError, match="topology"):
        CascadeConfig(topology="ring")


def test_empty_shards_are_harmless():
    # n chosen so the trailing shards are all padding (cap = ceil(n/P))
    X, Y = blobs(n=130, seed=6)
    Xs = MinMaxScaler().fit_transform(X)
    cfg = SVMConfig(C=1.0, gamma=0.125)
    o = smo_train(Xs, Y, cfg)
    res = _fit(Xs, Y, cfg, CascadeConfig(n_shards=8, sv_capacity=128,
                                         topology="star"))
    assert res.converged
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())


def test_sv_capacity_overflow_raises():
    Xs, Y = _ring_data()
    with pytest.raises(RuntimeError, match="overflow"):
        _fit(Xs, Y, CFG, CascadeConfig(n_shards=2, sv_capacity=4,
                                       topology="star"))


def test_star_merge_capacity_overflow_retries_full_width():
    # a layer-2 buffer too small for the worker-SV union re-runs the round
    # at the concatenation bound (with a warning); the fit then equals one
    # at that width from the start, bit for bit
    Xs, Y = _ring_data()
    cc = dict(n_shards=2, sv_capacity=256, topology="star")
    with pytest.warns(RuntimeWarning, match="overflowed the star merge"):
        r_tight = _fit(Xs, Y, CFG, CascadeConfig(**cc, star_merge_capacity=2))
    r_wide = _fit(Xs, Y, CFG, CascadeConfig(**cc, star_merge_capacity=512))
    np.testing.assert_array_equal(r_tight.sv_ids, r_wide.sv_ids)
    np.testing.assert_array_equal(r_tight.sv_alpha, r_wide.sv_alpha)
    assert r_tight.b == r_wide.b and r_tight.rounds == r_wide.rounds


def test_star_merge_capacity_rejected_for_tree():
    with pytest.raises(ValueError, match="star_merge_capacity"):
        CascadeConfig(n_shards=2, topology="tree", star_merge_capacity=64)


def test_star_merge_capacity_default_is_overflow_proof_bound():
    cc = CascadeConfig(n_shards=4, sv_capacity=256, topology="star")
    assert cc.resolved_star_merge_capacity() == 4 * 256
    cc2 = CascadeConfig(n_shards=8, sv_capacity=32, topology="star")
    assert cc2.resolved_star_merge_capacity() == 8 * 32


def test_star_merge_capacity_tight_matches_wide_buffer():
    # a tight layer-2 capacity that holds the union: no warning, and the
    # same outcome as the overflow-proof default within the stopping band
    Xs, Y = _ring_data()
    cc = dict(n_shards=4, sv_capacity=256, topology="star")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        r_tight = _fit(Xs, Y, CFG, CascadeConfig(**cc, star_merge_capacity=512))
    r_wide = _fit(Xs, Y, CFG, CascadeConfig(**cc))
    assert set(r_tight.sv_ids.tolist()) == set(r_wide.sv_ids.tolist())
    np.testing.assert_allclose(r_tight.b, r_wide.b, atol=1e-4)


@pytest.mark.parametrize("topology", ["tree", "star"])
def test_single_shard_cascade_degenerates_cleanly(oracle_rings, topology):
    # P=1: the plain solve's SV set in the minimum 2 rounds (solve, then
    # the ID-set-stable confirmation)
    Xs, Y, o = oracle_rings
    r = _fit(Xs, Y, CFG, CascadeConfig(n_shards=1, sv_capacity=256,
                                       topology=topology))
    assert r.converged and r.rounds == 2
    assert set(r.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(r.b, o.b, atol=1e-4)


def test_history_diagnostics():
    Xs, Y = _ring_data()
    res = _fit(Xs, Y, CFG, CascadeConfig(n_shards=2, sv_capacity=256,
                                         topology="tree"))
    assert res.rounds == len(res.history)
    h0 = res.history[0]
    assert h0["round"] == 1 and h0["sv_count"] > 0 and h0["time_s"] > 0
    # per rank, per step: (P, log2 P + 1)
    assert h0["iters"].shape == (2, 2) and h0["status"].shape == (2, 2)
    # rank 1 idles at step 2: 0 iterations, status -1
    assert h0["iters"][1, 1] == 0 and h0["status"][1, 1] == -1
    for h in res.history:
        assert len(h["sv_ids"]) == h["sv_count"]
        assert (np.diff(h["sv_ids"]) > 0).all()
    np.testing.assert_array_equal(res.history[-1]["sv_ids"],
                                  np.sort(res.sv_ids))
    star = _fit(Xs, Y, CFG, CascadeConfig(n_shards=3, sv_capacity=256,
                                          topology="star"))
    assert star.history[0]["iters"].shape == (3, 2)
    # the layer-2 solve's numbers run down column 1
    assert len(set(star.history[0]["iters"][:, 1].tolist())) == 1


def test_label_sorted_data_raises_not_nan():
    # every shard single-class: no working set anywhere; fail loudly
    X, Y = blobs(n=128, seed=9)
    order = np.argsort(Y)
    with pytest.raises(RuntimeError, match="empty global support-vector set"):
        _fit(X[order], Y[order], SVMConfig(C=1.0, gamma=0.125),
             CascadeConfig(n_shards=2, sv_capacity=64, topology="star"))


def test_stratified_label_sorted_data_recovers_oracle():
    # the per-class round-robin deal hands every leaf both classes
    X, Y = blobs(n=128, seed=9)
    order = np.argsort(Y)
    Xs = MinMaxScaler().fit_transform(X[order])
    cfg = SVMConfig(C=1.0, gamma=0.125)
    o = smo_train(Xs, Y[order], cfg)
    res = _fit(Xs, Y[order], cfg, CascadeConfig(n_shards=2, sv_capacity=128,
                                                topology="star"),
               stratified=True)
    assert res.converged
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())


@pytest.mark.parametrize("topology", ["tree", "star"])
def test_leaf_with_fewer_valid_rows_than_q(topology):
    # blocked leaves whose q (64) exceeds the leaf's valid rows (24 of
    # 96 rows / 4 leaves, padded to 24 + 64): q clamps to the padded
    # size and selects over masked rows, as in the JAX solver
    X, Y = rings(n=96, seed=3)
    Xs = MinMaxScaler().fit_transform(X)
    cfg = SVMConfig(C=10.0, gamma=5.0)
    o = smo_train(Xs, Y, cfg)
    res = _fit(Xs, Y, cfg, CascadeConfig(n_shards=4, sv_capacity=64,
                                         topology=topology),
               solver="blocked", solver_opts={"q": 64})
    assert res.converged
    assert set(res.sv_ids.tolist()) == set(get_sv_indices(o.alpha).tolist())
    np.testing.assert_allclose(res.b, o.b, atol=1e-4)


@pytest.mark.parametrize("seed", [31, 32])
def test_cascade_randomized_geometry_recovers_oracle(seed):
    cfg = SVMConfig(C=10.0, gamma=2.0)
    X, Y = blobs(n=256, d=6, seed=seed)
    Xs = MinMaxScaler().fit_transform(X)
    o = smo_train(Xs, Y, cfg)
    sv_o = set(get_sv_indices(o.alpha).tolist())
    for topology, n_shards in (("tree", 4), ("star", 5)):
        res = _fit(Xs, Y, cfg, CascadeConfig(n_shards=n_shards,
                                             sv_capacity=192,
                                             topology=topology))
        assert res.converged, (topology, seed)
        assert set(res.sv_ids.tolist()) == sv_o, (topology, seed)
        np.testing.assert_allclose(res.b, o.b, atol=1e-4)


def test_cascade_entry_points_raise_without_a_card():
    # leaves asked for the card never run on the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is not reachable")
    from tpusvm_torch.cli import main

    X, Y = rings(n=64, seed=1)
    cc = CascadeConfig(n_shards=2, sv_capacity=64, topology="tree")
    for call in (lambda: cascade_fit(X, Y, CFG, cc),
                 lambda: BinarySVC(CFG).fit_cascade(X, Y, cc),
                 lambda: main(["train", "--synthetic", "rings", "--n", "64",
                               "--mode", "cascade", "--shards", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
