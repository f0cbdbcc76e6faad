"""Active-set shrinking and the K-row cache in the port, on the CPU,
against the JAX package and against the port's own unshrunk solve,
mirroring tests/test_shrink.py's shrinking and cache cases.

Held to the repo's cross-engine criterion: the same status and SV-ID set,
b within 1e-3 of the unshrunk solve (tests/test_shrink.py's band; the
compacted problem's f-updates sum in another order) and within 1e-4 of
the JAX package's same configuration, and the final solution meeting the
unshrunk stopping criterion on an independent f64 rebuild of f (the band
2 tau plus the f32 evaluation floor, as in tests/test_shrink.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler, rings, svr_sine
from tpusvm.solver.blocked import blocked_smo_solve as j_blocked
from tpusvm.solver.shrink import shrinking_blocked_solve as j_shrink
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.shrink import _bucket, _rebuild_f, shrinking_blocked_solve
from tpusvm_torch.status import Status

KW = dict(C=10.0, gamma=10.0, tau=1e-5, q=64, max_inner=256,
          max_outer=20000, max_iter=10_000_000)
PORT = dict(accum_dtype=torch.float64, device="cpu")


def _data(gen, **kw):
    X, Y = gen(**kw)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y


def _keerthi_gap(Xs, Y, alpha, gamma, C, eps=1e-12):
    """The full problem's b_low - b_high from an f64 numpy rebuild of f,
    with no solver machinery."""
    Xs = np.asarray(Xs, np.float64)
    a = np.asarray(alpha, np.float64)
    y = np.asarray(Y, np.float64)
    d2 = ((Xs ** 2).sum(1)[:, None] + (Xs ** 2).sum(1)[None, :]
          - 2.0 * Xs @ Xs.T)
    f = np.exp(-gamma * np.maximum(d2, 0.0)) @ (a * y) - y
    m_h = np.where(y == 1, a < C - eps, (y == -1) & (a > eps))
    m_l = np.where(y == 1, a > eps, (y == -1) & (a < C - eps))
    return float(f[m_l].max() - f[m_h].min())


def _gap_band(alpha, tau=1e-5):
    return 2.0 * tau + 4e-7 * float(np.sum(np.asarray(alpha)))


def _svs(alpha, tol=1e-8):
    return set(np.flatnonzero(np.asarray(alpha) > tol).tolist())


def test_shrink_matches_unshrunk_jax_and_the_global_criterion():
    Xs, Y = _data(rings, n=768, seed=5)
    r0 = blocked_smo_solve(Xs, Y, **KW, **PORT)
    r1, hist = shrinking_blocked_solve(Xs, Y, shrink_every=4,
                                       shrink_stable=2, shrink_min=64,
                                       return_history=True, **KW, **PORT)
    rj = j_shrink(jnp.asarray(Xs), jnp.asarray(Y), shrink_every=4,
                  shrink_stable=2, shrink_min=64, accum_dtype=jnp.float64,
                  **KW)
    assert r0.status == r1.status == int(rj.status) == Status.CONVERGED
    assert any(h["event"] == "shrink" for h in hist)
    assert _svs(r0.alpha) == _svs(r1.alpha) == _svs(rj.alpha)
    assert abs(r1.b - r0.b) <= 1e-3
    assert abs(r1.b - float(rj.b)) <= 1e-4
    for r in (r0, r1):
        a = r.alpha.numpy()
        assert _keerthi_gap(Xs, Y, a, 10.0, 10.0) <= _gap_band(a)
    # every compaction bucket is a power of two at least shrink_min
    caps = [h["cap"] for h in hist if h["event"] == "shrink"]
    assert all(c >= 64 and c & (c - 1) == 0 for c in caps)
    assert caps == sorted(caps, reverse=True)


def test_shrink_adversarial_wrong_freeze_is_revived():
    """S=1, a pause every round, no gap guard: rows freeze off one round's
    look at a loose band; each compacted claim must be rejected at
    un-shrink until the global criterion holds, landing on the
    never-shrunk solution."""
    from benchmarks.common import make_workload

    Xs, Y = make_workload(512, d=32)
    gamma = 0.00125 * 784 / 32
    kw = dict(KW, gamma=gamma)
    r0 = blocked_smo_solve(Xs, Y, **kw, **PORT)
    r1, hist = shrinking_blocked_solve(
        Xs, Y, shrink_every=1, shrink_stable=1, shrink_min=64,
        shrink_gap_factor=0.0, max_unshrinks=6, return_history=True,
        **kw, **PORT)
    assert r0.status == r1.status == Status.CONVERGED
    unshrunk = [h["round"] for h in hist if h["event"] == "unshrink"]
    assert len(unshrunk) >= 2
    assert r1.n_outer > unshrunk[0]
    assert _svs(r0.alpha) == _svs(r1.alpha)
    assert abs(r1.b - r0.b) <= 1e-3
    a = r1.alpha.numpy()
    assert _keerthi_gap(Xs, Y, a, gamma, 10.0) <= _gap_band(a)


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_shrink_fuzz_corpus_parity(seed):
    from benchmarks.common import random_instance

    rng = np.random.default_rng(seed)
    _, n, X, Y, C, gamma = random_instance(
        rng, seed, (128, 512), (2, 12), [1.0, 10.0], [0.5, 2.0, 8.0])
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    kw = dict(KW, C=C, gamma=gamma)
    r0 = blocked_smo_solve(Xs, Y, **kw, **PORT)
    r1 = shrinking_blocked_solve(Xs, Y, shrink_every=4, shrink_stable=2,
                                 shrink_min=64, **kw, **PORT)
    assert r0.status == r1.status == Status.CONVERGED
    assert _svs(r0.alpha) == _svs(r1.alpha)
    assert abs(r1.b - r0.b) <= 1e-3
    a = r1.alpha.numpy()
    assert _keerthi_gap(Xs, Y, a, gamma, C) <= _gap_band(a)


def test_shrink_validation():
    X = np.zeros((16, 2), np.float32)
    Y = np.asarray([1, -1] * 8, np.int32)
    with pytest.raises(ValueError, match="shrink_stable"):
        shrinking_blocked_solve(X, Y, shrink_stable=0, device="cpu")
    with pytest.raises(ValueError, match="shrink_every"):
        shrinking_blocked_solve(X, Y, shrink_every=0, device="cpu")
    for k in ("pause_at", "resume_state", "return_state"):
        with pytest.raises(ValueError, match="segmenting"):
            shrinking_blocked_solve(X, Y, device="cpu", **{k: 3})
    with pytest.raises(NotImplementedError, match=r"7\(d\)"):
        shrinking_blocked_solve(X, Y, matmul_precision="bf16_f32",
                                device="cpu")


@pytest.mark.parametrize("n_live,lo,hi,cap", [
    (1, 64, 1000, 64), (64, 64, 1000, 64), (65, 64, 1000, 128),
    (300, 256, 1000, 512), (900, 256, 1000, 1000), (0, 8, 100, 8)])
def test_bucket_is_the_jax_bucket(n_live, lo, hi, cap):
    from tpusvm.solver.shrink import _bucket as j_bucket

    assert _bucket(n_live, lo, hi) == j_bucket(n_live, lo, hi) == cap


def test_rebuild_f_over_a_padded_bucket():
    """The un-shrink rebuild equals f from every row: the bucket's padding
    coefficients are 0. Tolerance 1e-5 absolute (f32 sums in different
    orders)."""
    from tpusvm_torch.ops.rbf import rbf_cross_matvec, sq_norms

    Xs, Y = _data(rings, n=300, seed=3)
    X, Yt = torch.tensor(Xs), torch.tensor(Y)
    r = blocked_smo_solve(X, Yt, C=10.0, gamma=10.0, q=64, **PORT)
    a = r.alpha.numpy()
    assert 0 < np.count_nonzero(a) < 64  # padded to the 64-row floor
    z = Yt.to(torch.float32)
    valid = torch.ones(300, dtype=torch.bool)
    kern = dict(kernel="rbf", gamma=10.0, coef0=0.0, degree=3,
                kernel_fast=True)
    f = _rebuild_f(X, Yt, valid, a, z, kern, sq_norms(X))
    full = rbf_cross_matvec(X, X, torch.tensor(a * Y, dtype=torch.float32),
                            10.0) - z
    torch.testing.assert_close(f, full, rtol=0, atol=1e-5)
    assert f.dtype == torch.float32  # z in X's dtype, as in the JAX package's shrinking solve


def test_shrinking_svr_through_the_estimator():
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import EpsilonSVR

    X, t = svr_sine(n=400, d=1, seed=3)
    cfg = SVMConfig(C=10.0, gamma=20.0, epsilon=0.1)
    plain = EpsilonSVR(cfg, solver_opts=dict(q=64), device="cpu").fit(X, t)
    shrunk = EpsilonSVR(cfg, solver_opts=dict(q=64, shrink_every=4,
                                              shrink_min=64),
                        device="cpu").fit(X, t)
    assert plain.status_ == shrunk.status_ == Status.CONVERGED
    assert np.array_equal(plain.sv_ids_, shrunk.sv_ids_)
    assert abs(plain.b_ - shrunk.b_) <= 1e-3


def test_model_provenance_round_trips_both_packages(tmp_path):
    from tpusvm.models import BinarySVC as JSVC
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.models import BinarySVC

    X, Y = rings(n=300, seed=4)
    m = BinarySVC(SVMConfig(C=10.0, gamma=10.0),
                  solver_opts=dict(q=64, shrink_every=4, shrink_min=64),
                  device="cpu").fit(X, Y)
    assert (m.shrink_every_, m.shrink_stable_) == (4, 3)
    path = str(tmp_path / "m.npz")
    m.save(path)
    back = BinarySVC.load(path, device="cpu")
    j = JSVC.load(path)
    assert (back.shrink_every_, back.shrink_stable_) == (4, 3)
    assert (j.shrink_every_, j.shrink_stable_) == (4, 3)
    plain = BinarySVC(SVMConfig(C=10.0, gamma=10.0), solver_opts=dict(q=64),
                      device="cpu").fit(X, Y)
    assert (plain.shrink_every_, plain.shrink_stable_) == (0, 0)
    # shrink_stable alone tracks the counters and changes nothing
    tracked = BinarySVC(SVMConfig(C=10.0, gamma=10.0),
                        solver_opts=dict(q=64, shrink_stable=3),
                        device="cpu").fit(X, Y)
    assert torch.equal(tracked.result_.alpha, plain.result_.alpha)


@pytest.mark.parametrize("q", [16, 128])
def test_shrink_stable_is_bit_transparent(q):
    Xs, Y = _data(rings, n=400, seed=9)
    kw = dict(KW, q=q)
    r0, st0 = blocked_smo_solve(Xs, Y, return_state=True, **kw, **PORT)
    r3, st3 = blocked_smo_solve(Xs, Y, shrink_stable=3, return_state=True,
                                **kw, **PORT)
    assert torch.equal(r0.alpha, r3.alpha) and torch.equal(st0.f, st3.f)
    assert (r0.b, r0.n_iter, r0.status) == (r3.b, r3.n_iter, r3.status)
    assert st0.stable.numel() == 0 and st3.stable.shape == (400,)
    # the counters are JAX's on the same carry: consecutive at-bound and
    # safe rounds, so no row exceeds the round count
    assert int(st3.stable.max()) <= r3.n_outer + 1
    assert int((st3.stable > 0).sum()) > 0


# ------------------------------------------------------------ K-row cache
def test_krow_cache_same_solution_and_accounting():
    Xs, Y = _data(rings, n=512, seed=5)
    kw = dict(KW, q=32, max_inner=64)
    r0 = blocked_smo_solve(Xs, Y, **kw, **PORT)
    r1 = blocked_smo_solve(Xs, Y, krow_cache=512, **kw, **PORT)
    rj = j_blocked(jnp.asarray(Xs), jnp.asarray(Y), krow_cache=512,
                   accum_dtype=jnp.float64, **kw)
    assert r1.status == int(rj.status) == Status.CONVERGED
    assert _svs(r0.alpha) == _svs(r1.alpha) == _svs(rj.alpha)
    assert abs(r1.b - r0.b) <= 1e-4 and abs(r1.b - float(rj.b)) <= 1e-4
    assert r1.cache_hits + r1.cache_misses == 32 * r1.n_outer
    assert r1.cache_hits > 0
    assert r0.cache_hits is None and r0.cache_misses is None


def test_krow_cache_slot_aliasing_evicted_row_recomputed():
    """With exactly q slots every miss evicts the whole previous working
    set: a stale key would serve a wrong row. The solution must equal the
    roomy cache's bit for bit, and the uncached solve's in band."""
    Xs, Y = _data(rings, n=384, seed=7)
    kw = dict(KW, q=32, max_inner=64)
    r_no = blocked_smo_solve(Xs, Y, **kw, **PORT)
    r_tight = blocked_smo_solve(Xs, Y, krow_cache=32, **kw, **PORT)
    r_roomy = blocked_smo_solve(Xs, Y, krow_cache=384, **kw, **PORT)
    assert r_tight.status == Status.CONVERGED
    assert torch.equal(r_tight.alpha, r_roomy.alpha)
    assert r_tight.b == r_roomy.b
    assert _svs(r_no.alpha) == _svs(r_tight.alpha)
    assert abs(r_tight.b - r_no.b) <= 1e-4


def test_krow_cache_validation():
    X = np.zeros((64, 2), np.float32)
    Y = np.asarray([1, -1] * 32, np.int32)
    with pytest.raises(ValueError, match="krow_cache"):
        blocked_smo_solve(X, Y, q=32, krow_cache=16, device="cpu")
    with pytest.raises(ValueError, match="krow_cache"):
        blocked_smo_solve(X, Y, q=32, krow_cache=64, fused_fupdate=True,
                          device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        blocked_smo_solve(X, Y, q=32, krow_cache=-1, device="cpu")


def test_krow_cache_with_the_kernel_engine_and_shrinking():
    """The cache with the inner kernel (q a multiple of 128, fused
    f-update resolved off) and under shrinking_blocked_solve, whose
    compactions start the cache empty."""
    Xs, Y = _data(rings, n=768, seed=5)
    kw = dict(KW, q=128)
    r0 = blocked_smo_solve(Xs, Y, **kw, **PORT)
    r1 = blocked_smo_solve(Xs, Y, krow_cache=256, **kw, **PORT)
    r2, hist = shrinking_blocked_solve(
        Xs, Y, krow_cache=256, shrink_every=4, shrink_stable=2,
        shrink_min=128, return_history=True, **kw, **PORT)
    assert r0.status == r1.status == r2.status == Status.CONVERGED
    assert _svs(r0.alpha) == _svs(r1.alpha) == _svs(r2.alpha)
    assert abs(r1.b - r0.b) <= 1e-4 and abs(r2.b - r0.b) <= 1e-3
    assert r1.cache_hits > 0
    assert r2.cache_hits + r2.cache_misses == 128 * r2.n_outer
