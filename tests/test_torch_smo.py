"""The port's pair solver (tpusvm_torch/solver/smo.py) against the JAX
`smo_solve` and the f64 NumPy oracle, on the CPU, in every exact family.

Bands (the JAX package's own, for engines that do not share a program):
  - f64 features: the same SV-ID set and status as the JAX solver and the
    oracle; n_iter within max(5, 25%) of the JAX solver's, the band the
    JAX pair solver is held to against the oracle
    (tests/test_solver_parity.py:60; poly on blobs: oracle 85, JAX 73,
    port 62 at the time of writing); |b - b_jax| <= 1e-4
    and |b - b_oracle| < 2e-3 (tests/test_kernels.py:177). The two
    frameworks round the dot products and the norms differently in the
    last place, and SMO's pair choices amplify that: on rings(n=300, seed=2), RBF C=1
    gamma=5, the JAX run takes the oracle's 164 iterations, the port's 185, both
    converged to the same SV set with b 3.1e-6 apart.
  - f32 features with f64 accumulators: the cross-engine band of
    tests/test_kernels.py:177-182, SV sets within max(2, n_sv // 25) of
    the oracle's, |b - b_oracle| < 2e-2.
Inside the torch program the chunked loop equals the one-iteration loop
bit for bit (alpha, f, n_iter, status).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import MinMaxScaler
from tpusvm.data import synthetic as jsyn
from tpusvm.kernels.svr import doubled_problem
from tpusvm.oracle import get_sv_indices, smo_train
from tpusvm.solver.smo import smo_solve as j_smo
from tpusvm_torch.ops.cuda import pair_rows as pr
from tpusvm_torch.solver import smo as tsmo
from tpusvm_torch.solver.smo import smo_solve
from tpusvm_torch.status import Status

FAMILIES = {"rbf": {}, "linear": {}, "poly": dict(degree=3, coef0=1.0),
            "sigmoid": dict(coef0=0.0)}


def _dataset(name):
    if name == "blobs":
        X, Y = jsyn.blobs(n=240, d=3, seed=1)
        C, g = 1.0, 0.5
    elif name == "rings":
        X, Y = jsyn.rings(n=240, seed=2)
        C, g = 1.0, 5.0
    else:
        X, Y = jsyn.mnist_like(n=300, d=32, seed=3, noise=30.0)
        C, g = 10.0, 0.05
    return MinMaxScaler().fit_transform(X), Y, C, g


def _sv(alpha):
    return set(get_sv_indices(np.asarray(alpha)).tolist())


@pytest.mark.parametrize("name", ["blobs", "rings", "mnist_like"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_pair_solver_matches_jax_and_oracle(name, family):
    X, Y, C, g = _dataset(name)
    gamma = g if family == "rbf" else 0.5
    kw = dict(C=C, gamma=gamma, kernel=family, **FAMILIES[family])
    o = smo_train(X, Y, JConfig(**kw))
    sv_o = _sv(o.alpha)
    # f64 features
    rj = j_smo(jnp.asarray(X), jnp.asarray(Y), accum_dtype=jnp.float64, **kw)
    rt = smo_solve(torch.tensor(X), torch.tensor(Y), accum_dtype=torch.float64,
                   device="cpu", **kw)
    assert rt.status == Status(int(rj.status)) == Status.CONVERGED
    assert o.status.name == "CONVERGED"
    assert _sv(rt.alpha) == _sv(rj.alpha) == sv_o
    assert abs(rt.n_iter - int(rj.n_iter)) <= max(5, int(rj.n_iter) // 4)
    assert abs(rt.b - float(rj.b)) <= 1e-4
    assert abs(rt.b - o.b) < 2e-3
    assert rt.alpha.dtype == torch.float64
    # f32 features, f64 accumulators
    X32 = X.astype(np.float32)
    r32 = smo_solve(torch.tensor(X32), torch.tensor(Y),
                    accum_dtype=torch.float64, device="cpu", **kw)
    assert r32.status == Status.CONVERGED
    assert len(_sv(r32.alpha) ^ sv_o) <= max(2, len(sv_o) // 25)
    assert abs(r32.b - o.b) < 2e-2


@pytest.mark.parametrize("solver_targets", [False, True])
def test_pair_solver_with_targets_matches_jax(solver_targets):
    """The epsilon-SVR doubled problem: f = K(alpha*y) - z."""
    X, t = jsyn.svr_sine(n=120, d=1, noise=0.05, seed=5)
    Xs = MinMaxScaler().fit_transform(X)
    Y2, z = doubled_problem(t, 0.1)
    X2 = np.concatenate([Xs, Xs])
    kw = dict(C=10.0, gamma=20.0)
    tg = z if solver_targets else None
    rj = j_smo(jnp.asarray(X2), jnp.asarray(Y2), accum_dtype=jnp.float64,
               targets=None if tg is None else jnp.asarray(tg), **kw)
    rt = smo_solve(torch.tensor(X2), torch.tensor(Y2), accum_dtype=torch.float64,
                   targets=None if tg is None else torch.tensor(tg),
                   device="cpu", **kw)
    o = smo_train(X2, Y2, JConfig(**kw), targets=tg)
    assert rt.status == Status(int(rj.status)) == Status(int(o.status))
    assert _sv(rt.alpha) == _sv(rj.alpha) == _sv(o.alpha)
    assert abs(rt.b - float(rj.b)) <= 1e-4


def test_pair_solver_warm_start_and_padding_match_jax():
    X, Y, C, g = _dataset("rings")
    n = len(Y)
    # padded rows: label 0, masked out, must end at alpha exactly 0
    Xp = np.concatenate([X, np.zeros((16, 2))])
    Yp = np.concatenate([Y, np.zeros(16, np.int32)])
    valid = np.arange(n + 16) < n
    kw = dict(C=C, gamma=g)
    cold = smo_solve(torch.tensor(Xp), torch.tensor(Yp), torch.tensor(valid),
                     accum_dtype=torch.float64, device="cpu", **kw)
    assert cold.status == Status.CONVERGED
    assert torch.equal(cold.alpha[n:], torch.zeros(16, dtype=torch.float64))
    # warm start from a partial solve's alphas (f rebuilt with rbf_matvec)
    part = smo_solve(torch.tensor(Xp), torch.tensor(Yp), torch.tensor(valid),
                     accum_dtype=torch.float64, max_iter=60, device="cpu", **kw)
    assert part.status == Status.MAX_ITER
    a0 = part.alpha.numpy()
    rj = j_smo(jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(valid),
               jnp.asarray(a0), warm_start=True, accum_dtype=jnp.float64, **kw)
    rt = smo_solve(torch.tensor(Xp), torch.tensor(Yp), torch.tensor(valid),
                   torch.tensor(a0), warm_start=True, accum_dtype=torch.float64,
                   device="cpu", **kw)
    assert rt.status == Status(int(rj.status)) == Status.CONVERGED
    assert _sv(rt.alpha) == _sv(rj.alpha) == _sv(cold.alpha)
    assert abs(rt.b - float(rj.b)) <= 1e-4
    assert torch.equal(rt.alpha[n:], torch.zeros(16, dtype=torch.float64))
    assert rt.n_iter < cold.n_iter


def _state(name="rings", family="rbf", max_iter=10**6):
    X, Y, C, g = _dataset(name)
    X, Ys, valid, alpha, f0, sn = tsmo._prepare(
        torch.tensor(X, dtype=torch.float32), torch.tensor(Y)[None], None, None,
        warm_start=False, accum_dtype=torch.float64, kernel=family, degree=3,
        coef0=1.0, gamma=g, targets=None, device="cpu")
    return tsmo._PairState(X, Ys, valid, alpha, f0, C=C, gamma=g, eps=1e-12,
                           tau=1e-5, max_iter=max_iter, kernel=family, degree=3,
                           coef0=1.0, sn=sn)


@pytest.mark.parametrize("max_iter", [10**6, 37])
def test_chunked_loop_equals_the_one_iteration_loop(max_iter):
    """T = 1 reads the status after every iteration (the unchunked loop);
    T = 7 and 64 run past the end in the last chunk, predicated off."""
    runs = {}
    for T in (1, 7, 64):
        st = _state(max_iter=max_iter)
        syncs, _, chunks, graphed = tsmo._run(st, T, graph=False)
        assert syncs == chunks and not graphed
        runs[T] = st
    ref = runs[1]
    assert int(ref.status[0]) == (Status.CONVERGED if max_iter > 100
                                  else Status.MAX_ITER)
    for T in (7, 64):
        st = runs[T]
        for name in ("alpha", "f", "n_iter", "status", "b_high", "b_low",
                     "refreshes", "rows", "prev"):
            a, b = getattr(st, name), getattr(ref, name)
            assert torch.equal(a, b) or (name.startswith("b_")
                                         and torch.isnan(a).all()), name
    assert smo_solve(*_xy(), chunk=5, device="cpu").alpha.equal(
        smo_solve(*_xy(), chunk=300, device="cpu").alpha)


def _xy():
    X, Y, _, _ = _dataset("blobs")
    return torch.tensor(X), torch.tensor(Y)


def test_row_refreshes_count_the_iterations_with_an_index_change(monkeypatch):
    calls = []
    real = pr.pair_rows_kernel

    def spy(X, idx, need, rows, **kw):
        calls.append((idx.clone(), need.clone()))
        return real(X, idx, need, rows, **kw)

    monkeypatch.setattr(tsmo, "pair_rows_kernel", spy)
    X, Y, C, g = _dataset("mnist_like")
    r = smo_solve(torch.tensor(X, dtype=torch.float32), torch.tensor(Y), C=C,
                  gamma=g, accum_dtype=torch.float64, chunk=16, device="cpu")
    assert r.status == Status.CONVERGED
    refreshed = sum(bool(need.any()) for _, need in calls)
    assert r.row_refreshes == refreshed
    # one launch an iteration, the last chunk's tail included
    assert len(calls) == 16 * r.chunks
    # an index is refreshed only when it differs from the last update's
    # pair, so the count is under the iterations that proceeded
    assert 0 < r.row_refreshes <= r.n_iter
    # a repeated index keeps its cached row: some iteration needs one row
    assert any(bool(need.any()) and not bool(need.all()) for _, need in calls)


def test_plain_pair_rows_skip_leaves_rows_untouched():
    X = torch.rand(50, 7)
    rows = torch.randn(4, 50)
    before = rows.clone()
    pr.pair_rows_kernel(X, torch.tensor([1, 2, 3, 4]), torch.zeros(4, dtype=torch.bool),
                        rows, family="rbf", gamma=0.5, sn=(X * X).sum(1))
    assert torch.equal(rows, before)
    need = torch.tensor([False, True, False, True])
    pr.pair_rows_kernel(X, torch.tensor([1, 2, 3, 4]), need, rows, family="poly",
                        gamma=0.5, coef0=1.0, degree=2)
    assert torch.equal(rows[~need], before[~need])
    fresh = pr.family_rows("poly", X, torch.tensor([2, 4]), gamma=0.5, coef0=1.0,
                           degree=2)
    assert torch.equal(rows[need], fresh)


def test_pair_solver_refusals():
    X, Y = _xy()
    with pytest.raises(ValueError, match="CUDA graph"):
        smo_solve(X, Y, graph=True, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        smo_solve(X, Y, chunk=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        smo_solve(X, Y, kernel="nystrom", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel family"):
        smo_solve(X, Y, kernel="laplace", device="cpu")
