"""The port's kernel families, selection helpers, SVR doubling, Platt fit
and stratified folds against the JAX package's, on the CPU.

Tolerances: kernel computations in f32 agree to rtol 1e-5 (both are IEEE
f32 contractions summed in different orders); a sum over q kernel values
times coefficients to 1e-5 * sum|coef| * max|K| absolute. The numpy-only
copies (SVR doubling, Platt, folds) and the integer power are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.kernels import dispatch as jdispatch
from tpusvm.kernels import platt as jplatt
from tpusvm.kernels import svr as jsvr
from tpusvm.ops import rbf as jrbf
from tpusvm.ops import selection as jsel
from tpusvm.tune import folds as jfolds
from tpusvm_torch import kernels as tkernels
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.kernels import platt as tplatt
from tpusvm_torch.kernels import svr as tsvr
from tpusvm_torch.kernels.poly import integer_pow
from tpusvm_torch.ops import rbf as trbf
from tpusvm_torch.ops import selection as tsel
from tpusvm_torch.ops.cuda.pair_rows import pair_rows_ref
from tpusvm_torch.solver.blocked import blocked_smo_solve, resolve_solver_config
from tpusvm_torch.tune import folds as tfolds

FAMILIES = {"rbf": dict(gamma=0.3), "linear": dict(gamma=0.0),
            "poly": dict(gamma=0.1, coef0=1.0, degree=3),
            "sigmoid": dict(gamma=0.05, coef0=-0.2)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    X = rng.random((301, 17)).astype(np.float32)
    idx = np.array([4, 250, 17, 4, 99])
    coef = rng.standard_normal(40).astype(np.float32)
    return X, idx, X[rng.choice(301, 40, replace=False)], coef


def _close(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_functions_match_jax(data, family):
    X, idx, XB, coef = data
    kw = FAMILIES[family]
    T, TB = torch.tensor(X), torch.tensor(XB)
    rows_t = tkernels.rows_at(family, T, torch.tensor(idx), **kw)
    rows_j = jdispatch.rows_at(family, jnp.asarray(X), jnp.asarray(idx), **kw)
    _close(rows_t, rows_j, atol=1e-6 * float(np.abs(rows_j).max()))
    cross_t = tkernels.cross(family, T, TB, **kw)
    cross_j = jdispatch.cross(family, jnp.asarray(X), jnp.asarray(XB), **kw)
    scale = float(np.abs(cross_j).max())
    _close(cross_t, cross_j, atol=1e-6 * scale)
    atol = 1e-5 * float(np.abs(coef).sum()) * scale
    for fast in (True, False):
        cm_t = tkernels.cross_matvec(family, T, TB, torch.tensor(coef),
                                     block=128, fast=fast, **kw)
        cm_j = jdispatch.cross_matvec(family, jnp.asarray(X), jnp.asarray(XB),
                                      jnp.asarray(coef), block=128, fast=fast,
                                      **kw)
        _close(cm_t, cm_j, atol=atol)
    c_all = np.random.default_rng(1).standard_normal(301).astype(np.float32)
    mv_t = tkernels.matvec(family, T, torch.tensor(c_all), block=64, **kw)
    mv_j = jdispatch.matvec(family, jnp.asarray(X), jnp.asarray(c_all), block=64,
                            **kw)
    _close(mv_t, mv_j, atol=1e-5 * float(np.abs(c_all).sum()) * scale)
    # the pair solver's plain K-row refresh computes the same rows
    rows = torch.zeros(len(idx), 301)
    pair_rows_ref(T, torch.tensor(idx), torch.ones(len(idx), dtype=torch.bool),
                  rows, family=family, sn=trbf.sq_norms(T), **kw)
    _close(rows, rows_j, atol=1e-6 * float(np.abs(rows_j).max()))


def test_linear_fast_and_generic_paths_agree(data):
    X, _, XB, coef = data
    T, TB, c = torch.tensor(X), torch.tensor(XB), torch.tensor(coef)
    fast = tkernels.cross_matvec("linear", T, TB, c, gamma=0.0, fast=True)
    slow = tkernels.cross_matvec("linear", T, TB, c, gamma=0.0, fast=False,
                                 block=64)
    _close(fast, slow, atol=1e-5 * float(np.abs(coef).sum()) * 17)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 7, 8])
def test_integer_pow_is_lax_integer_pow(degree):
    x = np.random.default_rng(degree).standard_normal(1000).astype(np.float32) * 3
    want = np.asarray(jax.lax.integer_pow(jnp.asarray(x), degree))
    got = integer_pow(torch.tensor(x), degree).numpy()
    np.testing.assert_array_equal(got, want)


def test_rbf_rows_at_and_matvec_match_jax(data):
    X, idx, _, _ = data
    T = torch.tensor(X)
    _close(trbf.rbf_rows_at(T, torch.tensor(idx), 0.3),
           jrbf.rbf_rows_at(jnp.asarray(X), jnp.asarray(idx), 0.3), atol=1e-6)
    c = np.random.default_rng(2).standard_normal(301).astype(np.float32)
    _close(trbf.rbf_matvec(T, torch.tensor(c), 0.3, block=100),
           jrbf.rbf_matvec(jnp.asarray(X), jnp.asarray(c), 0.3, block=100),
           atol=1e-5 * float(np.abs(c).sum()))


def test_masked_argmin_argmax_take_the_first_extremum():
    f = np.array([3.0, -1.0, 2.0, -1.0, 5.0, 5.0, -7.0])
    for mask in ([1, 1, 1, 1, 1, 1, 0], [0, 1, 0, 1, 1, 1, 0], [0] * 7,
                 [1, 0, 0, 0, 0, 0, 0]):
        m = np.array(mask, bool)
        for t_fn, j_fn in ((tsel.masked_argmin, jsel.masked_argmin),
                           (tsel.masked_argmax, jsel.masked_argmax)):
            ti, tany = t_fn(torch.tensor(f), torch.tensor(m))
            ji, jany = j_fn(jnp.asarray(f), jnp.asarray(m))
            assert int(ti) == int(ji) and bool(tany) == bool(jany)
    # along a batch axis: each row as on its own
    F = torch.tensor(np.stack([f, -f]))
    M = torch.tensor(np.stack([np.ones(7, bool), np.array([0, 1] * 3 + [1], bool)]))
    i, found = tsel.masked_argmin(F, M, dim=1)
    for r in range(2):
        assert int(i[r]) == int(tsel.masked_argmin(F[r], M[r])[0])
    assert found.all()


def test_family_validation_errors():
    with pytest.raises(ValueError, match="unknown kernel family"):
        tkernels.validate_family("laplace")
    with pytest.raises(ValueError, match="unknown kernel family"):
        tkernels.needs_norms("laplace")
    with pytest.raises(ValueError, match="unknown kernel family"):
        SVMConfig(kernel="laplace")
    for fam in ("rff", "nystrom"):
        assert tkernels.validate_family(fam) == fam and tkernels.is_approx(fam)
        assert not tkernels.needs_norms(fam)
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            SVMConfig(kernel=fam)
    assert tkernels.needs_norms("rbf") and not tkernels.needs_norms("poly")
    assert tkernels.sq_norms_for("linear", torch.ones(3, 2)) is None
    with pytest.raises(ValueError, match="degree"):
        SVMConfig(kernel="poly", degree=0)
    with pytest.raises(ValueError, match="epsilon"):
        SVMConfig(epsilon=-0.1)
    for fam in ("linear", "poly", "sigmoid"):
        assert SVMConfig(kernel=fam).kernel == fam


def test_fused_fupdate_refused_off_rbf():
    for fam in ("linear", "poly", "sigmoid"):
        assert resolve_solver_config(1000, 256, "auto", "auto", fam)[2] is False
        with pytest.raises(ValueError, match="RBF pipeline only"):
            resolve_solver_config(1000, 256, "auto", True, fam)
    assert resolve_solver_config(1000, 256, "auto", "auto", "rbf")[2] is True
    X = np.random.default_rng(0).random((200, 3)).astype(np.float32)
    Y = np.tile([1, -1], 100).astype(np.int32)
    with pytest.raises(ValueError, match="RBF pipeline only"):
        blocked_smo_solve(X, Y, kernel="poly", fused_fupdate=True, q=128,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        blocked_smo_solve(X, Y, kernel="rff", q=128, device="cpu")


def test_svr_doubling_is_the_jax_packages():
    t = np.random.default_rng(3).standard_normal(37)
    for a, b in zip(tsvr.doubled_problem(t, 0.2), jsvr.doubled_problem(t, 0.2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    beta = np.random.default_rng(4).random(74)
    np.testing.assert_array_equal(tsvr.collapse_duals(beta),
                                  jsvr.collapse_duals(beta))
    for bad in (lambda m: m.doubled_problem(np.ones((2, 2)), 0.1),
                lambda m: m.doubled_problem(t, -1.0),
                lambda m: m.collapse_duals(np.ones(5))):
        with pytest.raises(ValueError):
            bad(tsvr)
        with pytest.raises(ValueError):
            bad(jsvr)


def test_platt_fit_is_the_jax_packages():
    rng = np.random.default_rng(6)
    labels = np.where(rng.random(400) < 0.4, 1, -1)
    scores = labels * rng.random(400) * 2 + rng.standard_normal(400) * 0.7
    assert tplatt.fit_platt(scores, labels) == jplatt.fit_platt(scores, labels)
    A, B = tplatt.fit_platt(scores, labels)
    np.testing.assert_array_equal(tplatt.platt_proba(scores, A, B),
                                  jplatt.platt_proba(scores, A, B))
    p = tplatt.platt_proba(scores, A, B)
    assert tplatt.log_loss(p, labels) == jplatt.log_loss(p, labels)
    with pytest.raises(ValueError, match="both classes"):
        tplatt.fit_platt(scores, np.ones(400))


def test_stratified_kfold_is_the_jax_packages():
    Y = np.random.default_rng(8).integers(0, 3, size=101)
    for k, seed in ((2, 0), (3, 1), (5, 9)):
        for a, b in zip(tfolds.stratified_kfold(Y, k, seed),
                        jfolds.stratified_kfold(Y, k, seed)):
            np.testing.assert_array_equal(a.train_idx, b.train_idx)
            np.testing.assert_array_equal(a.val_idx, b.val_idx)
            assert a.train_idx.dtype == b.train_idx.dtype
    with pytest.raises(ValueError):
        tfolds.stratified_kfold(Y, 1)
