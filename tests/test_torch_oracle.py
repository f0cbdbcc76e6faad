"""The port's NumPy oracle against the JAX package's, bit for bit.

Both are the same numpy code on the same float64 inputs, so smo_train's
alpha, b, b_high, b_low, n_iter and status, svr_train's doubled duals,
predict's labels and kernel_row's values must be equal bytes (tolerance:
none) on blobs, rings and a small mnist_like, in every exact family.
"""

import numpy as np
import pytest

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import MinMaxScaler, blobs, mnist_like, rings, svr_sine
from tpusvm.oracle import smo as j_smo
from tpusvm_torch.config import SVMConfig as TConfig
from tpusvm_torch.oracle import smo as t_smo

_CASES = {
    "blobs": (lambda: blobs(n=160, d=4, seed=3), dict(C=1.0, gamma=0.5)),
    "rings": (lambda: rings(n=200, seed=4), dict(C=10.0, gamma=10.0)),
    "mnist_like": (lambda: mnist_like(n=150, d=20, seed=6),
                   dict(C=10.0, gamma=1.0 / 20)),
}
_FAMILIES = [dict(kernel="rbf"), dict(kernel="linear"),
             dict(kernel="poly", degree=3, coef0=1.0),
             dict(kernel="sigmoid", coef0=-1.0)]


def _same_result(t, j):
    assert t.alpha.dtype == j.alpha.dtype
    assert t.alpha.tobytes() == j.alpha.tobytes()
    for f in ("b", "b_high", "b_low"):
        a, b = getattr(t, f), getattr(j, f)
        assert (np.isnan(a) and np.isnan(b)) or a == b, f
    assert t.n_iter == j.n_iter and int(t.status) == int(j.status)


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("fam", _FAMILIES, ids=lambda f: f["kernel"])
def test_smo_train_and_predict_match_jax(name, fam):
    gen, hyper = _CASES[name]
    X, Y = gen()
    Xs = MinMaxScaler().fit_transform(X)
    kw = dict(hyper, max_iter=20000, **fam)
    t = t_smo.smo_train(Xs, Y, TConfig(**kw))
    j = j_smo.smo_train(Xs, Y, JConfig(**kw))
    _same_result(t, j)
    assert np.array_equal(t_smo.get_sv_indices(t.alpha),
                          j_smo.get_sv_indices(j.alpha))
    row_t = t_smo.kernel_row(Xs, Xs[7], TConfig(**kw))
    row_j = j_smo.kernel_row(Xs, Xs[7], JConfig(**kw))
    assert row_t.tobytes() == row_j.tobytes()
    if fam["kernel"] == "rbf":
        p_t = t_smo.predict(Xs, Xs, Y, t.alpha, t.b, hyper["gamma"])
        p_j = j_smo.predict(Xs, Xs, Y, j.alpha, j.b, hyper["gamma"])
        assert np.array_equal(p_t, p_j) and p_t.dtype == p_j.dtype


def test_warm_start_and_targets_match_jax():
    X, Y = rings(n=120, seed=9)
    Xs = MinMaxScaler().fit_transform(X)
    kw = dict(C=10.0, gamma=10.0)
    alpha0 = j_smo.smo_train(Xs, Y, JConfig(max_iter=40, **kw)).alpha
    t = t_smo.smo_train(Xs, Y, TConfig(**kw), alpha0=alpha0, warm_start=True)
    j = j_smo.smo_train(Xs, Y, JConfig(**kw), alpha0=alpha0, warm_start=True)
    _same_result(t, j)
    z = Y + np.linspace(-0.1, 0.1, len(Y))
    _same_result(t_smo.smo_train(Xs, Y, TConfig(**kw), targets=z),
                 j_smo.smo_train(Xs, Y, JConfig(**kw), targets=z))


def test_svr_train_matches_jax():
    X, t = svr_sine(n=80, d=1, seed=2)
    Xs = MinMaxScaler().fit_transform(X)
    kw = dict(C=10.0, gamma=20.0, epsilon=0.1)
    _same_result(t_smo.svr_train(Xs, t, TConfig(**kw)),
                 j_smo.svr_train(Xs, t, JConfig(**kw)))


def test_statuses_and_empty_model_match_jax():
    # duplicate points with opposite labels: NONPOS_ETA in both
    Xd = np.zeros((4, 2))
    Yd = np.array([1, -1, 1, -1], np.int32)
    _same_result(t_smo.smo_train(Xd, Yd, TConfig(C=1.0, gamma=0.5)),
                 j_smo.smo_train(Xd, Yd, JConfig(C=1.0, gamma=0.5)))
    # one class only: NO_WORKING_SET with NaN b
    Y1 = np.ones(4, np.int32)
    X1 = np.arange(8.0).reshape(4, 2)
    _same_result(t_smo.smo_train(X1, Y1, TConfig()),
                 j_smo.smo_train(X1, Y1, JConfig()))
    # an empty SV set predicts sign(-b)
    a0 = np.zeros(4)
    assert np.array_equal(t_smo.predict(X1, X1, Y1, a0, -0.5, 1.0),
                          j_smo.predict(X1, X1, Y1, a0, -0.5, 1.0))
