"""BinarySVC.fit's device route for the min-max scaling and the feature
cast, on the CPU (device="cpu" takes the same route as the card).

Rows with a constant column (the degenerate range), negative and
non-integer values, as float64 and as float32: the features the solve
receives, the scaler and sv_X_ are the bits of the numpy scaler followed
by the host cast, for each feature dtype; the fit is the unscaled fit of
the numpy-scaled rows, alpha, b and SV ids alike; the caller's rows are
never written, whatever their layout; scale_device_ names the route, and
the approximate families, integer rows and unscaled fits keep the host's
(with its phase order); a saved and loaded model scores as the fitted
one."""

import numpy as np
import pytest
import torch

import tpusvm_torch.models.svm as svm_mod
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.scaler import MinMaxScaler, fit_transform_on_device
from tpusvm_torch.data.synthetic import rings
from tpusvm_torch.device import to_dtype
from tpusvm_torch.models.svm import BinarySVC

CFG = SVMConfig(C=10.0, gamma=10.0)
OPTS = dict(q=16)
HOST_ORDER = ["scale", "cast", "to_device", "solve", "to_host", "sv_extract"]
DEVICE_ORDER = ["to_device", "scale", "cast", "solve", "to_host",
                "sv_extract"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small per-step ops on one intra-op thread (a parallel test run's
    workers contend for the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """rings in 2-D (random radii and angles), stretched and shifted below
    zero, a constant column and a column of small non-integer values
    beside them; float64."""
    X, Y = rings(n=200, seed=5)
    X = np.column_stack([X[:, 0] * 3.7 - 1.3, np.full(len(X), 2.5),
                         X[:, 1] * -0.013 + 0.2,
                         (X[:, 0] + X[:, 1]) * 1e-3 - 3e-4])
    return X, Y.astype(np.int32)


def _rows(data, rows):
    X, Y = data
    return X.astype(rows), Y


def _model(**kw):
    return BinarySVC(CFG, device="cpu", solver_opts=OPTS, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("rows", [np.float64, np.float32])
def test_device_route_features_are_the_host_scaling_and_cast(
        data, rows, dtype, monkeypatch):
    X, Y = _rows(data, rows)
    seen = []
    real = svm_mod.solve

    def spy(solver, Xd, *a, **kw):
        seen.append(Xd.clone())
        return real(solver, Xd, *a, **kw)

    monkeypatch.setattr(svm_mod, "solve", spy)
    m = _model(dtype=dtype).fit(X, Y)
    ref = MinMaxScaler().fit(X)
    Xs = ref.transform(X)
    (got,) = seen
    assert got.dtype == dtype
    assert torch.equal(got, to_dtype(Xs, dtype))
    for a, b in ((m.scaler_.min_val, ref.min_val),
                 (m.scaler_.max_val, ref.max_val)):
        assert a.dtype == b.dtype == rows and a.tobytes() == b.tobytes()
    assert m.sv_X_.dtype == Xs.dtype
    assert m.sv_X_.tobytes() == Xs[m.sv_ids_].tobytes()
    assert m.scale_device_ == "cpu"
    assert list(m.fit_phases_) == DEVICE_ORDER


@pytest.mark.parametrize("rows", [np.float64, np.float32])
def test_a_scaled_fit_is_the_unscaled_fit_of_the_numpy_scaled_rows(data,
                                                                   rows):
    X, Y = _rows(data, rows)
    a = _model().fit(X, Y)
    b = _model(scale=False).fit(MinMaxScaler().fit_transform(X), Y)
    assert torch.equal(a.result_.alpha, b.result_.alpha)
    assert a.b_ == b.b_ and a.n_iter_ == b.n_iter_
    assert np.array_equal(a.sv_ids_, b.sv_ids_)
    assert a.sv_X_.tobytes() == b.sv_X_.tobytes()


LAYOUTS = {
    "c_order": lambda X: X.copy(),
    "read_only": lambda X: _read_only(X.copy()),
    "fortran": lambda X: np.asfortranarray(X),
    "reversed_view": lambda X: X[::-1].copy()[::-1],
}


def _read_only(X):
    X.flags.writeable = False
    return X


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_callers_rows_are_never_written(data, layout):
    X, Y = data
    Xc = LAYOUTS[layout](X)
    before = Xc.copy()
    m = _model().fit(Xc, Y)
    assert Xc.tobytes() == before.tobytes()
    plain = _model().fit(X, Y)
    assert torch.equal(m.result_.alpha, plain.result_.alpha)
    assert m.sv_X_.tobytes() == plain.sv_X_.tobytes()


ROUTES = {
    "exact_float_rows": (dict(), lambda X: X, "cpu", DEVICE_ORDER),
    "rff": (dict(config=SVMConfig(C=10.0, gamma=10.0, kernel="rff",
                                  rff_dim=256)),
            lambda X: X, "host", HOST_ORDER[:3] + ["map"] + HOST_ORDER[3:]),
    "int_rows": (dict(), lambda X: np.round(X * 1000).astype(np.int64),
                 "host", HOST_ORDER),
    "unscaled": (dict(scale=False), lambda X: MinMaxScaler().fit_transform(X),
                 None, HOST_ORDER),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_scale_device_names_the_route(data, route):
    kw, rows, where, order = ROUTES[route]
    X, Y = data
    kw = dict(kw)
    m = BinarySVC(kw.pop("config", CFG), device="cpu", solver_opts=OPTS,
                  **kw).fit(rows(X), Y)
    assert m.scale_device_ == where
    assert list(m.fit_phases_) == order
    if where == "host":
        ref = MinMaxScaler().fit(rows(X))
        assert m.scaler_.min_val.tobytes() == ref.min_val.tobytes()
        assert m.scaler_.max_val.tobytes() == ref.max_val.tobytes()


def test_fit_transform_on_device_scales_in_place(data):
    X, _ = data
    Xd = torch.from_numpy(X.copy())
    scaler = fit_transform_on_device(Xd)
    ref = MinMaxScaler().fit(X)
    assert Xd.numpy().tobytes() == ref.transform(X).tobytes()
    # the constant column: a range below 1e-12 counts as 1.0
    assert scaler.range_[1] == 1.0 and np.all(Xd[:, 1].numpy() == 0.0)


def test_a_saved_and_loaded_model_scores_as_the_fitted_one(data, tmp_path):
    X, Y = data
    m = _model().fit(X, Y)
    path = str(tmp_path / "m.npz")
    m.save(path)
    loaded = BinarySVC.load(path, device="cpu")
    Xq = X[::3] * 1.01
    assert loaded.decision_function(Xq).tobytes() == \
        m.decision_function(Xq).tobytes()
    assert np.array_equal(loaded.predict(Xq), m.predict(Xq))
