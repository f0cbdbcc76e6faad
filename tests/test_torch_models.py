"""The port's estimator, artifact, carry-across, data and command line
against the JAX package's, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import MinMaxScaler as JScaler
from tpusvm.data import synthetic as jsyn
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm.models.serialization import load_model as j_load_model
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch import convert
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import MinMaxScaler, synthetic as tsyn
from tpusvm_torch.models.serialization import load_model
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.status import Status

REPO = Path(__file__).resolve().parents[1]
C, GAMMA = 1.0, 5.0


@pytest.fixture(scope="module")
def rings_data():
    X, Y = jsyn.rings(n=500, seed=2)
    return X[:400], Y[:400], X[400:], Y[400:]


@pytest.fixture(scope="module")
def fitted(rings_data):
    X, Y, _, _ = rings_data
    jm = JBinarySVC(JConfig(C=C, gamma=GAMMA), dtype=jnp.float32,
                    solver_opts=dict(q=128, max_inner=256))
    jm.fit(X, Y)
    tm = BinarySVC(SVMConfig(C=C, gamma=GAMMA), device="cpu",
                   solver_opts=dict(q=128, max_inner=256, inner="loop",
                                    fused_fupdate=False))
    tm.fit(X, Y)
    return jm, tm


def test_binary_svc_matches_jax(fitted, rings_data):
    jm, tm = fitted
    _, _, Xt, Yt = rings_data
    assert tm.status_ == jm.status_ == Status.CONVERGED
    np.testing.assert_array_equal(tm.sv_ids_, jm.sv_ids_)
    assert abs(tm.b_ - jm.b_) <= 1e-4
    np.testing.assert_array_equal(tm.predict(Xt), jm.predict(Xt))
    assert tm.score(Xt, Yt) == jm.score(Xt, Yt)
    # attribute names and dtypes follow the JAX estimator's
    for name in ("sv_X_", "sv_Y_", "sv_alpha_", "sv_ids_"):
        assert getattr(tm, name).dtype == getattr(jm, name).dtype, name


def test_fit_records_host_phases(fitted):
    _, tm = fitted
    phases = tm.fit_phases_
    assert list(phases) == ["scale", "cast", "to_device", "solve", "to_host",
                            "sv_extract"]
    assert all(v >= 0.0 for v in phases.values())
    assert 0.0 <= tm.result_.host_wait_s <= phases["solve"]
    assert tm.train_time_s_ <= sum(phases.values())


def test_kernel_engine_fit_matches_jax(rings_data):
    X, Y, Xt, _ = rings_data
    jm = JBinarySVC(JConfig(C=C, gamma=GAMMA), dtype=jnp.float32,
                    solver_opts=dict(q=128, max_inner=256, wss=2,
                                     inner="pallas", fused_fupdate=True))
    jm.fit(X, Y)
    tm = BinarySVC(SVMConfig(C=C, gamma=GAMMA), device="cpu",
                   solver_opts=dict(q=128, max_inner=256, wss=2))
    tm.fit(X, Y)
    np.testing.assert_array_equal(tm.sv_ids_, jm.sv_ids_)
    np.testing.assert_array_equal(tm.predict(Xt), jm.predict(Xt))


def test_port_artifact_loads_in_jax(fitted, rings_data, tmp_path):
    _, tm = fitted
    _, _, Xt, _ = rings_data
    path = str(tmp_path / "port.npz")
    tm.save(path)
    state, cfg = j_load_model(path)
    assert cfg.kernel == "rbf" and cfg.C == C and cfg.gamma == GAMMA
    jm = JBinarySVC.load(path)
    np.testing.assert_allclose(jm.decision_function(Xt),
                               tm.decision_function(Xt), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(jm.sv_ids_, tm.sv_ids_)


def test_jax_artifact_loads_in_port(fitted, rings_data, tmp_path):
    jm, _ = fitted
    _, _, Xt, _ = rings_data
    path = str(tmp_path / "jax.npz")
    jm.save(path)
    tm = BinarySVC.load(path, device="cpu")
    np.testing.assert_allclose(tm.decision_function(Xt),
                               jm.decision_function(Xt), rtol=0, atol=1e-5)
    state, cfg = load_model(path)
    assert set(state) >= {"sv_X", "sv_Y", "sv_alpha", "sv_ids", "b", "scale"}
    # the port writes back the same keys and dtypes
    path2 = str(tmp_path / "again.npz")
    tm.save(path2)
    with np.load(path) as a, np.load(path2) as b:
        for key in ("sv_X", "sv_Y", "sv_alpha", "sv_ids", "b", "scale",
                    "scaler_min", "scaler_max", "format_version"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


def test_load_rejects_later_slice_artifacts(tmp_path):
    # the approximate-kernel families are the kind this port cannot score
    # yet; SVR and one-vs-rest artifacts load
    path = str(tmp_path / "rff.npz")
    np.savez(path, format_version=4, map_n_features_in=3, config_kernel="rff")
    with pytest.raises(NotImplementedError, match="approximate"):
        load_model(path)
    np.savez(path, format_version=9)
    with pytest.raises(ValueError, match="version 9"):
        load_model(path)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        SVMConfig(kernel="rff")
    assert SVMConfig(kernel="poly").kernel == "poly"


def test_from_jax_state_scores_like_jax(fitted, rings_data):
    jm, _ = fitted
    _, _, Xt, _ = rings_data
    state = {name: getattr(jm, name) for name in
             ("sv_X_", "sv_Y_", "sv_alpha_", "sv_ids_", "b_")}
    state["scaler_min"] = jm.scaler_.min_val
    state["scaler_max"] = jm.scaler_.max_val
    state["config"] = jm.config
    tm = convert.from_jax_state(state, device="cpu")
    assert tm.config.gamma == GAMMA and tm.config.C == C
    np.testing.assert_allclose(tm.decision_function(Xt),
                               jm.decision_function(Xt), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(Xt), jm.predict(Xt))


@pytest.mark.parametrize("with_f", [False, True])
def test_solver_state_from_numpy_resumes_a_jax_solve(with_f):
    X, Y = jsyn.blobs(n=400, d=2, seed=0)
    Xs = JScaler().fit_transform(X).astype(np.float32)
    kw = dict(C=1.0, gamma=1.0, q=128, max_inner=256)
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64,
                  inner="xla", **kw)
    alpha = np.asarray(r_j.alpha)
    f = None
    if with_f:
        K = np.exp(-1.0 * ((Xs[:, None, :].astype(np.float64)
                            - Xs[None, :, :]) ** 2).sum(-1))
        f = K @ (alpha * Y) - Y
    warm = convert.solver_state_from_numpy(alpha, f, device="cpu")
    r_t = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), device="cpu",
                            accum_dtype=torch.float64, inner="loop", **kw,
                            **warm)
    assert r_t.status == Status.CONVERGED and r_t.n_outer <= 2
    assert abs(r_t.b - float(r_j.b)) <= 1e-4
    np.testing.assert_array_equal(np.nonzero(r_t.alpha.numpy() > 1e-8)[0],
                                  np.nonzero(alpha > 1e-8)[0])


def test_synthetic_arrays_bit_identical():
    for name, kw in (("blobs", dict(n=201, d=5, seed=3)),
                     ("rings", dict(n=301, seed=4)),
                     ("mnist_like_multiclass", dict(n=530, d=40, noise=7.0)),
                     ("mnist_like", dict(n=530, d=40, noise=30.0,
                                         label_noise=0.05, seed=9))):
        for a, b in zip(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    X, _ = jsyn.mnist_like(n=300, d=50)
    X[:, 3] = 7.0  # a degenerate (constant) feature
    np.testing.assert_array_equal(MinMaxScaler().fit_transform(X),
                                  JScaler().fit_transform(X))


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "tpusvm_torch", *args],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_cli_train_and_predict_print_the_diagnostics(tmp_path):
    model = str(tmp_path / "m.npz")
    out = _cli("train", "--synthetic", "rings", "--n", "400", "--n-test",
               "200", "--gamma", "5", "--C", "1", "--device", "cpu",
               "--save", model, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    for needle in ("n = 400, n_features = 2", "iterations = ", "b = ",
                   "(b_high - b_low)/2 * 1e10 = ", "SV count = ",
                   "accuracy = ", "(", "/200)", "training time: ",
                   "prediction time: ", "elapsed time: "):
        assert needle in text, (needle, text)
    b_line = next(line for line in text.splitlines() if line.startswith("b = "))
    assert len(b_line.split(".")[-1]) == 15
    acc = next(line for line in text.splitlines() if line.startswith("accuracy"))
    out = _cli("predict", "--synthetic", "rings", "--n", "400", "--n-test",
               "200", "--model", model, "--device", "cpu", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert acc in out.stdout
