"""Artifacts across the two packages, on the CPU: one-vs-rest, epsilon-SVR,
poly, sigmoid and calibrated models saved by either package load in the
other (`load_any` picking the right class) and score alike; the port's
command line writes each kind, and reads the JAX package's.

Tolerance: both packages score in f32 from the same stored arrays, so
they differ only in the order of the f32 sum over the SVs (and, for
sigmoid, by an ulp of XLA's CPU tanh against torch's). That error scales
with the sum's mass M(x) = sum_k |coef_k K(x, sv_k)| (in f64), so scores
agree within 1e-5 * max(1, M) (M is a few hundred for the C=10 models
here, where a plain 1e-5 is under the f32 rounding of the sum); the
probabilities of a calibrated model within 1e-5."""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import synthetic as jsyn
from tpusvm import models as jmodels
from tpusvm_torch import cli, convert
from tpusvm_torch import models as tmodels
from tpusvm_torch.config import SVMConfig



def _kinds():
    """(name, data (X, Y, Xt), config kwargs, port class, JAX class, fit
    kwargs, calibrate)"""
    Xr, Yr = jsyn.rings(n=300, seed=6)
    Xm, lm = jsyn.mnist_like_multiclass(n=300, d=16, n_classes=3, seed=2,
                                        noise=10.0)
    Xs, ts = jsyn.svr_sine(n=200, d=1, seed=4)
    return {
        "poly": ((Xr[:240], Yr[:240], Xr[240:]),
                 dict(C=1.0, gamma=1.0, kernel="poly", degree=3, coef0=1.0),
                 "BinarySVC", False),
        "calibrated": ((Xr[:240], Yr[:240], Xr[240:]), dict(C=1.0, gamma=5.0),
                       "BinarySVC", True),
        "ovr": ((Xm[:240], lm[:240], Xm[240:]), dict(C=10.0, gamma=0.1),
                "OneVsRestSVC", False),
        "sigmoid": ((Xm[:240], lm[:240] == 1, Xm[240:]),
                    dict(C=10.0, gamma=0.1, kernel="sigmoid", coef0=-1.0),
                    "BinarySVC", False),
        "svr": ((Xs[:160], ts[:160], Xs[160:]), dict(C=10.0, gamma=20.0),
                "EpsilonSVR", False),
    }


KINDS = _kinds()


def _atol(model, X):
    """1e-5 * max(1, the largest mass of the score sum over X's rows)."""
    from tpusvm_torch import kernels

    cfg = model.config
    Xs = model.scaler_.transform(np.asarray(X)) if model.scale else np.asarray(X)
    kind = type(model).__name__
    sv = model.X_sv_ if kind == "OneVsRestSVC" else model.sv_X_
    coef = (model.coef_.T if kind == "OneVsRestSVC" else
            model.sv_coef_ if kind == "EpsilonSVR" else
            model.sv_alpha_ * model.sv_Y_)
    K = kernels.cross(cfg.kernel, torch.tensor(Xs, dtype=torch.float64),
                      torch.tensor(np.asarray(sv), dtype=torch.float64),
                      gamma=cfg.gamma, coef0=cfg.coef0, degree=cfg.degree)
    mass = K.abs().numpy() @ np.abs(np.asarray(coef, np.float64))
    return 1e-5 * max(1.0, float(mass.max()))


def _scores(model, X):
    return (model.predict(X) if type(model).__name__ == "EpsilonSVR"
            else model.decision_function(X))


@pytest.fixture(scope="module", params=sorted(KINDS))
def pair_of_models(request):
    name = request.param
    (X, Y, Xt), cfg, cls, cal = KINDS[name]
    if Y.dtype == bool:
        Y = np.where(Y, 1, -1).astype(np.int32)
    opts = dict(q=128, max_inner=256)
    solver = dict(solver="pair") if cls == "OneVsRestSVC" else dict(
        solver="blocked", solver_opts=opts)
    tm = getattr(tmodels, cls)(SVMConfig(**cfg), device="cpu", **solver).fit(X, Y)
    jm = getattr(jmodels, cls)(JConfig(**cfg), dtype=jnp.float32, **solver).fit(X, Y)
    if cal:
        tm.calibrate(X, Y, folds=3)
        jm.calibrate(X, Y, folds=3)
    return name, cls, tm, jm, Xt


def test_port_artifact_loads_in_jax(pair_of_models, tmp_path):
    name, cls, tm, _, Xt = pair_of_models
    path = str(tmp_path / f"{name}.npz")
    tm.save(path)
    jm = jmodels.load_any(path)
    assert type(jm).__name__ == cls
    np.testing.assert_allclose(_scores(jm, Xt), _scores(tm, Xt), rtol=0,
                               atol=_atol(tm, Xt))
    if name == "calibrated":
        np.testing.assert_allclose(jm.predict_proba(Xt), tm.predict_proba(Xt),
                                   atol=1e-5)
    assert jm.config.kernel == tm.config.kernel


def test_jax_artifact_loads_in_port(pair_of_models, tmp_path):
    name, cls, _, jm, Xt = pair_of_models
    path = str(tmp_path / f"{name}.npz")
    jm.save(path)
    assert tmodels.model_task(path) == jmodels.model_task(path)
    tm = tmodels.load_any(path, device="cpu")
    assert type(tm).__name__ == cls
    np.testing.assert_allclose(_scores(tm, Xt), _scores(jm, Xt), rtol=0,
                               atol=_atol(tm, Xt))
    if name == "calibrated":
        assert tm.platt_ == jm.platt_
    # and back again: the port writes the keys it read
    path2 = str(tmp_path / f"{name}_again.npz")
    tm.save(path2)
    with np.load(path) as a, np.load(path2) as b:
        assert set(a.files) <= set(b.files) | {"train_precision", "shrink_every",
                                               "shrink_stable"} | {
            k for k in a.files if k.startswith("config_")}
        for key in a.files:
            if key in b.files and not key.startswith("config_"):
                np.testing.assert_array_equal(a[key], b[key])


def test_from_jax_state_carries_every_kind(pair_of_models):
    name, cls, _, jm, Xt = pair_of_models
    names = ("sv_X_", "sv_Y_", "sv_alpha_", "sv_ids_", "b_", "platt_",
             "classes_", "X_sv_", "coef_", "sv_coef_")
    state = {k: getattr(jm, k) for k in names if getattr(jm, k, None) is not None}
    state["scaler_min"] = jm.scaler_.min_val
    state["scaler_max"] = jm.scaler_.max_val
    state["config"] = jm.config
    tm = convert.from_jax_state(state, device="cpu")
    assert type(tm).__name__ == cls
    np.testing.assert_allclose(_scores(tm, Xt), _scores(jm, Xt), rtol=0,
                               atol=_atol(tm, Xt))


def test_load_refuses_approximate_artifacts(tmp_path):
    path = str(tmp_path / "rff.npz")
    np.savez(path, format_version=4, config_kernel="rff", map_n_features_in=3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tmodels.load_model(path)
    np.savez(path, format_version=4, config_kernel="laplace")
    with pytest.raises(ValueError, match="laplace"):
        tmodels.load_model(path)


def _cli(*args, cwd):
    """The command line in this process: (returncode, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = cli.main(list(args))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
                print(e.code, file=sys.stderr)
    finally:
        os.chdir(old)
    return subprocess.CompletedProcess(args, rc, out.getvalue(), err.getvalue())


_RUNS = {
    "pair": (["--synthetic", "rings", "--gamma", "5", "--C", "1", "--solver",
              "pair"], "BinarySVC"),
    "poly": (["--synthetic", "rings", "--C", "1", "--gamma", "1", "--kernel",
              "poly", "--coef0", "1"], "BinarySVC"),
    "multiclass": (["--synthetic", "mnist_like", "--d", "16", "--gamma", "0.1",
                    "--multiclass"], "OneVsRestSVC"),
    "svr": (["--synthetic", "svr_sine", "--d", "1", "--gamma", "20", "--task",
             "svr"], "EpsilonSVR"),
    "calibrate": (["--synthetic", "rings", "--gamma", "5", "--C", "1",
                   "--calibrate", "3"], "BinarySVC"),
}


@pytest.mark.parametrize("run", sorted(_RUNS))
def test_cli_train_writes_artifacts_jax_scores_alike(run, tmp_path):
    flags, cls = _RUNS[run]
    model = str(tmp_path / "m.npz")
    out = _cli("train", "--n", "300", "--n-test", "100", "--device", "cpu",
               "--save", model, *flags, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    for needle in ("n = 300, n_features = ", "training time: ", "elapsed time: ",
                   "model saved to "):
        assert needle in text, (needle, text)
    if cls == "OneVsRestSVC":
        assert "classes = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]" in text
    else:
        for needle in ("iterations = ", "b = ", "SV count = "):
            assert needle in text, (needle, text)
    assert ("r2 = " if cls == "EpsilonSVR" else "accuracy = ") in text
    if run == "calibrate":
        assert "calibrated: Platt A=" in text
    jm = jmodels.load_any(model)
    tm = tmodels.load_any(model, device="cpu")
    assert type(jm).__name__ == type(tm).__name__ == cls
    Xt = (jsyn.svr_sine(n=50, d=1, seed=9)[0] if cls == "EpsilonSVR" else
          jsyn.mnist_like(n=50, d=16, seed=9)[0] if cls == "OneVsRestSVC" else
          jsyn.rings(n=50, seed=9)[0])
    np.testing.assert_allclose(_scores(tm, Xt), _scores(jm, Xt), rtol=0,
                               atol=_atol(tm, Xt))


def test_cli_predict_reads_a_jax_ovr_artifact(tmp_path):
    X, labels = jsyn.mnist_like_multiclass(n=400, d=16, seed=587, noise=300.0)
    jm = jmodels.OneVsRestSVC(JConfig(C=10.0, gamma=0.1), dtype=jnp.float32)
    jm.fit(X[:300], labels[:300])
    path = str(tmp_path / "jax_ovr.npz")
    jm.save(path)
    out = _cli("predict", "--synthetic", "mnist_like_multiclass", "--n", "300",
               "--n-test", "100", "--d", "16", "--model", path, "--device", "cpu",
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    acc = jm.score(X[300:], labels[300:])
    assert f"accuracy = {acc:.4f} ({round(acc * 100)}/100)" in out.stdout


def test_cli_refuses_the_jax_packages_invalid_combinations(tmp_path):
    for flags, msg in ((["--task", "svr", "--multiclass"], "regression task"),
                       (["--task", "svr", "--calibrate", "3"], "requires --task svc"),
                       (["--calibrate", "1"], ">= 2 folds"),
                       (["--multiclass", "--calibrate", "3"], "binary"),
                       (["--kernel", "rff"], "Queue 1 item 10")):
        out = _cli("train", "--synthetic", "rings", "--n", "50", "--n-test", "0",
                   "--device", "cpu", *flags, cwd=tmp_path)
        assert out.returncode != 0 and msg in out.stderr, (flags, out.stderr)
    for source, msg in (("svr_sine", "requires --task svr"),
                        ("mnist_like_multiclass", "requires --multiclass")):
        out = _cli("train", "--synthetic", source, "--n", "50", "--device", "cpu",
                   cwd=tmp_path)
        assert out.returncode != 0 and msg in out.stderr
