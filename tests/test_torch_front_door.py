"""The front door's last gaps, on the CPU: the native CSV reader, the
feature dtype, predict --scores/--proba, train --smoke and ingest's
suppressed map flags.

Bands: read_csv_fast equals the pure-Python read_csv bit for bit (X and Y
bytes, dtypes and shapes; both raise on a ragged row) and the JAX
package's read_csv_fast. float64 fits equal JAX's float64 fits in status
and SV set with |db| <= 1e-4 (tests/test_torch_fault_points.py's float64
band). bfloat16 fits (torch and XLA accumulate bf16 products differently
on the CPU): the same status, SV-ID
Jaccard >= 0.9, held-out predictions equal on >= 99% of rows; measured
here: Jaccard 1.0 (binary) and 0.93 (one-vs-rest), every prediction
equal. predict --scores/--proba print the
JAX command line's lines: the same count and format, each value within
1e-5 x sum|coef| (scores) or 1e-5 (probabilities) of JAX's (XLA and torch
sum the f32 contraction in different orders), and on a float64 artifact
the same predicted signs.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import native_io as j_native_io
from tpusvm.models import BinarySVC as JBinary
from tpusvm.models import EpsilonSVR as JSVR
from tpusvm.models import OneVsRestSVC as JOvR
from tpusvm_torch.cli import main
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import blobs, read_csv, rings, svr_sine, write_csv
from tpusvm_torch.data import native_io
from tpusvm_torch.data.native_io import read_csv_fast
from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC
from tpusvm_torch.status import Status


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    (Xa, Ya), (Xb, Yb) = a, b
    assert Xa.dtype == Xb.dtype == np.float64 and Ya.dtype == Yb.dtype == np.int32
    assert Xa.shape == Xb.shape and Ya.shape == Yb.shape
    assert Xa.tobytes() == Xb.tobytes() and Ya.tobytes() == Yb.tobytes()


CSVS = {
    "plain": None,  # written by write_csv below
    "short_rows": "a,b,label\n1.5,2,1\n7\n\n3,4.25,0\n  \n-1e-3,5,3\n",
    "header_only": "a,b,label\n",
    "no_newline_at_end": "x,label\n0.1,1\n0.2,2",
    "exponents": "a,b,c,label\n1e-310,2.5e+300,-0.0,7\n0.1,0.2,0.30000000000000004,1\n",
}


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 7)) * 10.0 ** rng.integers(-5, 5, (300, 7))
    Y = rng.integers(0, 4, 300)
    write_csv(str(d / "plain.csv"), X, Y)
    for name, text in CSVS.items():
        if text is not None:
            (d / f"{name}.csv").write_text(text)
    return d


@pytest.mark.parametrize("name", sorted(CSVS))
@pytest.mark.parametrize("kw", [dict(), dict(n_limit=2), dict(n_limit=0),
                                dict(binary=False),
                                dict(positive_label=3)],
                         ids=["binary", "n_limit2", "n_limit0", "raw",
                              "positive3"])
def test_native_reader_equals_the_python_reader(csv_dir, name, kw):
    path = str(csv_dir / f"{name}.csv")
    fast_kw = {("binary_labels" if k == "binary" else k): v
               for k, v in kw.items()}
    want = read_csv(path, **kw)
    _same(read_csv_fast(path, **fast_kw), want)
    _same(j_native_io.read_csv_fast(path, **fast_kw), want)
    # more threads than rows: the slices split at line boundaries
    _same(read_csv_fast(path, n_threads=8, **fast_kw), want)


def test_ragged_and_malformed_rows_raise_in_both_readers(tmp_path):
    for i, text in enumerate(("a,b,label\n1,2,1\n1,2,3,1\n",
                              "a,b,label\n1,x,1\n", "a,b,label\n1,0x10,1\n")):
        path = str(tmp_path / f"bad{i}.csv")
        (tmp_path / f"bad{i}.csv").write_text(text)
        with pytest.raises(ValueError):
            read_csv(path)
        with pytest.raises(ValueError, match="malformed CSV"):
            read_csv_fast(path)
    with pytest.raises(OSError, match="failed to open"):
        read_csv_fast(str(tmp_path / "missing.csv"))


def test_the_library_builds_into_a_given_directory(tmp_path, csv_dir):
    lib = native_io.build_library(tmp_path / "b")
    assert lib.exists() and lib.parent == tmp_path / "b"
    assert lib == native_io.library_path(tmp_path / "b")
    path = str(csv_dir / "plain.csv")
    _same(read_csv_fast(path, build_dir=tmp_path / "b"), read_csv(path))
    # a second call finds it built
    assert native_io.build_library(tmp_path / "b") == lib


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                      csv_dir):
    bad = tmp_path / "csv_reader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        read_csv_fast(str(csv_dir / "plain.csv"), build_dir=tmp_path / "b")
    assert not list((tmp_path / "b").glob("*.so"))


def _four_class_data(n=400, seed=0):
    # tests/test_models.py's generator
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [6, 0], [0, 6], [6, 6]], float)
    labels = rng.integers(0, 4, n)
    X = centers[labels] + rng.normal(0, 0.8, (n, 2))
    return X, labels.astype(np.int32)


def _rings():
    X, Y = rings(n=260, seed=4)
    return X[:200], Y[:200], X[200:], Y[200:]


def _close(t, j, Xt, n_sv_min=1):
    assert Status(int(t.status_)) == Status(int(j.status_)) == Status.CONVERGED
    assert set(t.sv_ids_.tolist()) == set(np.asarray(j.sv_ids_).tolist())
    assert len(t.sv_ids_) >= n_sv_min
    assert abs(t.b_ - float(j.b_)) <= 1e-4


@pytest.mark.parametrize("solver", ["blocked", "pair"])
def test_float64_binary_fits_agree_with_jax(solver):
    X, Y, Xt, _ = _rings()
    cfg = dict(C=1.0, gamma=5.0)
    t = BinarySVC(SVMConfig(**cfg), solver=solver, dtype="float64",
                  device="cpu").fit(X, Y)
    j = JBinary(JConfig(**cfg), solver=solver, dtype=jnp.float64).fit(X, Y)
    assert t.dtype == torch.float64 and t.result_.alpha.dtype == torch.float64
    _close(t, j, Xt)
    np.testing.assert_array_equal(t.predict(Xt), j.predict(Xt))
    scores = t.decision_function(Xt)
    assert scores.dtype == np.float64
    # the scores differ by what b and the alphas do (|db| <= 1e-4)
    np.testing.assert_allclose(scores, np.asarray(j.decision_function(Xt)),
                               atol=1e-4)


@pytest.mark.parametrize("solver", ["pair", "blocked"])
def test_float64_ovr_fits_agree_with_jax(solver):
    X, labels = _four_class_data(n=240, seed=2)
    Xt, _ = _four_class_data(n=100, seed=3)
    cfg = dict(C=10.0, gamma=2.0)
    t = OneVsRestSVC(SVMConfig(**cfg), solver=solver, dtype=torch.float64,
                     device="cpu").fit(X, labels)
    j = JOvR(JConfig(**cfg), solver=solver, dtype=jnp.float64).fit(X, labels)
    assert (t.statuses_ == Status.CONVERGED).all()
    assert (np.asarray(j.statuses_) == Status.CONVERGED).all()
    assert set(t.sv_ids_.tolist()) == set(np.asarray(j.sv_ids_).tolist())
    np.testing.assert_allclose(t.b_, j.b_, atol=1e-4)
    np.testing.assert_array_equal(t.predict(Xt), j.predict(Xt))


def test_float64_svr_fit_agrees_with_jax():
    X, y = svr_sine(n=160, d=1, seed=5)
    cfg = dict(C=10.0, gamma=20.0, epsilon=0.1)
    t = EpsilonSVR(SVMConfig(**cfg), dtype="float64", device="cpu").fit(X, y)
    j = JSVR(JConfig(**cfg), dtype=jnp.float64).fit(X, y)
    assert t.status_ == Status.CONVERGED == Status(int(j.status_))
    assert set(t.sv_ids_.tolist()) == set(np.asarray(j.sv_ids_).tolist())
    assert abs(t.b_ - float(j.b_)) <= 1e-4


def test_float64_fleet_takes_the_torch_lanes():
    from tpusvm_torch.fleet import fleet_train
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_batched_kernel
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    X, Y, _, _ = _rings()
    Xd = torch.as_tensor(X)
    inner_smo_batched_kernel.launches = 0
    outs = fleet_train(Xd, [Y, Y], [1.0, 4.0], [5.0, 5.0], device="cpu",
                       q=64, accum_dtype=torch.float64)
    for o, C in zip(outs, (1.0, 4.0)):
        assert o.alpha.dtype == torch.float64
        solo = blocked_smo_solve(Xd, Y, C=C, gamma=5.0, q=64, inner="loop",
                                 accum_dtype=torch.float64, device="cpu")
        assert Status(int(o.status)) == Status(int(solo.status))
        assert torch.equal(o.alpha.cpu(), solo.alpha.cpu())
    # no lane went through the kernel engine's batched subproblem
    assert inner_smo_batched_kernel.launches == 0


def test_pair_refresh_resolution():
    from tpusvm_torch.solver.smo import resolve_pair_refresh, smo_solve

    assert resolve_pair_refresh(torch.float32) == "kernel"
    assert resolve_pair_refresh(torch.float32, "kernel") == "kernel"
    assert resolve_pair_refresh(torch.float64) == "plain"
    assert resolve_pair_refresh(torch.bfloat16) == "plain"
    with pytest.raises(ValueError, match="pair_rows kernel .* takes float32"):
        resolve_pair_refresh(torch.float64, "kernel")
    X, Y, _, _ = _rings()
    with pytest.raises(ValueError, match="takes float32"):
        smo_solve(torch.as_tensor(X), Y, refresh="kernel", device="cpu")
    with pytest.raises(ValueError, match="dtype must be"):
        BinarySVC(dtype="float16", device="cpu")


def _jaccard(a, b):
    a, b = set(a.tolist()), set(np.asarray(b).tolist())
    return len(a & b) / len(a | b)


@pytest.mark.parametrize("kind", ["binary", "ovr"])
def test_bfloat16_fits_within_the_stated_band(kind):
    # bfloat16 rounds a kernel value near 1 to 1, so an eta of such a pair
    # comes out 0 and the solve ends NONPOS_ETA: both packages do it, on
    # different pairs (rings at gamma=5 ends CONVERGED here and NONPOS_ETA
    # in JAX; tests/test_models.py's four classes at gamma=2 end it on
    # different heads). These fixtures keep eta away from 0 in bfloat16
    # (blobs at gamma 0.5; the four classes at gamma 0.5, where head 1
    # ends NONPOS_ETA in both): the statuses agree and the band applies.
    if kind == "binary":
        X, Y = blobs(n=260, d=6, seed=4)
        X, Y, Xt = X[:200], Y[:200], X[200:]
        cfg = dict(C=1.0, gamma=0.5)
        t = BinarySVC(SVMConfig(**cfg), dtype=torch.bfloat16,
                      device="cpu").fit(X, Y)
        j = JBinary(JConfig(**cfg), dtype=jnp.bfloat16).fit(X, Y)
        assert t.status_ == Status(int(j.status_)) == Status.CONVERGED
    else:
        X, Y = _four_class_data(n=240, seed=5)
        Xt, _ = _four_class_data(n=100, seed=6)
        cfg = dict(C=10.0, gamma=0.5)
        t = OneVsRestSVC(SVMConfig(**cfg), dtype="bfloat16",
                         device="cpu").fit(X, Y)
        j = JOvR(JConfig(**cfg), dtype=jnp.bfloat16).fit(X, Y)
        np.testing.assert_array_equal(t.statuses_, np.asarray(j.statuses_))
    assert _jaccard(t.sv_ids_, j.sv_ids_) >= 0.9
    agree = float((t.predict(Xt) == np.asarray(j.predict(Xt))).mean())
    assert agree >= 0.99
    assert t.decision_function(Xt).dtype == np.float32


def _jax_cli(argv, capsys):
    from tpusvm.cli import main as j_main

    assert j_main(argv) == 0
    return capsys.readouterr().out


def _port_cli(argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


LINE = re.compile(r"^-?\d+\.\d{15}( -?\d+\.\d{15})*$")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("pred")
    X, Y, Xt, Yt = _rings()
    cfg = SVMConfig(C=1.0, gamma=5.0)
    m = BinarySVC(cfg, device="cpu").fit(X, Y).calibrate(X, Y, folds=3)
    m.save(str(d / "platt.npz"))
    Xm, lm = _four_class_data(n=160, seed=2)
    OneVsRestSVC(SVMConfig(C=10.0, gamma=2.0), device="cpu").fit(
        Xm, lm).save(str(d / "ovr.npz"))
    write_csv(str(d / "t.csv"), Xt, Yt)
    write_csv(str(d / "tm.csv"), *_four_class_data(n=40, seed=3))
    return d, m


@pytest.mark.parametrize("case", ["scores", "proba", "ovr_scores"])
def test_predict_prints_the_jax_lines(artifacts, capsys, case):
    d, m = artifacts
    model, csv = (("ovr.npz", "tm.csv") if case == "ovr_scores"
                  else ("platt.npz", "t.csv"))
    flag = "--proba" if case == "proba" else "--scores"
    argv = ["predict", "--model", str(d / model), "--data", str(d / csv), flag]
    mine = _port_cli(argv + ["--device", "cpu"], capsys).splitlines()
    theirs = _jax_cli(argv, capsys).splitlines()
    assert len(mine) == len(theirs) > 0
    assert all(LINE.match(ln) for ln in mine)
    a = np.array([[float(v) for v in ln.split()] for ln in mine])
    b = np.array([[float(v) for v in ln.split()] for ln in theirs])
    tol = 1e-5 if case == "proba" else 1e-5 * np.abs(m.sv_alpha_).sum()
    assert np.abs(a - b).max() <= tol
    if case == "scores":
        # the same rows through the mesh split print the same signs
        meshed = _port_cli(argv + ["--mesh-predict", "--device", "cpu"],
                           capsys).splitlines()
        c = np.array([float(ln) for ln in meshed])
        np.testing.assert_array_equal(c > 0, a[:, 0] > 0)


def test_predict_refusals(artifacts, tmp_path):
    d, _ = artifacts
    with pytest.raises(SystemExit, match="--proba needs a calibrated binary"):
        main(["predict", "--model", str(d / "ovr.npz"), "--data",
              str(d / "tm.csv"), "--proba", "--device", "cpu"])
    from tpusvm_torch.stream import ingest_arrays

    X, Y, _, _ = _rings()
    ds = str(tmp_path / "ds")
    ingest_arrays(ds, X, Y, rows_per_shard=64)
    with pytest.raises(SystemExit, match="--mesh-predict applies to CSV"):
        main(["predict", "--model", str(d / "platt.npz"), "--data", ds,
              "--mesh-predict", "--device", "cpu"])


def test_predict_scores_on_a_dataset_directory(artifacts, tmp_path, capsys):
    from tpusvm_torch.stream import ingest_arrays

    d, m = artifacts
    X, Y, _, _ = _rings()
    ds = str(tmp_path / "ds")
    ingest_arrays(ds, X, Y, rows_per_shard=64)
    out = _port_cli(["predict", "--model", str(d / "platt.npz"), "--data", ds,
                     "--scores", "--n-limit", "150", "--batch-size", "64",
                     "--device", "cpu"], capsys).splitlines()
    # each batch scored as the stream scores it (64 rows a call)
    want = np.concatenate([m.decision_function(X[i:i + 64])
                           for i in range(0, 150, 64)])[:150]
    assert out == [f"{s:.15f}" for s in want]


@pytest.mark.parametrize("argv", [[], ["--task", "ovr", "--solver", "pair"],
                                  ["--task", "svr"]],
                         ids=["svc", "ovr", "svr"])
def test_train_smoke_cells_exit_zero(argv, capsys):
    assert main(["train", "--smoke", "--device", "cpu", *argv]) == 0
    assert "train smoke ok" in capsys.readouterr().out


def test_train_smoke_trace_passes_report_smoke(tmp_path, capsys):
    # train --smoke --trace: the smoke's own trace gate holds, and the trace
    # passes `report --smoke` (phase spans and convergence records)
    path = str(tmp_path / "t.jsonl")
    assert main(["train", "--smoke", "--trace", path, "--device",
                 "cpu"]) == 0
    assert "train smoke ok" in capsys.readouterr().out
    assert main(["report", "--smoke", path]) == 0
    assert "report smoke ok: 3 phases" in capsys.readouterr().out


def test_ingest_map_flags_meet_the_jax_refusal(tmp_path):
    for argv in (["--kernel", "rff", "--rff-dim", "512", "--rff-seed", "3"],
                 ["--kernel", "nystrom", "--landmarks", "128"]):
        with pytest.raises(SystemExit, match="shards store RAW features"):
            main(["ingest", "--synthetic", "rings", "--n", "64", "--out",
                  str(tmp_path / "ds"), *argv])
