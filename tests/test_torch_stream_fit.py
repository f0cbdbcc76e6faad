"""The port's streamed fits and streamed scoring, on the CPU.

Bands:
  - fit_stream equals the port's own fit on the concatenated rows bit for
    bit (alpha bytes, SV IDs, b, updates, rounds): the manifest scaler has
    the whole-array bits and the scaled shards are concatenated before
    one copy to the device;
  - against the JAX package's fit_stream on the same dataset: the same
    SV-ID set and status, b within the cross-engine 1e-4 band (the port's
    loop engine against JAX's XLA engine, as tests/test_torch_blocked.py
    pairs them);
  - fit_cascade_stream equals the port's fit_cascade bit for bit, and the
    JAX package's fit_cascade_stream within tests/test_torch_cascade.py's
    band (SV-ID set, rounds within 1, b within 1e-4);
  - predict_stream scores equal decision_function's on the same batches
    bit for bit, and its whole-array call's within 1e-5 x sum(alpha)
    (the blocking of the f32 contraction), evaluate_stream's accuracy
    equal to score();
  - the command line: ingest, train --data, predict --data and info DIR
    in subprocesses print the in-process bits.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpusvm import stream as jstream
from tpusvm.config import CascadeConfig as JCascadeConfig
from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JSVC
from tpusvm_torch import stream
from tpusvm_torch.config import CascadeConfig, SVMConfig
from tpusvm_torch.data import mnist_like, rings, write_csv
from tpusvm_torch.models import BinarySVC
from tpusvm_torch.status import Status

REPO = Path(__file__).resolve().parents[1]


_SETS = {
    "rings": (lambda: rings(n=500, seed=2), 1.0, 5.0),
    "mnist_like": (lambda: mnist_like(n=600, d=24, noise=3.0,
                                      label_noise=0.01, seed=5), 10.0, 0.05),
}


def _dataset(tmp_path, name, writer=stream, rows_per_shard=128):
    make, C, gamma = _SETS[name]
    X, Y = make()
    d = str(tmp_path / name)
    writer.ingest_arrays(d, X, Y.astype(np.int32),
                         rows_per_shard=rows_per_shard)
    return X, Y.astype(np.int32), d, C, gamma


def _bits(a):
    a = np.asarray(a)
    return a.tobytes(), a.dtype, a.shape


def _same_model(a, b):
    for k in ("sv_ids_", "sv_alpha_", "sv_X_", "sv_Y_"):
        assert _bits(getattr(a, k)) == _bits(getattr(b, k)), k
    assert a.b_ == b.b_ and a.n_iter_ == b.n_iter_ and a.status_ == b.status_


@pytest.fixture
def one_torch_thread():
    """The solvers' small per-step ops on one intra-op thread: under a
    parallel test run, torch's thread pool contending with the other
    workers' made the pair fits here about ten times slower. Only for
    tests whose bit comparisons are between fits of this process (the CLI
    case compares a subprocess's bits, at the default count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("solver,opts", [
    ("blocked", dict(q=128, inner="loop")),
    ("blocked", dict(q=128, inner="kernel", wss=2)),
    ("pair", {})])
@pytest.mark.parametrize("name", list(_SETS))
def test_fit_stream_equals_fit_bit_for_bit(tmp_path, name, solver, opts):
    X, Y, d, C, gamma = _dataset(tmp_path, name)
    cfg = SVMConfig(C=C, gamma=gamma, max_iter=10**6)
    kw = dict(solver=solver, solver_opts=opts, device="cpu")
    streamed = BinarySVC(cfg, **kw).fit_stream(stream.open_dataset(d))
    direct = BinarySVC(cfg, **kw).fit(X, Y)
    _same_model(streamed, direct)
    assert streamed.status_ == Status.CONVERGED
    for k in ("min_val", "max_val"):
        assert _bits(getattr(streamed.scaler_, k)) == \
            _bits(getattr(direct.scaler_, k))
    if solver == "blocked":
        assert streamed.result_.n_outer == direct.result_.n_outer
    # a dataset the JAX package wrote gives the same bits
    os.rename(d, d + ".port")
    jstream.ingest_arrays(d, X, Y, rows_per_shard=128)
    _same_model(BinarySVC(cfg, **kw).fit_stream(stream.open_dataset(d)),
                direct)


@pytest.mark.parametrize("name", list(_SETS))
def test_fit_stream_matches_jax(tmp_path, name):
    X, Y, d, C, gamma = _dataset(tmp_path, name)
    opts = dict(q=128, max_inner=256)
    t = BinarySVC(SVMConfig(C=C, gamma=gamma, max_iter=10**6),
                  solver_opts=dict(opts, inner="loop"),
                  device="cpu").fit_stream(stream.open_dataset(d))
    j = JSVC(JConfig(C=C, gamma=gamma, max_iter=10**6),
             solver_opts=dict(opts, inner="xla")).fit_stream(
                 jstream.open_dataset(d))
    assert t.status_ == j.status_ == Status.CONVERGED
    assert set(t.sv_ids_.tolist()) == set(j.sv_ids_.tolist())
    assert abs(t.b_ - j.b_) <= 1e-4
    assert _bits(t.scaler_.min_val) == _bits(j.scaler_.min_val)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("topology,stratified", [("tree", False),
                                                 ("star", False),
                                                 ("star", True)])
def test_fit_cascade_stream_equals_fit_cascade(tmp_path, topology, stratified):
    X, Y = rings(n=320, seed=13)
    Y = Y.astype(np.int32)
    if stratified:
        order = np.argsort(Y, kind="stable")
        X, Y = X[order], Y[order]
    d = str(tmp_path / "d")
    stream.ingest_arrays(d, X, Y, rows_per_shard=70)
    cfg = SVMConfig(C=10.0, gamma=10.0)
    cc = CascadeConfig(n_shards=2, sv_capacity=256, topology=topology)
    kw = dict(solver="pair", device="cpu")
    s = BinarySVC(cfg, **kw).fit_cascade_stream(stream.open_dataset(d), cc,
                                                stratified=stratified)
    m = BinarySVC(cfg, **kw).fit_cascade(X, Y, cc, stratified=stratified)
    for k in ("sv_ids_", "sv_alpha_", "sv_X_", "sv_Y_"):
        assert _bits(getattr(s, k)) == _bits(getattr(m, k)), k
    assert s.b_ == m.b_ and s.cascade_rounds_ == m.cascade_rounds_
    assert s.status_ == Status.CONVERGED
    j = JSVC(JConfig(C=10.0, gamma=10.0), solver="pair").fit_cascade_stream(
        jstream.open_dataset(d),
        JCascadeConfig(n_shards=2, sv_capacity=256, topology=topology),
        stratified=stratified)
    assert set(s.sv_ids_.tolist()) == set(j.sv_ids_.tolist())
    assert abs(s.cascade_rounds_ - j.cascade_rounds_) <= 1
    assert abs(s.b_ - j.b_) <= 1e-4


def test_stream_scoring_matches_decision_function(tmp_path):
    X, Y, d, C, gamma = _dataset(tmp_path, "mnist_like", rows_per_shard=97)
    m = BinarySVC(SVMConfig(C=C, gamma=gamma, max_iter=10**6),
                  solver_opts=dict(q=128), device="cpu").fit(X, Y)
    ds = stream.open_dataset(d)
    parts = list(stream.predict_stream(m, ds, batch_size=64))
    assert [len(s) for s, _ in parts][:-1] == [64] * (len(parts) - 1)
    # each batch's scores are decision_function's on those rows, bit for
    # bit; against one call on all rows only the contraction's blocking
    # differs (f32 sums over the SVs in another order)
    for i, (s, _) in enumerate(parts):
        assert s.tobytes() == m.decision_function(
            X[64 * i:64 * i + len(s)]).tobytes()
    scores = np.concatenate([s for s, _ in parts])
    tol = 1e-5 * float(np.abs(m.sv_alpha_).sum())
    np.testing.assert_allclose(scores, m.decision_function(X), rtol=0,
                               atol=tol)
    assert np.array_equal(np.concatenate([y for _, y in parts]), Y)
    acc, n = stream.evaluate_stream(m, ds, batch_size=64)
    assert n == len(X) and acc == m.score(X, Y)
    acc_lim, n_lim = stream.evaluate_stream(m, ds, batch_size=64, n_limit=150)
    assert n_lim == 150 and acc_lim == m.score(X[:150], Y[:150])


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "tpusvm_torch", *args],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def _line(pattern, text):
    m = re.search(pattern, text, re.M)
    assert m, (pattern, text)
    return m.group(1)


def test_cli_ingest_train_predict_info(tmp_path):
    X, Y = mnist_like(n=700, d=20, noise=3.0, label_noise=0.01, seed=8)
    labels = np.where(Y > 0, 1, 4)
    write_csv(str(tmp_path / "a.csv"), X[:500], labels[:500])
    write_csv(str(tmp_path / "b.csv"), X[500:], labels[500:])
    for src, out in (("a.csv", "train"), ("b.csv", "test")):
        r = _cli("ingest", "--train", src, "--out", out, "--rows-per-shard",
                 "128", cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert f"into {4 if out == 'train' else 2} shards" in r.stdout
    r = _cli("train", "--data", "train", "--test", "b.csv", "--C", "10",
             "--gamma", "0.05", "--q", "128", "--device", "cpu", "--save",
             "m.npz", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    Xtr, Ytr = stream.open_dataset(str(tmp_path / "train")).load_arrays()
    m = BinarySVC(SVMConfig(C=10.0, gamma=0.05), solver_opts=dict(
        q=128, wss=1, max_inner=1024), device="cpu").fit(Xtr, Ytr)
    assert int(_line(r"^SV count = (\d+)", r.stdout)) == m.n_support_
    assert _line(r"^b = (\S+)", r.stdout) == f"{m.b_:.15f}"
    assert int(_line(r"^iterations = (\d+)", r.stdout)) == m.n_iter_
    Xte, Yte = stream.open_dataset(str(tmp_path / "test")).load_arrays()
    acc = m.score(Xte, Yte)
    assert f"accuracy = {acc:.4f}" in r.stdout
    r = _cli("predict", "--model", "m.npz", "--data", "test", "--device",
             "cpu", "--batch-size", "64", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert f"accuracy = {acc:.4f} ({round(acc * 200)}/200)" in r.stdout
    r = _cli("info", "train", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "sharded dataset: 500 rows x 20 features, 4 shards" in r.stdout
    assert "validation: all 4 shards OK" in r.stdout
    # the approximate family trains out of core from the same shards
    r = _cli("train", "--data", "train", "--kernel", "rff", "--rff-dim", "256",
             "--C", "10", "--gamma", "0.05", "--solver-opt", "primal_batch=64",
             "--device", "cpu", "--save", "r.npz", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    p = BinarySVC(SVMConfig(C=10.0, gamma=0.05, kernel="rff", rff_dim=256),
                  solver_opts=dict(primal_batch=64), device="cpu").fit_stream(
                      stream.open_dataset(str(tmp_path / "train")))
    assert _line(r"^b = (\S+)", r.stdout) == f"{p.b_:.15f}"
    assert f"status = {p.status_.name}" in r.stdout
    assert "live shards <= " in r.stdout
    r = _cli("predict", "--model", "r.npz", "--data", "test", "--device",
             "cpu", cwd=tmp_path)
    acc = p.score(Xte, Yte)
    assert r.returncode == 0 and f"accuracy = {acc:.4f}" in r.stdout, r.stderr


@pytest.mark.parametrize("argv,msg", [
    (["ingest", "--synthetic", "rings", "--out", "o", "--kernel", "rff"],
     "shards store RAW features"),
    (["ingest", "--synthetic", "rings", "--out", "o", "--trace", "t.jsonl",
      "--kernel", "nystrom"], "shards store RAW features"),
    (["train", "--data", "d", "--synthetic", "rings"], "exactly one of"),
    (["train", "--data", "d", "--multiclass"], "binary training"),
    (["train", "--data", "d", "--kernel", "rff", "--mode", "cascade"],
     "not supported yet"),
    (["train", "--data", "d", "--task", "svr"], "sharded"),
    (["train", "--data", "d", "--n-limit", "5"], "does not apply"),
    (["train", "--synthetic", "rings", "--mode", "pod"], "pass --data DIR"),
])
def test_cli_stream_refusals(tmp_path, argv, msg):
    from tpusvm_torch.cli import main

    with pytest.raises(SystemExit, match=msg):
        main([*argv, "--device", "cpu"] if argv[0] == "train" else argv)
