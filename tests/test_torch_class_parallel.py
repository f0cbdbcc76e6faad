"""The class axis over a mesh and over rank processes, and row-split
scoring, on the CPU, on tests/test_models.py's fixture
(_four_class_data(n=240, seed=5), C=10, gamma=2).

Bands: inside the port, every class_parallel head equals the same head of
the batched=True fit bit for bit (alpha with torch.equal, b, n_iter,
status) on every mesh tried, the padding's dummy heads dropped; two rank
processes of `train --multiclass --class-parallel --distributed` save
equal models (every stored array byte for byte: the zip entries carry the
write time), equal to the in-process fit's. Against the JAX package's
class_parallel fit (float64, a 3-device mesh), JAX's own band
(tests/test_models.py:337-343): |db| <= 5e-5, the same SV union, the same
predictions. Row-split scoring: predictions equal to the unsplit call and
scores within 1e-5 x sum|coef| of it (the contraction may sum in another
order on another row count).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import OneVsRestSVC as JOvR
from tpusvm.parallel.mesh import make_mesh as j_make_mesh
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.models import BinarySVC, OneVsRestSVC
from tpusvm_torch.parallel.mesh import Mesh, make_mesh, split_rows
from tpusvm_torch.status import Status

REPO = Path(__file__).resolve().parents[1]
CFG = dict(C=10.0, gamma=2.0)


def _four_class_data(n=400, seed=0):
    # tests/test_models.py's generator
    rng = np.random.default_rng(seed)
    centers = np.array([[0, 0], [6, 0], [0, 6], [6, 6]], float)
    labels = rng.integers(0, 4, n)
    X = centers[labels] + rng.normal(0, 0.8, (n, 2))
    return X, labels.astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # torch's CPU reductions depend on the thread count: the rank
    # processes run one (OMP_NUM_THREADS=1), so the in-process fits do too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    X, labels = _four_class_data(n=240, seed=5)
    Xt, lt = _four_class_data(n=100, seed=6)
    return X, labels, Xt, lt


@pytest.fixture(scope="module")
def batched(data):
    X, labels, _, _ = data
    return OneVsRestSVC(SVMConfig(**CFG), batched=True,
                        device="cpu").fit(X, labels)


def _same_heads(a, b, K):
    for k in range(K):
        ha, hb = a.results_.head(k), b.results_.head(k)
        assert torch.equal(ha.alpha, hb.alpha), k
        assert (ha.b, ha.n_iter, ha.status) == (hb.b, hb.n_iter, hb.status)


@pytest.mark.parametrize("members", [3, 1, 2, 4, 5])
def test_class_parallel_heads_equal_batched_bit_for_bit(data, batched,
                                                        members):
    # K=4 over 3 members pads to 6 (two dummies), over 5 to 5 (one)
    X, labels, _, _ = data
    mesh = ["cpu"] * members
    m = OneVsRestSVC(SVMConfig(**CFG), class_parallel=True, mesh=mesh,
                     device="cpu").fit(X, labels)
    assert m.coef_.shape[0] == 4 and m.results_.alpha.shape[0] == 4
    _same_heads(m, batched, 4)
    np.testing.assert_array_equal(m.coef_, batched.coef_)
    np.testing.assert_array_equal(m.b_, batched.b_)
    np.testing.assert_array_equal(m.sv_ids_, batched.sv_ids_)
    assert (m.statuses_ == Status.CONVERGED).all()
    assert m.class_mesh_ == {"axes": ("classes",),
                             "shape": {"classes": members}, "processes": 1,
                             "devices": ["cpu"] * members}


def test_default_mesh_on_the_cpu_is_one_member(data, batched):
    X, labels, _, _ = data
    m = OneVsRestSVC(SVMConfig(**CFG), class_parallel=True,
                     device="cpu").fit(X, labels)
    assert m.class_mesh_["devices"] == ["cpu"]
    _same_heads(m, batched, 4)


def test_class_parallel_against_jax(data):
    X, labels, Xt, lt = data
    jm = JOvR(JConfig(**CFG), dtype=jnp.float64, class_parallel=True,
              mesh=j_make_mesh(3, devices=jax.devices()[:3],
                               axis="classes")).fit(X, labels)
    tm = OneVsRestSVC(SVMConfig(**CFG), class_parallel=True,
                      mesh=Mesh((torch.device("cpu"),) * 3, ("classes",)),
                      dtype=torch.float64, device="cpu").fit(X, labels)
    assert (tm.statuses_ == Status.CONVERGED).all()
    assert (np.asarray(jm.statuses_) == Status.CONVERGED).all()
    assert tm.coef_.shape[0] == 4
    np.testing.assert_allclose(tm.b_, jm.b_, atol=5e-5)
    assert set(tm.sv_ids_.tolist()) == set(np.asarray(jm.sv_ids_).tolist())
    np.testing.assert_array_equal(tm.predict(Xt), jm.predict(Xt))
    assert tm.class_mesh_["shape"] == dict(jm.class_mesh_["shape"])


def test_refusals_carry_the_jax_texts():
    from tpusvm_torch.cli import main

    want = ("class_parallel=True requires solver='pair' (the vmapped "
            "lockstep solver BASELINE config 5 names)")
    for solver in ("blocked", "fleet"):
        with pytest.raises(ValueError) as t_err:
            OneVsRestSVC(solver=solver, class_parallel=True, device="cpu")
        with pytest.raises(ValueError) as j_err:
            JOvR(JConfig(), solver=solver, class_parallel=True)
        assert str(t_err.value) == str(j_err.value)
        assert want in str(t_err.value)
    with pytest.raises(SystemExit, match=r"^--class-parallel requires "
                       r"--multiclass \(it shards the one-vs-rest class "
                       r"axis\)$"):
        main(["train", "--synthetic", "rings", "--class-parallel",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="--class-parallel shards the vmapped "
                       "pair solver over the mesh; --solver blocked trains "
                       "classes sequentially"):
        main(["train", "--synthetic", "mnist_like_multiclass", "--multiclass",
              "--class-parallel", "--solver", "blocked", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--class-parallel shards"):
        main(["train", "--synthetic", "mnist_like_multiclass", "--multiclass",
              "--class-parallel", "--fleet", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs class_parallel=True"):
        OneVsRestSVC(device="cpu").fit(np.zeros((4, 2)), np.arange(4),
                                       group=object())


def test_split_rows_and_make_mesh():
    X = np.arange(20.0).reshape(10, 2)
    parts = split_rows(["cpu"] * 3, X)
    assert [len(p) for p in parts] == [3, 3, 4]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), X)
    assert [len(p) for p in split_rows(["cpu"] * 4, X[:2])] == [0, 1, 0, 1]
    mesh = make_mesh(2, devices=["cpu"] * 3)
    assert mesh.size == 2 and mesh.shape == {"cascade": 2}
    with pytest.raises(ValueError, match="only 3 devices"):
        make_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            make_mesh()


def _band(split, full, coef):
    assert np.abs(split - full).max() <= 1e-5 * np.abs(coef).sum()


def test_row_split_scoring_matches_the_unsplit_call(data, batched):
    X, labels, Xt, lt = data
    mesh = ["cpu"] * 3
    full = batched.decision_function(Xt)
    split = batched.decision_function(Xt, mesh=mesh)
    assert split.shape == full.shape == (100, 4)
    _band(split, full, batched.coef_)
    np.testing.assert_array_equal(batched.predict(Xt, mesh=mesh),
                                  batched.predict(Xt))
    assert batched.score(Xt, lt, mesh=mesh) == batched.score(Xt, lt)

    Y = np.where(labels == 1, 1, -1)
    m = BinarySVC(SVMConfig(**CFG), device="cpu").fit(X, Y)
    m.calibrate(X, Y, folds=2)
    coef = m.sv_alpha_ * m.sv_Y_
    _band(m.decision_function(Xt, mesh=mesh), m.decision_function(Xt), coef)
    np.testing.assert_array_equal(m.predict(Xt, mesh=mesh), m.predict(Xt))
    np.testing.assert_allclose(m.predict_proba(Xt, mesh=mesh),
                               m.predict_proba(Xt), atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_processes_save_the_in_process_model(tmp_path, data):
    from tpusvm_torch.data import write_csv
    from tpusvm_torch.models.serialization import load_model

    X, labels, Xt, lt = data
    write_csv(str(tmp_path / "a.csv"), X, labels)
    write_csv(str(tmp_path / "b.csv"), Xt, lt)
    flags = ["-m", "tpusvm_torch", "train", "--train", "a.csv", "--test",
             "b.csv", "--C", "10", "--gamma", "2", "--multiclass",
             "--class-parallel", "--distributed", "--coordinator-address",
             f"file://{tmp_path / 'store'}", "--num-processes", "2",
             "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        with open(tmp_path / f"r{r}.out", "w") as o, \
                open(tmp_path / f"r{r}.err", "w") as e:
            procs.append(subprocess.Popen(
                [sys.executable, *flags, "--process-id", str(r), "--save",
                 f"m{r}.npz"], cwd=tmp_path, env=env, stdout=o, stderr=e))
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [(tmp_path / f"r{r}.err").read_text() for r in range(2)]
    assert rcs == [0, 0], errs
    out0 = (tmp_path / "r0.out").read_text()
    assert "status = ['CONVERGED', 'CONVERGED', 'CONVERGED', 'CONVERGED']" \
        in out0
    assert not (tmp_path / "r1.out").read_text().strip()

    ref = OneVsRestSVC(SVMConfig(**CFG), class_parallel=True,
                       device="cpu").fit(X, labels)
    ref.save(str(tmp_path / "ref.npz"))
    states = [load_model(str(tmp_path / n))[0]
              for n in ("m0.npz", "m1.npz", "ref.npz")]
    for s in states[1:]:
        assert sorted(s) == sorted(states[0])
        for k in s:
            assert s[k].dtype == states[0][k].dtype, k
            assert s[k].tobytes() == states[0][k].tobytes(), k
