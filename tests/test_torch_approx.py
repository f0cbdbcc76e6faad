"""The port's approximate-kernel families against the JAX package's, on
the CPU.

Bands:
  - map parameters (rff omega, Nystrom landmark indices and W): bit for
    bit (both draw on the host from np.random.default_rng(map_seed));
  - transforms: max |Phi_port - Phi_jax| <= 2e-6 for rff (the scaled
    cos/sin of f32 dots that differ in summation order; |Phi| <= sqrt(2/D))
    and, for Nystrom, <= 1e-6 x max(|K_nm| @ |W|), the f32 error scale of
    a product whose W (the floored inverse root) has entries of ~40;
  - kernel_approx_error falls with D (512 < 1024 < 2048 within 5% slack,
    benchmarks/approx_scale.py's gate) and is the JAX package's within
    1e-5;
  - approximate fits (binary blocked and pair, one-vs-rest pair, blocked
    and fleet, epsilon-SVR): the JAX package's status, and its SV-ID set
    but for ids whose |coefficient| is at most 1e-6 C on the side that
    has them, at most max(2, |SV|/25) of them (the solver ladder's flip
    gate); b within 2e-4 (every head), decision scores within 5e-4.
    Both packages solve over their own mapped rows, which differ by the
    transform band above, so a dual at the 1e-8 SV threshold may flip and
    b moves by up to twice the exact families' 1e-4 cross-engine band;
  - artifacts: an rff or Nystrom model saved by either package loads in
    the other and scores within 5e-4 of the saver's scores.
"""

import numpy as np
import pytest
import torch

from tpusvm.approx import features as jfeat
from tpusvm.config import SVMConfig as JConfig
from tpusvm.models import BinarySVC as JSVC
from tpusvm.models import EpsilonSVR as JSVR
from tpusvm.models import OneVsRestSVC as JOvR
from tpusvm_torch.approx import features as tfeat
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data import (MinMaxScaler, mnist_like, mnist_like_multiclass,
                               rings, svr_sine)
from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC, load_any
from tpusvm_torch.status import Status


def _same_svs(ids_t, coef_t, ids_j, coef_j, C):
    """SV-ID sets equal but for ids whose |coefficient| is <= 1e-6 C on
    the side that has them (the band in the docstring)."""
    t = dict(zip(np.asarray(ids_t).tolist(), np.abs(np.asarray(coef_t))))
    j = dict(zip(np.asarray(ids_j).tolist(), np.abs(np.asarray(coef_j))))
    odd = {i: t.get(i, j.get(i)) for i in set(t) ^ set(j)}
    assert all(c <= 1e-6 * C for c in odd.values()), odd
    # and no more of them than the solver ladder's flip gate allows
    assert len(odd) <= max(2, max(len(t), len(j)) / 25), odd



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU runs of the solvers' small per-step ops on one intra-op
    thread: under a parallel test run, torch's thread pool contending
    with the other workers' made the pair solves here ~60x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("d,D,gamma,seed", [(3, 128, 5.0, 0), (16, 512, 0.06, 7),
                                            (784, 256, 0.00125, 587)])
def test_rff_omega_is_the_jax_packages(d, D, gamma, seed):
    _bits_equal(tfeat.rff_omega(d, D, gamma, seed),
                jfeat.rff_omega(d, D, gamma, seed))


@pytest.mark.parametrize("n,k,seed", [(300, 128, 0), (1000, 256, 3), (256, 256, 9)])
def test_nystrom_landmarks_and_weights_are_the_jax_packages(n, k, seed):
    idx = tfeat.nystrom_landmark_indices(n, k, seed)
    _bits_equal(idx, jfeat.nystrom_landmark_indices(n, k, seed))
    X, _ = mnist_like(n=n, d=12, noise=3.0, seed=seed)
    L = MinMaxScaler().fit_transform(X)[idx].astype(np.float32)
    _bits_equal(tfeat.nystrom_weights(L, 0.2), jfeat.nystrom_weights(L, 0.2))
    with pytest.raises(ValueError, match="landmarks <= n"):
        tfeat.nystrom_landmark_indices(10, 11, 0)


def _scaled(n=400, d=16, seed=0):
    X, Y = mnist_like(n=n, d=d, noise=3.0, label_noise=0.01, seed=seed)
    return MinMaxScaler().fit_transform(X), Y.astype(np.int32)


@pytest.mark.parametrize("family", ["rff", "nystrom"])
def test_transforms_match_jax(family):
    Xs, _ = _scaled()
    kw = dict(rff_dim=1024) if family == "rff" else dict(landmarks=128)
    cfg, jcfg = (SVMConfig(kernel=family, gamma=0.06, map_seed=5, **kw),
                 JConfig(kernel=family, gamma=0.06, map_seed=5, **kw))
    tm = tfeat.build_map(cfg, X_scaled=Xs)
    jm = jfeat.build_map(jcfg, X_scaled=Xs)
    for a, b in zip(tm.arrays, jm.arrays):
        _bits_equal(a, b)
    got = tm.transform_np(Xs, device="cpu")
    want = np.asarray(jm.transform_np(Xs))
    assert got.shape == want.shape == (len(Xs), tm.dim)
    err = float(np.abs(got - want).max())
    if family == "rff":
        assert err <= 2e-6, err
    else:
        L, W = (a.astype(np.float64) for a in tm.arrays[:2])
        K = np.exp(-0.06 * ((Xs[:, None, :] - L[None]) ** 2).sum(-1))
        assert err <= 1e-6 * float((np.abs(K) @ np.abs(W)).max()), err
    # state round trip: the rebuilt map gives the same features
    again = tfeat.map_from_state(
        {k: np.asarray(v) for k, v in tm.state_entries().items()}, cfg)
    _bits_equal(again.transform_np(Xs, device="cpu"), got)


def test_kernel_approx_error_falls_with_d():
    Xs, _ = _scaled(n=300)
    errs = []
    for D in (512, 1024, 2048):
        cfg = SVMConfig(kernel="rff", gamma=0.06, rff_dim=D)
        e = tfeat.kernel_approx_error(Xs, tfeat.build_map(cfg, X_scaled=Xs),
                                      0.06, n_pairs=512, device="cpu")
        je = jfeat.kernel_approx_error(
            Xs, jfeat.build_map(JConfig(kernel="rff", gamma=0.06, rff_dim=D),
                                X_scaled=Xs), 0.06, n_pairs=512)
        assert abs(e - je) <= 1e-5, (D, e, je)
        errs.append(e)
    assert errs[1] <= 1.05 * errs[0] and errs[2] <= 1.05 * errs[1], errs


_BINARY = [("rff", "blocked"), ("nystrom", "blocked"), ("rff", "pair"),
           ("nystrom", "pair")]


@pytest.mark.parametrize("family,solver", _BINARY)
def test_binary_approx_fit_matches_jax(family, solver):
    X, Y = rings(n=400, seed=0)
    kw = dict(C=1.0, gamma=5.0, kernel=family, map_seed=2,
              **(dict(rff_dim=256) if family == "rff" else dict(landmarks=128)))
    opts = dict(q=128) if solver == "blocked" else {}
    t = BinarySVC(SVMConfig(**kw), solver=solver, solver_opts=opts,
                  device="cpu").fit(X, Y)
    j = JSVC(JConfig(**kw), solver=solver, solver_opts=opts).fit(X, Y)
    assert t.status_ == j.status_ == Status.CONVERGED
    _same_svs(t.sv_ids_, t.sv_alpha_, j.sv_ids_, j.sv_alpha_, 1.0)
    assert abs(t.b_ - j.b_) <= 2e-4
    assert t.sv_X_.shape[1] == t.fmap_.dim and t.n_features_in_ == 2
    np.testing.assert_allclose(t.decision_function(X[:80]),
                               j.decision_function(X[:80]), rtol=0, atol=5e-4)


# the lockstep pair heads step one pair an iteration: fewer rows keep the
# CPU run short
@pytest.mark.parametrize("solver,n", [("pair", 120), ("blocked", 360),
                                      ("fleet", 360)])
def test_ovr_approx_fit_matches_jax(solver, n):
    X, labels = mnist_like_multiclass(n=n, d=12, noise=3.0, seed=4)
    kw = dict(C=1.0, gamma=0.1, kernel="rff", rff_dim=256, map_seed=1)
    opts = dict(q=128) if solver != "pair" else {}
    t = OneVsRestSVC(SVMConfig(**kw), solver=solver, solver_opts=opts,
                     device="cpu").fit(X, labels)
    j = JOvR(JConfig(**kw), solver=solver, solver_opts=opts).fit(X, labels)
    assert [int(s) for s in t.statuses_] == [int(s) for s in j.statuses_]
    jc = np.asarray(j.coef_)
    _same_svs(t.sv_ids_, np.abs(t.coef_).max(axis=0), np.asarray(j.sv_ids_),
              np.abs(jc).max(axis=0), 1.0)
    np.testing.assert_allclose(t.b_, np.asarray(j.b_), rtol=0, atol=2e-4)
    np.testing.assert_allclose(t.decision_function(X[:60]),
                               j.decision_function(X[:60]), rtol=0, atol=5e-4)
    assert t.score(X, labels) == pytest.approx(j.score(X, labels), abs=0.01)


def test_svr_approx_fit_matches_jax():
    X, t_ = svr_sine(n=300, d=1, noise=0.05, seed=3)
    kw = dict(C=10.0, gamma=20.0, epsilon=0.1, kernel="nystrom", landmarks=128)
    t = EpsilonSVR(SVMConfig(**kw), solver_opts=dict(q=128),
                   device="cpu").fit(X, t_)
    j = JSVR(JConfig(**kw), solver_opts=dict(q=128)).fit(X, t_)
    assert t.status_ == j.status_ == Status.CONVERGED
    _same_svs(t.sv_ids_, t.sv_coef_, j.sv_ids_, j.sv_coef_, 10.0)
    assert abs(t.b_ - j.b_) <= 2e-4
    np.testing.assert_allclose(t.predict(X[:50]), j.predict(X[:50]), rtol=0,
                               atol=5e-4)
    assert t.score(X, t_) > 0.9


def test_fit_cascade_over_mapped_rows():
    X, Y = rings(n=320, seed=13)
    from tpusvm_torch.config import CascadeConfig

    cfg = SVMConfig(C=10.0, gamma=10.0, kernel="rff", rff_dim=256)
    m = BinarySVC(cfg, device="cpu").fit_cascade(
        X, Y, CascadeConfig(n_shards=2, sv_capacity=256, topology="star"))
    direct = BinarySVC(cfg, solver="pair", device="cpu").fit(X, Y)
    assert m.status_ == Status.CONVERGED and m.sv_X_.shape[1] == 256
    assert m.score(X, Y) == pytest.approx(direct.score(X, Y), abs=0.02)


@pytest.mark.parametrize("family", ["rff", "nystrom"])
@pytest.mark.parametrize("saver", ["port", "jax"])
def test_artifacts_cross_between_packages(tmp_path, family, saver):
    X, Y = rings(n=300, seed=1)
    kw = dict(C=1.0, gamma=5.0, kernel=family, map_seed=3,
              **(dict(rff_dim=256) if family == "rff" else dict(landmarks=128)))
    path = str(tmp_path / "m.npz")
    if saver == "port":
        m = BinarySVC(SVMConfig(**kw), solver_opts=dict(q=128),
                      device="cpu").fit(X, Y)
        m.save(path)
        other = JSVC.load(path)
    else:
        m = JSVC(JConfig(**kw), solver_opts=dict(q=128)).fit(X, Y)
        m.save(path)
        other = load_any(path, device="cpu")
    assert other.config.kernel == family
    assert other.fmap_.n_features_in == 2
    for a, b in zip(other.fmap_.arrays, m.fmap_.arrays):
        _bits_equal(a, b)
    np.testing.assert_allclose(other.decision_function(X),
                               m.decision_function(X), rtol=0, atol=5e-4)
    assert np.mean(other.predict(X) == m.predict(X)) >= 0.99
    # the port reloads its own artifact with the same bits
    if saver == "port":
        again = BinarySVC.load(path, device="cpu")
        _bits_equal(again.decision_function(X), m.decision_function(X))


def test_ovr_artifact_crosses(tmp_path):
    X, labels = mnist_like_multiclass(n=240, d=8, noise=3.0, seed=2)
    cfg = SVMConfig(C=1.0, gamma=0.1, kernel="nystrom", landmarks=128)
    m = OneVsRestSVC(cfg, solver="blocked", solver_opts=dict(q=128),
                     device="cpu").fit(X, labels)
    path = str(tmp_path / "o.npz")
    m.save(path)
    j = JOvR.load(path)
    np.testing.assert_allclose(np.asarray(j.decision_function(X)),
                               m.decision_function(X), rtol=0, atol=5e-4)
    t = OneVsRestSVC.load(path, device="cpu")
    _bits_equal(t.decision_function(X), m.decision_function(X))


def test_map_refusals():
    with pytest.raises(ValueError, match="not an approximate family"):
        tfeat.build_map(SVMConfig(kernel="rbf"), n_features=3)
    with pytest.raises(ValueError, match="pass X_scaled or n_features"):
        tfeat.build_map(SVMConfig(kernel="rff"))
    cfg = SVMConfig(kernel="nystrom", landmarks=128)
    with pytest.raises(ValueError, match="landmarks=128"):
        tfeat.build_map(cfg, landmark_rows=np.zeros((5, 3)))
    m = tfeat.build_map(SVMConfig(kernel="rff", rff_dim=128), n_features=3)
    with pytest.raises(ValueError, match="expects 3 features"):
        m.transform(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="multiple of 128"):
        tfeat.rff_omega(3, 100, 1.0, 0)
