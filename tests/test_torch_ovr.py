"""The port's one-vs-rest estimator against the JAX package's, on the CPU.

Inside the torch program the lockstep (batched) pair solve equals the
heads' sequential solves bit for bit (alpha with torch.equal, b, n_iter,
status). Across the packages the band is the cross-engine one: every
head CONVERGED in both, per-head SV sets within max(2, n_sv // 25), and
equal predictions on at least 99% of held-out rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import synthetic as jsyn
from tpusvm.models import OneVsRestSVC as JOvR
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.models import OneVsRestSVC
from tpusvm_torch.status import Status

CFG = dict(C=10.0, gamma=0.05)


@pytest.fixture(scope="module")
def data():
    X, labels = jsyn.mnist_like_multiclass(n=500, d=24, n_classes=4, seed=5,
                                           noise=20.0)
    return X[:400], labels[:400], X[400:], labels[400:]


@pytest.fixture(scope="module")
def fits(data):
    X, labels, _, _ = data
    cfg = SVMConfig(**CFG)
    out = {}
    for name, kw in (("batched", dict(solver="pair", batched=True)),
                     ("sequential", dict(solver="pair", batched=False)),
                     ("blocked", dict(solver="blocked",
                                      solver_opts=dict(q=128, max_inner=256)))):
        out[name] = OneVsRestSVC(cfg, device="cpu", **kw).fit(X, labels)
    out["jax"] = JOvR(JConfig(**CFG), dtype=jnp.float32).fit(X, labels)
    return out


def test_batched_pair_run_equals_sequential_bit_for_bit(fits):
    b, s = fits["batched"], fits["sequential"]
    assert b.results_.alpha.shape[0] == 4
    for k in range(4):
        head = b.results_.head(k)
        solo = s.results_[k]
        assert torch.equal(head.alpha, solo.alpha)
        assert (head.b, head.n_iter, head.status) == (solo.b, solo.n_iter,
                                                      solo.status)
    np.testing.assert_array_equal(b.coef_, s.coef_)
    np.testing.assert_array_equal(b.b_, s.b_)
    assert all(Status(int(v)) == Status.CONVERGED for v in b.statuses_)


def test_pair_and_blocked_predict_alike(fits, data):
    _, _, Xt, lt = data
    pp, pb = fits["batched"].predict(Xt), fits["blocked"].predict(Xt)
    assert (pp == pb).mean() >= 0.99
    assert abs(fits["blocked"].score(Xt, lt) - fits["jax"].score(Xt, lt)) <= 0.01


def test_port_matches_jax_ovr(fits, data):
    X, labels, Xt, lt = data
    t, j = fits["batched"], fits["jax"]
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_array_equal(t.statuses_, j.statuses_)
    for k in range(4):
        sv_t = set(t.sv_ids_[t.coef_[k] != 0].tolist())
        sv_j = set(j.sv_ids_[j.coef_[k] != 0].tolist())
        assert len(sv_t ^ sv_j) <= max(2, len(sv_j) // 25), k
    np.testing.assert_allclose(t.b_, j.b_, atol=1e-3)
    assert (t.predict(Xt) == j.predict(Xt)).mean() >= 0.99
    assert t.decision_function(Xt).shape == (len(Xt), 4)


def test_fleet_and_class_parallel_are_refused():
    # the fleet is ported (tests/test_torch_fleet.py); the mesh is not
    assert OneVsRestSVC(solver="fleet", device="cpu").solver == "fleet"
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        OneVsRestSVC(class_parallel=True, device="cpu")
    with pytest.raises(ValueError, match="pair|blocked"):
        OneVsRestSVC(solver="oracle", device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        OneVsRestSVC(SVMConfig(kernel="rff"), device="cpu")


def test_ovr_poly_family(data):
    X, labels, Xt, lt = data
    m = OneVsRestSVC(SVMConfig(C=1.0, gamma=1.0 / 24, kernel="poly", degree=2,
                               coef0=1.0), device="cpu").fit(X, labels)
    assert all(Status(int(v)) == Status.CONVERGED for v in m.statuses_)
    assert m.score(Xt, lt) > 0.5


def test_binary_fits_not_ported_are_refused():
    from tpusvm_torch.models import BinarySVC

    X = np.random.default_rng(0).random((20, 3))
    Y = np.tile([1, -1], 10)
    m = BinarySVC(device="cpu")
    # checkpoints and shrinking are ported (ROADMAP Queue 1 item 7): the
    # pair solver refuses them as the JAX estimator does, and one-vs-rest
    # does not route shrinking
    with pytest.raises(ValueError, match="blocked solver"):
        BinarySVC(device="cpu", solver="pair").fit(
            X, Y, checkpoint_path="ck.npz")
    with pytest.raises(ValueError, match="pair solver"):
        BinarySVC(device="cpu", solver="pair",
                  solver_opts=dict(shrink_every=8)).fit(X, Y)
    with pytest.raises(ValueError, match="binary and svr"):
        OneVsRestSVC(device="cpu", solver="blocked",
                     solver_opts=dict(shrink_every=8)).fit(X, np.arange(20) % 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        m.fit_stream(None)
    # the cascade is ported (ROADMAP Queue 1 item 9) but for its pod
    # leaves, its streaming twin (item 11) and its tracer (item 12)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        m.fit_pod(X, Y)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        m.fit_cascade_stream(X, Y)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        m.fit_cascade(X, Y, tracer=object())
    with pytest.raises(ValueError, match="unknown solver"):
        BinarySVC(solver="fleet", device="cpu")
