"""The port's epsilon-SVR against the JAX package's EpsilonSVR on
svr_sine, on the CPU (the tests/test_svr.py configuration: C=10,
gamma=20, epsilon=0.1).

Band: the same status; the SV sets (rows with |alpha - alpha*| > sv_tol)
within max(2, n_sv // 25); held-out predictions within 1e-3 of the JAX
model's (both solve to tau = 1e-5 from f32 features; the regressed values
move with b and the coefficients, a few 1e-5 apart).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import synthetic as jsyn
from tpusvm.models import EpsilonSVR as JSVR
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.models import EpsilonSVR
from tpusvm_torch.status import Status

CFG = dict(C=10.0, gamma=20.0, epsilon=0.1)


@pytest.fixture(scope="module")
def data():
    X, t = jsyn.svr_sine(n=300, d=1, noise=0.05, seed=587)
    return X[:240], t[:240], X[240:], t[240:]


@pytest.mark.parametrize("solver", ["blocked", "pair"])
def test_svr_matches_jax(data, solver):
    X, t, Xt, tt = data
    opts = dict(q=128, max_inner=256) if solver == "blocked" else {}
    tm = EpsilonSVR(SVMConfig(**CFG), solver=solver, solver_opts=opts,
                    device="cpu").fit(X, t)
    jm = JSVR(JConfig(**CFG), solver=solver, solver_opts=opts,
              dtype=jnp.float32).fit(X, t)
    assert tm.status_ == jm.status_ == Status.CONVERGED
    sj = set(jm.sv_ids_.tolist())
    assert len(set(tm.sv_ids_.tolist()) ^ sj) <= max(2, len(sj) // 25)
    np.testing.assert_allclose(tm.predict(Xt), jm.predict(Xt), atol=1e-3)
    assert tm.score(Xt, tt) > 0.9
    assert abs(tm.score(Xt, tt) - jm.score(Xt, tt)) < 1e-3


def test_svr_pair_and_blocked_agree(data):
    X, t, Xt, _ = data
    cfg = SVMConfig(**CFG)
    mp = EpsilonSVR(cfg, solver="pair", device="cpu").fit(X, t)
    mb = EpsilonSVR(cfg, solver="blocked", device="cpu",
                    solver_opts=dict(q=128, max_inner=256)).fit(X, t)
    np.testing.assert_allclose(mp.predict(Xt), mb.predict(Xt), atol=1e-3)
    assert mp.result_.n_iter == mp.n_iter_ and mp.result_.row_refreshes > 0


@pytest.mark.parametrize("solver", ["blocked", "pair"])
def test_svr_duplicate_rows_do_not_stall(solver):
    # the doubling puts every row twice with opposite labels and eta = 0
    # between the twins; that pair is never violating, so the solve must
    # end CONVERGED (tests/test_svr.py:92)
    X, t = jsyn.svr_sine(n=120, d=1, noise=0.0, seed=7)
    model = EpsilonSVR(SVMConfig(**CFG), solver=solver, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        model.fit(X, t)
    assert model.status_ == Status.CONVERGED


def test_svr_refusals():
    X, t = jsyn.svr_sine(n=40, d=1, seed=1)
    # shrinking is ported for the blocked solver (ROADMAP Queue 1 item 7);
    # the pair solver refuses it, as in the JAX estimator
    with pytest.raises(ValueError, match="pair solver"):
        EpsilonSVR(device="cpu", solver="pair",
                   solver_opts=dict(shrink_every=4)).fit(X, t)
    with pytest.raises(ValueError, match="unknown solver"):
        EpsilonSVR(solver="fleet", device="cpu")
