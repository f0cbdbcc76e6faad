"""The port's Platt calibration (BinarySVC.calibrate / predict_proba)
against the JAX package's, on the CPU.

Both fit the same stratified folds (tune/folds.py, bit for bit) and the
same Newton fit (kernels/platt.py, bit for bit); the fold models' scores
differ by solver rounding only, so |dA| and |dB| <= 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import synthetic as jsyn
from tpusvm.models import BinarySVC as JBinarySVC
from tpusvm_torch.config import SVMConfig
from tpusvm_torch.models import BinarySVC

CFG = dict(C=1.0, gamma=5.0)
OPTS = dict(q=128, max_inner=256)


@pytest.fixture(scope="module")
def data():
    X, Y = jsyn.rings(n=400, seed=3, noise=0.35)
    return X[:300], Y[:300], X[300:], Y[300:]


@pytest.mark.parametrize("solver", ["blocked", "pair"])
def test_calibrate_matches_jax(data, solver):
    X, Y, Xt, _ = data
    opts = OPTS if solver == "blocked" else {}
    tm = BinarySVC(SVMConfig(**CFG), solver=solver, solver_opts=opts,
                   device="cpu").fit(X, Y).calibrate(X, Y, folds=3, seed=2)
    jm = JBinarySVC(JConfig(**CFG), solver=solver, solver_opts=opts,
                    dtype=jnp.float32).fit(X, Y)
    jm.calibrate(X, Y, folds=3, seed=2)
    (ta, tb), (ja, jb) = tm.platt_, jm.platt_
    assert abs(ta - ja) <= 1e-3 and abs(tb - jb) <= 1e-3
    assert ta < 0
    np.testing.assert_allclose(tm.predict_proba(Xt), jm.predict_proba(Xt),
                               atol=1e-3)


def test_predict_proba_is_monotone_and_sums_to_one(data):
    X, Y, Xt, Yt = data
    m = BinarySVC(SVMConfig(**CFG), solver_opts=OPTS, device="cpu").fit(X, Y)
    with pytest.raises(RuntimeError, match="not calibrated"):
        m.predict_proba(Xt)
    m.calibrate(X, Y, folds=3)
    p = m.predict_proba(Xt)
    assert p.shape == (len(Xt), 2)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-12)
    order = np.argsort(m.decision_function(Xt), kind="stable")
    assert np.all(np.diff(p[order, 1]) >= 0)
    # better than the prior on held-out rows
    from tpusvm_torch.kernels.platt import log_loss

    prior = np.full(len(Yt), (Y > 0).mean())
    assert log_loss(p[:, 1], Yt) < log_loss(prior, Yt)
