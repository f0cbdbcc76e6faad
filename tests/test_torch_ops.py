"""tpusvm_torch compute primitives against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.ops import rbf as jrbf
from tpusvm.ops import selection as jsel
from tpusvm.solver.analytic import pair_update as j_pair_update
from tpusvm_torch.ops import rbf as trbf
from tpusvm_torch.ops import selection as tsel
from tpusvm_torch.solver.analytic import pair_update as t_pair_update


def _xy(n=97, m=41, d=13, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)).astype(np.float32),
            rng.random((m, d)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def test_sq_norms_matches_jax():
    X, _, _ = _xy()
    got = trbf.sq_norms(torch.tensor(X)).numpy()
    want = np.asarray(jrbf.sq_norms(jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("gamma", [0.5, 3.0])
def test_rbf_cross_matches_jax(gamma):
    XA, XB, _ = _xy()
    got = trbf.rbf_cross(torch.tensor(XA), torch.tensor(XB), gamma).numpy()
    want = np.asarray(jrbf.rbf_cross(jnp.asarray(XA), jnp.asarray(XB), gamma))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("block", [8192, 32])
def test_rbf_cross_matvec_matches_jax(block):
    X, XB, coef = _xy(n=300)
    got = trbf.rbf_cross_matvec(torch.tensor(X), torch.tensor(XB),
                                torch.tensor(coef), 0.7, block=block).numpy()
    want = np.asarray(jrbf.rbf_cross_matvec(
        jnp.asarray(X), jnp.asarray(XB), jnp.asarray(coef), 0.7))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(coef).sum())


def test_coef_matvec_matches_jax():
    _, XB, coef = _xy()
    K = np.random.default_rng(1).random((29, XB.shape[0])).astype(np.float32)
    got = trbf.coef_matvec(torch.tensor(K), torch.tensor(coef)).numpy()
    want = np.asarray(jrbf.coef_matvec(jnp.asarray(K), jnp.asarray(coef)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_masks_match_jax_exactly():
    rng = np.random.default_rng(2)
    n, C, eps = 400, 10.0, 1e-12
    alpha = rng.choice([0.0, C, 1e-13, C - 1e-13, 3.3], size=n)
    y = rng.choice([1, -1], size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    for valid_arg in (None, valid):
        tv = None if valid_arg is None else torch.tensor(valid_arg)
        jv = None if valid_arg is None else jnp.asarray(valid_arg)
        for tf, jf in ((tsel.i_high_mask, jsel.i_high_mask),
                       (tsel.i_low_mask, jsel.i_low_mask)):
            got = tf(torch.tensor(alpha), torch.tensor(y), C, eps, tv).numpy()
            want = np.asarray(jf(jnp.asarray(alpha), jnp.asarray(y), C, eps, jv))
            np.testing.assert_array_equal(got, want)


# (K11, K22, K12, y_h, y_l, a_h, a_l, b_high, b_low, C, proceed)
_PAIR_CASES = [
    (1.0, 1.0, 0.2, 1.0, -1.0, 0.0, 0.0, -1.0, 1.0, 10.0, True),   # s<0 interior
    (1.0, 1.0, 0.2, 1.0, 1.0, 2.0, 3.0, -1.0, 1.0, 10.0, True),    # s>0 interior
    (1.0, 1.0, 0.9, 1.0, -1.0, 0.0, 0.0, -50.0, 50.0, 1.0, True),  # clip at V
    (1.0, 1.0, 0.9, 1.0, 1.0, 0.5, 0.5, 50.0, -50.0, 1.0, True),   # floor at U
    (1.0, 1.0, 0.9, -1.0, 1.0, 0.7, 0.1, 30.0, -30.0, 1.0, True),  # s<0 floor
    (1.0, 1.0, 0.3, 1.0, 1.0, 0.9, 0.9, -1.0, 1.0, 1.0, True),     # s>0 U=0.8
    (1.0, 1.0, 0.3, 1.0, -1.0, 12.0, 0.0, -1.0, 1.0, 10.0, True),  # U > V
    (1.0, 1.0, 1.0, 1.0, -1.0, 0.0, 0.0, -1.0, 1.0, 10.0, True),   # eta = 0
    (0.5, 0.5, 0.5 + 1e-13, 1.0, -1.0, 0.0, 0.0, -1.0, 1.0, 10.0, True),  # eta<0
    (1.0, 1.0, 0.2, 1.0, -1.0, 0.0, 0.0, -1.0, 1.0, 10.0, False),  # gated off
    (1.0, 1.0, 0.2, 1.0, -1.0, 3.0, 3.0, 0.0, 0.0, 10.0, True),    # stalled
]


@pytest.mark.parametrize("case", _PAIR_CASES)
def test_pair_update_matches_jax_f64(case):
    *vals, C, proceed = case
    t = t_pair_update(*[torch.tensor(v, dtype=torch.float64) for v in vals],
                      C, 1e-12, torch.tensor(proceed))
    j = j_pair_update(*[jnp.asarray(v, jnp.float64) for v in vals], C, 1e-12,
                      jnp.asarray(proceed))
    for name in ("da_h", "da_l"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), atol=1e-12)
    for name in ("feasible", "eta_ok", "do_update", "stalled"):
        assert bool(getattr(t, name)) == bool(getattr(j, name)), name


def test_pair_update_case_coverage():
    """The cases above reach both clip bounds, an empty box, eta <= eps
    and a stall (guards the table against silent edits)."""
    seen = set()
    for *vals, C, proceed in _PAIR_CASES:
        t = t_pair_update(*[torch.tensor(v, dtype=torch.float64) for v in vals],
                          C, 1e-12, torch.tensor(proceed))
        seen.update(k for k in ("feasible", "eta_ok", "stalled")
                    if bool(getattr(t, k)) == (k == "stalled"))
    assert seen == {"feasible", "eta_ok", "stalled"}
