"""The port's blocked solver against the JAX package's, on the CPU.

Engines are paired: the port's "kernel" engine (the kernels' plain
versions here) against JAX inner="pallas", fused_fupdate=True (interpret
mode); the port's "loop" engine against JAX inner="xla". Parity is the
repo's cross-engine criterion: the same SV-ID set, status and accuracy,
b within the 1e-4 band, alphas within 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpusvm.config import SVMConfig as JConfig
from tpusvm.data import MinMaxScaler, blobs, mnist_like, rings
from tpusvm.oracle.smo import smo_train
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm.solver.predict import predict as j_predict
from tpusvm_torch.ops.selection import i_high_mask, i_low_mask
from tpusvm_torch.solver.blocked import (blocked_smo_solve, resolve_solver_config,
                                         select_working_set)
from tpusvm_torch.solver.predict import predict as t_predict
from tpusvm_torch.status import Status

# (data, C, gamma): configurations whose optimum is well determined
_SETS = {
    "blobs": (lambda: blobs(n=400, d=2, seed=0), 1.0, 1.0),
    "rings": (lambda: rings(n=400, seed=0), 1.0, 5.0),
    "mnist_like": (lambda: mnist_like(n=512, d=32, noise=3.0,
                                      label_noise=0.005), 10.0, 0.05),
}
_ENGINES = {"kernel": dict(inner="pallas", fused_fupdate=True),
            "loop": dict(inner="xla", fused_fupdate=False)}


def _data(name):
    make, C, gamma = _SETS[name]
    X, Y = make()
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    return Xs, Y.astype(np.int32), C, gamma


def _solves(name, wss, engine):
    Xs, Y, C, gamma = _data(name)
    kw = dict(C=C, gamma=gamma, tau=1e-5, q=128, max_inner=256,
              max_iter=10**6, wss=wss)
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), accum_dtype=jnp.float64,
                  **_ENGINES[engine], **kw)
    r_t = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), inner=engine,
                            fused_fupdate=engine == "kernel",
                            accum_dtype=torch.float64, device="cpu", **kw)
    return Xs, Y, C, gamma, r_j, r_t


@pytest.mark.parametrize("engine", ["kernel", "loop"])
@pytest.mark.parametrize("wss", [1, 2])
@pytest.mark.parametrize("name", list(_SETS))
def test_blocked_matches_jax(name, wss, engine):
    Xs, Y, C, gamma, r_j, r_t = _solves(name, wss, engine)
    a_j = np.asarray(r_j.alpha)
    a_t = r_t.alpha.numpy()
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(np.nonzero(a_t > 1e-8)[0],
                                  np.nonzero(a_j > 1e-8)[0])
    assert abs(r_t.b - float(r_j.b)) <= 1e-4
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=2e-3)
    # accuracy on the training rows, each package scoring its own model
    p_j = np.asarray(j_predict(jnp.asarray(Xs), jnp.asarray(Xs),
                               jnp.asarray(Y), jnp.asarray(a_j),
                               float(r_j.b), gamma=gamma))
    p_t = t_predict(torch.tensor(Xs), torch.tensor(Xs), torch.tensor(Y),
                    torch.tensor(a_t), r_t.b, gamma=gamma).numpy()
    assert (p_t == Y).mean() == (p_j == Y).mean()
    # at most two host synchronisations per outer round, one per stop check
    assert r_t.n_host_syncs <= 2 * r_t.n_outer + 1


@pytest.mark.parametrize("wss", [1, 2])
@pytest.mark.parametrize("name", ["blobs", "rings"])
def test_blocked_matches_oracle(name, wss):
    """The float64 serial oracle as a second anchor."""
    Xs, Y, C, gamma = _data(name)
    ref = smo_train(Xs.astype(np.float64), Y, JConfig(C=C, gamma=gamma))
    r_t = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), C=C,
                            gamma=gamma, q=128, max_inner=256, wss=wss,
                            accum_dtype=torch.float64, device="cpu")
    assert ref.status == Status.CONVERGED and r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(np.nonzero(r_t.alpha.numpy() > 1e-8)[0],
                                  np.nonzero(ref.alpha > 1e-8)[0])
    assert abs(r_t.b - ref.b) <= 1e-4


def _jax_round1(f, alpha, Y, C, eps, half):
    """The reference's exact selection (blocked.py, selection='exact')."""
    m_h = jnp.where(Y == 1, alpha < C - eps, (Y == -1) & (alpha > eps))
    m_l = jnp.where(Y == 1, alpha > eps, (Y == -1) & (alpha < C - eps))
    key_up = jnp.where(m_h, f, jnp.inf).astype(jnp.float32)
    _, idx_up = lax.top_k(-key_up, half)
    in_up = jnp.zeros(f.shape, bool).at[idx_up].set(m_h[idx_up])
    key_low = jnp.where(m_l & ~in_up, f, -jnp.inf).astype(jnp.float32)
    _, idx_low = lax.top_k(key_low, half)
    return np.asarray(jnp.concatenate([idx_up, idx_low]))


@pytest.mark.parametrize("state", ["cold", "mid"])
def test_working_set_matches_jax_on_ties(state):
    """f0 = -y is a sea of ties: the stable sort must give lax.top_k's
    lower-index-first order, also with duplicates across the halves."""
    rng = np.random.default_rng(7)
    n, C, eps, half = 700, 10.0, 1e-12, 128
    Y = np.where(rng.random(n) < 0.3, 1, -1).astype(np.int32)
    if state == "cold":
        alpha = np.zeros(n)
        f = -Y.astype(np.float64)
    else:  # quantised f: many exact ties, alphas on and inside the box
        alpha = rng.choice([0.0, C, 2.5], size=n)
        f = np.round(rng.standard_normal(n), 1)
    want = _jax_round1(jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(Y),
                       C, eps, half)
    ta, ty, tf = torch.tensor(alpha), torch.tensor(Y), torch.tensor(f)
    B, is_first = select_working_set(tf, i_high_mask(ta, ty, C, eps),
                                     i_low_mask(ta, ty, C, eps), half)
    np.testing.assert_array_equal(B.numpy(), want)
    # first occurrence wins for a row picked by both halves
    Bn = B.numpy()
    first = np.array([i == list(Bn).index(b) for i, b in enumerate(Bn)])
    np.testing.assert_array_equal(is_first.numpy(), first)


def test_resolve_solver_config():
    assert resolve_solver_config(1000, 256) == (256, "kernel", True)
    assert resolve_solver_config(400, 1024) == (400, "loop", False)
    assert resolve_solver_config(401, 100, "kernel") == (100, "kernel", False)
    with pytest.raises(ValueError, match="inner must be"):
        resolve_solver_config(100, inner="pallas")


def test_blocked_rejects_unaligned_kernel_and_stray_flags():
    X = torch.zeros((16, 4))
    Y = torch.tensor([1, -1] * 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        blocked_smo_solve(X, Y, inner="kernel", q=16, device="cpu")
    with pytest.raises(ValueError, match="eta_exclude"):
        blocked_smo_solve(X, Y, inner="loop", wss=2, eta_exclude=True,
                          device="cpu")


def test_warm_start_from_own_solution_resumes_converged():
    Xs, Y, C, gamma = _data("blobs")
    kw = dict(C=C, gamma=gamma, q=128, max_inner=256, wss=2,
              accum_dtype=torch.float64, device="cpu")
    r = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y), **kw)
    r2 = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                           alpha0=r.alpha, warm_start=True, **kw)
    assert r2.status == Status.CONVERGED and r2.n_outer <= 3
    assert abs(r2.b - r.b) <= 1e-4
