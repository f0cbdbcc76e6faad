"""The multipair subproblem's plain version against the TPU kernel
(inner_smo_pallas(multipair=p), interpret mode), and the blocked solver's
multipair engine against the JAX package's.

Tolerances: the plain version follows the kernel's f32 arithmetic and
XLA's contractions, so the stat must be equal and a_B equal within 1e-5*C
(the cases here agree bit for bit, which is asserted where reached). The
blocked solves are held to the repo's cross-engine criterion: the same
status and SV-ID set, |db| <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.ops.pallas.inner_smo import inner_smo_pallas
from tpusvm.ops.rbf import rbf_cross
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel,
                                             inner_smo_multipair_kernel,
                                             inner_smo_multipair_ref)
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.status import Status

C, EPS, TAU = 10.0, 1e-12, 1e-5


def _subproblem(q, seed, d=8, gamma=0.5):
    rng = np.random.default_rng(seed)
    X = rng.random((q, d)).astype(np.float32)
    y = np.where(rng.random(q) < 0.5, 1, -1).astype(np.int32)
    K = np.asarray(rbf_cross(jnp.asarray(X), jnp.asarray(X), jnp.float32(gamma)))
    return K, y, np.zeros(q, np.float32), -y.astype(np.float32), np.ones(q, bool)


def _cross_slot_case():
    """test_pallas.py's adversarial construction (seed 4047): the global
    pair's ends in different slots, duplicated points (eta == 0 pairs)."""
    q, d = 512, 6
    rng = np.random.default_rng(4047)
    X = np.repeat(rng.random((q // 2, d)).astype(np.float32), 2, axis=0)
    y = np.where(np.arange(q) < 384, 1, -1).astype(np.int32)
    K = np.asarray(rbf_cross(jnp.asarray(X), jnp.asarray(X), 0.5))
    return K, y, np.zeros(q, np.float32), -y.astype(np.float32), np.ones(q, bool)


def _both(K, y, a0, f0, act, max_inner, p):
    a_p, n_p, pr_p, r_p = inner_smo_pallas(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(a0), jnp.asarray(f0),
        jnp.asarray(act), C, EPS, TAU, max_inner=max_inner, interpret=True,
        multipair=p)
    a_t, stat = inner_smo_multipair_ref(
        *(torch.tensor(v) for v in (K, y, a0, f0, act)), C, EPS, TAU,
        max_inner=max_inner, multipair=p)
    return (np.asarray(a_p), (int(n_p), int(bool(pr_p)), int(r_p))), \
        (a_t.numpy(), tuple(stat.tolist()[:3]))


def _invariants(K, y, a):
    assert (a >= -5e-6).all() and (a <= C + 5e-6).all()
    np.testing.assert_allclose(float(np.sum(a * y)), 0.0, atol=1e-3)
    Q = K.astype(np.float64) * np.outer(y, y)
    assert a.sum() - 0.5 * a @ Q @ a > 0.1


@pytest.mark.parametrize("p,q,max_inner", [(2, 512, 2048), (4, 1024, 2048),
                                           (4, 1024, 300)])
def test_ref_matches_pallas(p, q, max_inner):
    K, y, a0, f0, act = _subproblem(q, seed=7)
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, act, max_inner, p)
    assert st_t == st_p
    np.testing.assert_allclose(a_t, a_p, rtol=0, atol=1e-5 * C)
    np.testing.assert_array_equal(a_t, a_p)
    _invariants(K, y, a_t)


def test_ref_matches_pallas_on_cross_slot_global_ends():
    K, y, a0, f0, act = _cross_slot_case()
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, act, 2048, 2)
    assert st_t == st_p
    assert st_t[2] in (Status.CONVERGED, Status.NO_WORKING_SET, Status.MAX_ITER)
    np.testing.assert_allclose(a_t, a_p, rtol=0, atol=1e-5 * C)
    _invariants(K, y, a_t)


def test_all_inf_active_mask_ends_with_no_working_set():
    K, y, a0, f0, _ = _subproblem(512, seed=1)
    (a_p, st_p), (a_t, st_t) = _both(K, y, a0, f0, np.zeros(512, bool), 64, 2)
    assert st_t == st_p == (0, 0, int(Status.NO_WORKING_SET))
    np.testing.assert_array_equal(a_t, a_p)


def test_validation_errors_match_the_tpu_kernel():
    K, y, a0, f0, act = _subproblem(256, seed=2)
    jargs = [jnp.asarray(v) for v in (K, y, a0, f0, act)]
    targs = [torch.tensor(v) for v in (K, y, a0, f0, act)]
    for kw, match in ((dict(wss=2, multipair=2), "multipair requires wss=1"),
                      (dict(multipair=2), r"rows per slot"),
                      (dict(multipair=0), "multipair must be >= 1")):
        with pytest.raises(ValueError, match=match):
            inner_smo_pallas(*jargs, C, EPS, TAU, max_inner=8, interpret=True,
                             **kw)
        with pytest.raises(ValueError, match=match):
            inner_smo_kernel(*targs, C, EPS, TAU, max_inner=8, **kw)
    with pytest.raises(ValueError, match="p >= 2"):
        inner_smo_multipair_ref(*targs, C, EPS, TAU, max_inner=8, multipair=1)


def test_wrapper_takes_the_plain_version_on_cpu():
    K, y, a0, f0, act = (torch.tensor(v) for v in _subproblem(512, seed=2))
    before = (inner_smo_kernel.launches, inner_smo_multipair_kernel.launches)
    a_k, st_k = inner_smo_kernel(K, y, a0, f0, act, C, EPS, TAU,
                                 max_inner=200, multipair=2)
    a_r, st_r = inner_smo_multipair_ref(K, y, a0, f0, act, C, EPS, TAU,
                                        max_inner=200, multipair=2)
    np.testing.assert_array_equal(a_k.numpy(), a_r.numpy())
    assert st_k.tolist() == st_r.tolist()
    assert (inner_smo_kernel.launches,
            inner_smo_multipair_kernel.launches) == before


def _blocked_data():
    """test_pallas.py's blocked multipair setup: n=600, d=12, q=512."""
    rng = np.random.default_rng(17)
    n, d = 600, 12
    X = rng.random((n, d)).astype(np.float32)
    Y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    return X, Y, dict(C=10.0, gamma=1.0, tau=1e-5, q=512, max_inner=2048,
                      max_outer=500, wss=1)


def _assert_parity(a_ref, b_ref, st_ref, r_t):
    a_t = r_t.alpha.numpy()
    assert int(st_ref) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(np.nonzero(a_t > 1e-8)[0],
                                  np.nonzero(a_ref > 1e-8)[0])
    assert abs(r_t.b - float(b_ref)) <= 1e-4


def test_blocked_multipair_matches_jax():
    X, Y, kw = _blocked_data()
    r_j = j_solve(jnp.asarray(X), jnp.asarray(Y), inner="pallas",
                  pallas_multipair=2, accum_dtype=jnp.float64, **kw)
    r_t = blocked_smo_solve(torch.tensor(X), torch.tensor(Y), inner="kernel",
                            multipair=2, accum_dtype=torch.float64,
                            device="cpu", **kw)
    _assert_parity(np.asarray(r_j.alpha), r_j.b, r_j.status, r_t)
    assert r_t.n_host_syncs <= 2 * r_t.n_outer + 1


def test_blocked_multipair_with_fused_selection_matches_loop_engine():
    X, Y, kw = _blocked_data()
    r_l = blocked_smo_solve(torch.tensor(X), torch.tensor(Y), inner="loop",
                            fused_fupdate=False, accum_dtype=torch.float64,
                            device="cpu", **kw)
    r_t = blocked_smo_solve(torch.tensor(X), torch.tensor(Y), inner="kernel",
                            multipair=2, fused_selection=True,
                            accum_dtype=torch.float64, device="cpu", **kw)
    _assert_parity(r_l.alpha.numpy(), r_l.b, r_l.status, r_t)
    assert r_t.n_host_syncs <= 2 * r_t.n_outer + 1


def test_blocked_multipair_flag_validation():
    X = torch.zeros((16, 4))
    Y = torch.tensor([1, -1] * 8)
    with pytest.raises(ValueError, match="kernel-engine feature"):
        blocked_smo_solve(X, Y, inner="loop", multipair=4, device="cpu")
    X = torch.zeros((1024, 4))
    Y = torch.tensor([1, -1] * 512)
    with pytest.raises(ValueError, match="multipair requires wss=1"):
        blocked_smo_solve(X, Y, q=1024, wss=2, multipair=2, device="cpu")
    with pytest.raises(ValueError, match="rows per slot"):
        blocked_smo_solve(X, Y, q=512, multipair=4, device="cpu")
