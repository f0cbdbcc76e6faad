"""The f-update with fused candidate selection: its plain version against
the TPU kernel (fused_fupdate_select_pallas, interpret mode), the
candidate pool's shape and round-1 lists against the JAX solver's, the
selection from a pool against the JAX solver's expression, the blocked
solve with fused selection against the JAX package's, and --solver-opt.

Tolerances: with coef = 0 df is exactly 0 on both sides, so candidate
values and indices must be equal bit for bit (ties, invalid rows, fillers
and ragged last blocks included). With coef != 0 df agrees within
1e-5 * sum|coef| (f32 sums in another order) and the candidates are equal
on f whose values are far apart next to that. The blocked solve is held to
the same status and SV-ID set and |db| <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpusvm.data import MinMaxScaler, rings
from tpusvm.ops.pallas.fused_fupdate import fused_fupdate_select_pallas
from tpusvm.ops.pallas.fused_fupdate import selection_shape as j_selection_shape
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm.solver.blocked import bootstrap_candidates as j_bootstrap
from tpusvm_torch.cli import _parse_solver_opts, main
from tpusvm_torch.ops.cuda.fused_fupdate import (fused_fupdate_select_kernel,
                                                 fused_fupdate_select_ref,
                                                 selection_shape)
from tpusvm_torch.ops.selection import i_high_mask
from tpusvm_torch.solver.blocked import (blocked_smo_solve,
                                         bootstrap_candidates,
                                         select_from_candidates)
from tpusvm_torch.status import Status

C, EPS = 10.0, 1e-12


@pytest.mark.parametrize("n,d,q", [(60000, 784, 2048), (240, 2, 64),
                                   (512, 16, 128), (600, 12, 512),
                                   (200, 2, 32), (1000, 37, 256), (5, 3, 4),
                                   (7, 2, 128), (120000, 784, 4096),
                                   (3000, 20000, 1024)])
def test_selection_shape_matches_jax(n, d, q):
    assert selection_shape(n, d, q) == j_selection_shape(n, d, q)
    if (n, d, q) == (60000, 784, 2048):
        assert selection_shape(n, d, q) == (256, 235, 8, 1880)


def _problem(n, seed, ties=True, bound=False):
    rng = np.random.default_rng(seed)
    Y = np.where(rng.random(n) < 0.4, 1, -1).astype(np.int32)
    f = (np.round(rng.standard_normal(n), 1) if ties
         else rng.permutation(n) * 0.01).astype(np.float64)
    alpha = rng.choice([0.0, C] if bound else [0.0, C, 2.5], size=n)
    valid = rng.random(n) > 0.1
    return f, alpha, Y, valid


@pytest.mark.parametrize("ncand", [64, 500, 900])
def test_bootstrap_candidates_match_jax_on_ties(ncand):
    f, alpha, Y, valid = _problem(700, seed=3)
    want = j_bootstrap(jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(Y),
                       jnp.asarray(valid), C, EPS, ncand)
    got = bootstrap_candidates(torch.tensor(f), torch.tensor(alpha),
                               torch.tensor(Y), torch.tensor(valid), C, EPS,
                               ncand)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _select(n, d, q, seed, *, block, k_cand, coef_zero, ties=True,
            bound=False):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    XB = rng.random((q, d)).astype(np.float32)
    coef = (np.zeros(q) if coef_zero else rng.standard_normal(q)).astype(np.float32)
    f, alpha, Y, valid = _problem(n, seed + 1, ties=ties, bound=bound)
    f32 = f.astype(np.float32)
    a32 = alpha.astype(np.float32)
    y_eff = (Y * valid).astype(np.int32)
    want = fused_fupdate_select_pallas(
        jnp.asarray(X), jnp.asarray(XB), jnp.asarray(coef), 0.5, None,
        jnp.asarray(f32), jnp.asarray(a32), jnp.asarray(y_eff), C, EPS,
        k_cand=k_cand, block=block, interpret=True)
    got = fused_fupdate_select_ref(
        torch.tensor(X), torch.tensor(XB), torch.tensor(coef), 0.5, None,
        torch.tensor(f32), torch.tensor(a32), torch.tensor(y_eff), C, EPS,
        block=block, k_cand=k_cand)
    return [np.asarray(w) for w in want], [g.numpy() for g in got], coef


@pytest.mark.parametrize("n,block,k_cand,bound", [
    (1000, 128, 16, False),   # ragged last block (104 rows), ties
    (1000, 128, 24, True),    # all-bound alphas
    (300, 64, 32, True),      # blocks short of members: fillers past n
    (600, 600, 32, False),    # one block, the shape selection_shape gives
])
def test_ref_matches_pallas_exactly_at_zero_coef(n, block, k_cand, bound):
    want, got, _ = _select(n, 7, 64, seed=n + k_cand, block=block,
                           k_cand=k_cand, coef_zero=True, bound=bound)
    assert not got[0].any() and not want[0].any()
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    if n == 300:
        # +-inf fillers, the last block's taken from its rows past n
        assert np.isinf(got[1]).any() and np.isinf(got[3]).any()
        assert got[2].max() >= n and got[4].max() >= n


def test_ref_matches_pallas_with_coefficients():
    want, got, coef = _select(1000, 37, 256, seed=4, block=256, k_cand=16,
                              coef_zero=False, ties=False)
    tol = 1e-5 * float(np.abs(coef).sum())
    for i in (0, 1, 3):  # df and the candidate values f + df
        assert float(np.abs(got[i] - want[i]).max()) <= tol
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])


def _j_select_from_candidates(cands, m_h, half, n, q):
    """blocked.py's fused-selection lines (911-925 and 946-955)."""
    cuv, cui, clv, cli = cands
    _, sel_up = lax.top_k(-cuv, half)
    idx_up = jnp.minimum(cui[sel_up], n - 1)
    in_up = jnp.zeros((n,), bool).at[idx_up].set(m_h[idx_up])
    low_safe = jnp.minimum(cli, n - 1)
    low_key = jnp.where(in_up[low_safe], -jnp.inf, clv)
    _, sel_lo = lax.top_k(low_key, half)
    B = jnp.concatenate([idx_up, low_safe[sel_lo]]).astype(jnp.int32)
    pos_q = jnp.arange(q, dtype=jnp.int32)
    earlier = (B[:, None] == B[None, :]) & (pos_q[None, :] < pos_q[:, None])
    return np.asarray(B), np.asarray(~jnp.any(earlier, axis=1))


def test_select_from_candidates_matches_jax():
    """A pool with ties, +-inf fillers and indices past n (clamped)."""
    n, half = 300, 150
    want, got, _ = _select(n, 3, 32, seed=3, block=64, k_cand=32,
                           coef_zero=True, bound=True)
    f, alpha, Y, valid = _problem(n, 4, bound=True)
    m_h = i_high_mask(torch.tensor(alpha), torch.tensor(Y), C, EPS,
                      torch.tensor(valid))
    B_w, first_w = _j_select_from_candidates(
        [jnp.asarray(v) for v in want[1:]], jnp.asarray(m_h.numpy()), half, n,
        2 * half)
    B, first = select_from_candidates([torch.tensor(v) for v in got[1:]],
                                      m_h, half)
    np.testing.assert_array_equal(B.numpy(), B_w)
    np.testing.assert_array_equal(first.numpy(), first_w)
    assert (B_w == n - 1).any() and not first_w.all()


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    n, d, q = 300, 5, 64
    args = [torch.tensor(rng.random((n, d)), dtype=torch.float32),
            torch.tensor(rng.random((q, d)), dtype=torch.float32),
            torch.tensor(rng.standard_normal(q), dtype=torch.float32), 0.5, None,
            torch.tensor(rng.standard_normal(n), dtype=torch.float32),
            torch.zeros(n), torch.tensor(np.where(rng.random(n) < 0.5, 1, -1),
                                         dtype=torch.int32), C, EPS]
    before = fused_fupdate_select_kernel.launches
    got = fused_fupdate_select_kernel(*args, block=128, k_cand=8)
    want = fused_fupdate_select_ref(*args, block=128, k_cand=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert fused_fupdate_select_kernel.launches == before


def test_blocked_fused_selection_matches_jax():
    """test_shrink.py's fused-selection setup: rings n=200, q=32."""
    X, Y = rings(n=200, seed=5)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    kw = dict(C=10.0, gamma=10.0, tau=1e-5, q=32, max_inner=64)
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), fused_fupdate=True,
                  pallas_fused_selection=True, accum_dtype=jnp.float64, **kw)
    r_t = blocked_smo_solve(torch.tensor(Xs), torch.tensor(Y),
                            fused_fupdate=True, fused_selection=True,
                            accum_dtype=torch.float64, device="cpu", **kw)
    a_j, a_t = np.asarray(r_j.alpha), r_t.alpha.numpy()
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(np.nonzero(a_t > 1e-8)[0],
                                  np.nonzero(a_j > 1e-8)[0])
    assert abs(r_t.b - float(r_j.b)) <= 1e-4
    assert r_t.b_low <= r_t.b_high + 2e-5 * (1 + 1e-6)


def test_blocked_fused_selection_flag_validation():
    X = torch.zeros((64, 2))
    Y = torch.tensor([1, -1] * 32)
    # q=32 is unaligned: fused_fupdate='auto' resolves off
    with pytest.raises(ValueError, match="fused_selection"):
        blocked_smo_solve(X, Y, q=32, fused_selection=True, device="cpu")
    with pytest.raises(ValueError, match="fused_selection"):
        blocked_smo_solve(X, Y, q=32, fused_fupdate=False,
                          fused_selection=True, device="cpu")


def test_parse_solver_opts():
    assert _parse_solver_opts(["multipair=4", "fused_selection=true",
                               "eta_exclude=False", "inner=kernel",
                               "tau=1e-4"]) == {
        "multipair": 4, "fused_selection": True, "eta_exclude": False,
        "inner": "kernel", "tau": 1e-4}
    with pytest.raises(SystemExit):
        _parse_solver_opts(["multipair"])


def test_cli_train_passes_solver_opts(capsys):
    rc = main(["train", "--synthetic", "rings", "--n", "300", "--n-test",
               "100", "--q", "128", "--device", "cpu", "--solver-opt",
               "fused_selection=true"])
    out = capsys.readouterr().out
    assert rc == 0 and "status = CONVERGED" in out
    with pytest.raises(ValueError, match="fused_selection"):
        main(["train", "--synthetic", "rings", "--n", "300", "--n-test", "0",
              "--q", "100", "--device", "cpu", "--solver-opt",
              "fused_selection=true"])
