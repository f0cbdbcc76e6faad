"""The f-update's 3xTF32 arithmetic, on the CPU.

On the card the f-update kernels (csrc/rbf_tile.cuh) form X . X_B^T as
3xTF32 on the tensor cores: each operand is split as a = hi + lo with
hi = tf32(a) and lo = tf32(a - hi) (cvt.rna.tf32.f32: round to nearest,
ties away from zero), and the products lo.hi + hi.lo + hi.hi of each
32-wide k slice are summed on the tensor cores, the slices with IEEE adds.
`rbf_cross_matvec_3xtf32` models that precision, not the card's rounding:
the same split and products as three full-depth f32 matmuls, added, which
rounds more than the card does (tests/test_torch_cuda.py holds the kernel
to it on the card). Here:

- `tf32_split` against two numpy references of the rounding, one in
  scaled f64 arithmetic and one on the bit pattern, on ties, negatives,
  subnormals, +-0, overflow, infinities and NaN; hi + lo == x exactly
  wherever x - hi is itself a TF32 value (about three quarters of random
  inputs), and within one unit in x's last place elsewhere (lo rounds the
  residual's 12th bit off);
- the model `rbf_cross_matvec_3xtf32` against the TPU kernel in
  interpret mode, within the existing tolerance 1e-5 * sum|coef|;
- the blocked solver with its f-update (and the fused-selection f-update)
  replaced by that model, against the JAX solver's inner='xla' engine: the
  same status and SV-ID set, |db| <= 1e-4 (the repo's cross-engine band).
  So a contraction that drops the lo.lo term leaves the solver's parity
  intact; the card's own parity is chip_smoke.py's phases 4 and 4b.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data import MinMaxScaler, blobs, mnist_like, rings
from tpusvm.ops.pallas.fused_fupdate import rbf_cross_matvec_pallas
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch.ops.cuda.fused_fupdate import (rbf_cross_matvec_3xtf32,
                                                 rbf_cross_matvec_ref,
                                                 select_candidates_ref,
                                                 tf32_split)
from tpusvm_torch.solver import blocked as t_blocked
from tpusvm_torch.status import Status


def _rna_reference(x32: np.ndarray) -> np.ndarray:
    """tf32(x) by scaled f64 arithmetic: |x| rounded half away from zero to
    a multiple of the TF32 spacing at x's exponent (2^(e-11) for
    |x| = m * 2^e, m in [0.5, 1); 2^-136 in the subnormal range)."""
    x = x32.astype(np.float64)
    a = np.abs(x)
    _, e = np.frexp(a)
    ulp = np.ldexp(1.0, np.maximum(e - 11, -136))
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.where(np.isfinite(a), np.floor(a / ulp + 0.5) * ulp, a)
        return np.copysign(r, x).astype(np.float32)


def _rna_bits(x32: np.ndarray) -> np.ndarray:
    """tf32(x) on the bit pattern: half of the 13 dropped bits added to the
    magnitude, then the 13 bits cleared; the sign bit is left alone."""
    bits = x32.view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return ((bits & np.uint32(0x80000000)) | mag).view(np.float32)


def _special_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**31 - 2**23, size=20000, dtype=np.int64)  # finite
    # finite magnitudes with low 13 bits 0x1000: exact ties
    ties = (rng.integers(0, 0x7F800000 >> 13, size=2000) << 13) | 0x1000
    subn = rng.integers(1, 2**23, size=2000)                    # subnormals
    near_ties = np.concatenate([ties - 1, ties + 1])
    mags = np.concatenate([bits, ties, near_ties, subn,
                           [0, 1, 0x1000, 0x1FFF, 0x007FF000, 0x007FFFFF,
                            0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF, 0x7F800000]])
    mags = mags.astype(np.uint32)
    signed = np.concatenate([mags, mags | np.uint32(0x80000000)])
    return signed.view(np.float32)


def test_tf32_split_rounds_to_nearest_away_like_the_reference():
    x = _special_values()
    hi, lo = tf32_split(torch.tensor(x))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(hi.view(np.uint32), _rna_reference(x).view(np.uint32))
    finite = np.isfinite(hi)
    with np.errstate(invalid="ignore"):
        resid = x - hi  # exact in f32 wherever hi is finite
    np.testing.assert_array_equal(lo[finite].view(np.uint32),
                                  _rna_reference(resid[finite]).view(np.uint32))
    # ties go away from zero, on both signs
    tie = (x.view(np.uint32) & 0x1FFF) == 0x1000
    assert tie.sum() > 1000
    assert (np.abs(hi[tie & finite]) > np.abs(x[tie & finite])).all()
    # the sign survives, +-0 included, and infinities stay infinite
    assert (np.signbit(hi) == np.signbit(x)).all()
    assert np.isinf(hi[np.isinf(x)]).all()
    # rounding past the largest finite TF32 value overflows to inf
    assert np.isinf(hi[x.view(np.uint32) == 0x7F7FF000]).all()


def test_tf32_split_matches_a_bit_level_reference():
    x = _special_values()
    hi, lo = tf32_split(torch.tensor(x))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(hi.view(np.uint32), _rna_bits(x).view(np.uint32))
    finite = np.isfinite(hi)
    np.testing.assert_array_equal(lo[finite].view(np.uint32),
                                  _rna_bits(x[finite] - hi[finite]).view(np.uint32))
    nan = np.array([np.nan, -np.nan], dtype=np.float32)
    nan = np.concatenate([nan, np.array([0x7F800FFF, 0xFFC01000],
                                        dtype=np.uint32).view(np.float32)])
    h, lo_nan = tf32_split(torch.tensor(nan))
    assert torch.isnan(h).all() and torch.isnan(lo_nan).all()


def test_tf32_split_parts_keep_ten_significand_bits():
    x = _special_values()
    hi, lo = tf32_split(torch.tensor(x))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()


def test_tf32_split_parts_sum_back_to_x():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(200000),
                        rng.random(200000)]).astype(np.float32)
    hi, lo = (t.numpy() for t in tf32_split(torch.tensor(x)))
    total = hi.astype(np.float64) + lo.astype(np.float64)
    fits = lo == x - hi  # the residual is a TF32 value: nothing is dropped
    assert 0.6 < fits.mean() < 0.9
    np.testing.assert_array_equal(total[fits], x[fits])
    np.testing.assert_array_equal((hi + lo)[fits], x[fits])
    # elsewhere lo drops the residual's last bit: one unit of x's last place
    np.testing.assert_array_equal(np.abs(total - x)[~fits],
                                  np.spacing(np.abs(x[~fits])).astype(np.float64))


def test_tf32_split_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32"):
        tf32_split(torch.zeros(3, dtype=torch.float64))


def _inputs(n, q, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)).astype(np.float32),
            rng.random((q, d)).astype(np.float32),
            rng.standard_normal(q).astype(np.float32))


@pytest.mark.parametrize("n,q,d", [(1000, 64, 16), (256, 128, 16), (777, 32, 37),
                                   (300, 256, 37), (130, 5, 3)])
def test_3xtf32_emulation_matches_pallas(n, q, d):
    X, XB, coef = _inputs(n, q, d, n + q + d)
    want = np.asarray(rbf_cross_matvec_pallas(
        jnp.asarray(X), jnp.asarray(XB), jnp.asarray(coef), 0.25, interpret=True))
    got = rbf_cross_matvec_3xtf32(torch.tensor(X), torch.tensor(XB),
                                  torch.tensor(coef), 0.25)
    assert got.shape == (n,) and got.dtype == torch.float32
    tol = 1e-5 * float(np.abs(coef).sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # and it is not the IEEE plain version: the lo.lo terms are dropped
    plain = rbf_cross_matvec_ref(torch.tensor(X), torch.tensor(XB),
                                 torch.tensor(coef), 0.25)
    assert not torch.equal(got, plain)


# (data, C, gamma), at n=600 so that q=512 (multipair=2) fits
_SETS = {
    "blobs": (lambda: blobs(n=600, d=2, seed=0), 1.0, 1.0),
    "rings": (lambda: rings(n=600, seed=0), 1.0, 5.0),
    "mnist_like": (lambda: mnist_like(n=600, d=32, noise=3.0,
                                      label_noise=0.005), 10.0, 0.05),
}
_MODES = {
    "wss1": dict(q=128, max_inner=256, wss=1),
    "wss2": dict(q=128, max_inner=256, wss=2),
    "multipair2_fused_selection": dict(q=512, max_inner=1024, wss=1,
                                       multipair=2, fused_selection=True),
}


def _emulated_fupdate(X, XB, coef, gamma, sn=None):
    return rbf_cross_matvec_3xtf32(X, XB, coef, gamma, sn)


def _emulated_fupdate_select(X, XB, coef, gamma, sn, f32_f, alpha32, y_eff,
                             C, eps, *, block, k_cand):
    df = rbf_cross_matvec_3xtf32(X, XB, coef, gamma, sn)
    return (df, *select_candidates_ref(f32_f + df, alpha32, y_eff, C, eps,
                                       X.shape[0], block, k_cand))


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("name", list(_SETS))
def test_solver_with_3xtf32_fupdate_matches_jax(monkeypatch, name, mode):
    make, C, gamma = _SETS[name]
    X, Y = make()
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    Y = Y.astype(np.int32)
    opts = dict(_MODES[mode])
    kw = dict(C=C, gamma=gamma, tau=1e-5, max_iter=10**6, q=opts.pop("q"),
              max_inner=opts.pop("max_inner"), wss=opts.pop("wss"))
    r_j = j_solve(jnp.asarray(Xs), jnp.asarray(Y), inner="xla",
                  fused_fupdate=False, accum_dtype=jnp.float64, **kw)
    calls = []

    def count(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_blocked, "rbf_cross_matvec_kernel",
                        count(_emulated_fupdate))
    monkeypatch.setattr(t_blocked, "fused_fupdate_select_kernel",
                        count(_emulated_fupdate_select))
    r_t = t_blocked.blocked_smo_solve(
        torch.tensor(Xs), torch.tensor(Y), inner="kernel", fused_fupdate=True,
        accum_dtype=torch.float64, device="cpu", **kw, **opts)
    want = ("_emulated_fupdate_select" if opts.get("fused_selection")
            else "_emulated_fupdate")
    assert calls and set(calls) == {want}
    a_j, a_t = np.asarray(r_j.alpha), r_t.alpha.numpy()
    assert int(r_j.status) == r_t.status == Status.CONVERGED
    np.testing.assert_array_equal(np.nonzero(a_t > 1e-8)[0],
                                  np.nonzero(a_j > 1e-8)[0])
    assert abs(r_t.b - float(r_j.b)) <= 1e-4
