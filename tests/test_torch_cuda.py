"""The CUDA kernels against their plain versions on the card, and fits
that go through them. Marked `cuda`: skipped where no CUDA device is
present (run on the card with `python -m pytest tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.synthetic import mnist_like
from tpusvm_torch.models.svm import BinarySVC
from tpusvm_torch.ops.cuda.fused_fupdate import (fused_fupdate_select_kernel,
                                                 rbf_cross_matvec_3xtf32,
                                                 rbf_cross_matvec_kernel,
                                                 rbf_cross_matvec_ref,
                                                 select_candidates_ref,
                                                 select_epilogue_probe)
from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel,
                                             inner_smo_multipair_kernel,
                                             inner_smo_multipair_ref,
                                             inner_smo_ref,
                                             iteration_floor_probe,
                                             multipair_floor_probe)
from tpusvm_torch.ops.rbf import rbf_cross

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# d=784: a d tail inside a 32-wide k slice; d=37 and d=3: the padded
# columns; n not a multiple of the 128-row unit; q=5 and q=2048
@pytest.mark.parametrize("n,d,q", [(1000, 37, 256), (4099, 784, 512), (7, 3, 5),
                                   (4099, 784, 2048), (300, 3, 2048),
                                   (129, 784, 5), (513, 37, 2048)])
def test_fused_fupdate_kernel_matches_plain(dev, n, d, q):
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    got = rbf_cross_matvec_kernel(X, XB, coef, 0.1)
    want = rbf_cross_matvec_ref(X, XB, coef, 0.1)
    torch.cuda.synchronize()
    tol = 1e-5 * float(coef.abs().sum())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
    # the same call again gives the same bits: a fixed summation order
    assert torch.equal(rbf_cross_matvec_kernel(X, XB, coef, 0.1), got)


@pytest.mark.parametrize("d", [784, 37])
def test_fused_fupdate_kernel_takes_a_misaligned_view(dev, d):
    rng = np.random.default_rng(d)
    X = torch.as_tensor(rng.random((1000, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((256, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(256), dtype=torch.float32, device=dev)
    buf = torch.empty(X.numel() + 1, device=dev)
    Xm = buf[1:].view(X.shape)  # 4 bytes past a 16-byte boundary
    Xm.copy_(X)
    assert Xm.data_ptr() % 16 != 0
    got = rbf_cross_matvec_kernel(Xm, XB, coef, 0.1)
    assert torch.equal(got, rbf_cross_matvec_kernel(X, XB, coef, 0.1))


@pytest.mark.parametrize("n,d,q", [(1000, 37, 256), (4099, 784, 2048)])
def test_fused_fupdate_kernel_matches_the_3xtf32_model(dev, n, d, q):
    """The kernel against the CPU tests' 3xTF32 model on the same inputs,
    within the f-update's tolerance 1e-5 * sum|coef|."""
    rng = np.random.default_rng(q)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    got = rbf_cross_matvec_kernel(X, XB, coef, 0.1)
    model = rbf_cross_matvec_3xtf32(X, XB, coef, 0.1)
    torch.cuda.synchronize()
    assert float((got - model).abs().max()) <= 1e-5 * float(coef.abs().sum())


def test_fused_fupdate_3xtf32_error_under_a_tenth_of_single_pass_tf32(dev):
    """Kernel values K(x_i, xb_k) of four columns (coef one-hot, so the sum
    adds exact zeros) at gamma = 1 / median d2, against f64: the 3xTF32
    contraction's error must be under a tenth of a single-pass TF32
    product's on the same inputs, which it is only if the lo terms apply."""
    rng = np.random.default_rng(11)
    n, d, q = 4099, 784, 2048
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    X64, XB64 = X.double(), XB.double()
    d2_64 = ((X64 * X64).sum(1)[:, None] + (XB64 * XB64).sum(1)[None, :]
             - 2.0 * (X64 @ XB64.T)).clamp_min(0.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dot_tf32 = X @ XB.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    sn, snB = (X * X).sum(1), (XB * XB).sum(1)
    err_k = err_t = 0.0
    for k in (0, 700, 1400, q - 1):
        g = 1.0 / float(d2_64[:, k].median())
        ref = torch.exp(-g * d2_64[:, k])
        coef = torch.zeros(q, device=dev)
        coef[k] = 1.0
        got = rbf_cross_matvec_kernel(X, XB, coef, g, sn)
        tf32 = torch.exp(-g * (sn + snB[k] - 2.0 * dot_tf32[:, k]).clamp_min(0.0))
        err_k = max(err_k, float((got.double() - ref).abs().max()))
        err_t = max(err_t, float((tf32.double() - ref).abs().max()))
    assert err_t > 0 and err_k < 0.1 * err_t


def _working_set(q, seed, dev, *, mid=False, dup=False):
    """A subproblem on the card. mid: a mid-solve state (alphas at 0, C and
    inside the box, f off -y, about 15% of lanes inactive); dup: every point
    four times over, so eta == 0 pairs are shrunk."""
    rng = np.random.default_rng(seed)
    X = np.resize(rng.random((q // 4 if dup else q, 8)), (q, 8))
    y = np.where(rng.random(q) < 0.5, 1, -1)
    if mid:
        a = rng.choice([0.0, 0.0, 10.0, 2.5, 7.25], size=q)
        f = np.round(-y + 0.5 * rng.standard_normal(q), 3)
        act = rng.random(q) > 0.15
    else:
        a, f, act = np.zeros(q), -y.astype(float), np.ones(q, bool)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
    return (rbf_cross(Xt, Xt, 0.5), torch.as_tensor(y, device=dev),
            torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(f, dtype=torch.float32, device=dev),
            torch.as_tensor(act, device=dev), 10.0, 1e-12, 1e-5)


# q=1500: threads own a ragged number of lanes; q=3000 and 4099: lanes past
# the two a thread keeps in registers; mid/dup: nonzero alphas, inactive
# lanes, shrinks; max_inner 8192 lets the small cases converge
@pytest.mark.parametrize("q,mid,dup,max_inner", [
    (128, False, False, 512), (256, False, False, 512), (2048, False, False, 512),
    (256, True, True, 8192), (1500, True, False, 512), (3000, False, False, 512),
    (4099, True, True, 512)])
@pytest.mark.parametrize("wss,eta_exclude", [(1, False), (2, False), (2, True)])
def test_inner_smo_kernel_matches_plain(dev, q, mid, dup, max_inner, wss, eta_exclude):
    """The kernel against its plain version bit for bit: alpha and all four
    stat entries."""
    args = _working_set(q, 3 + q, dev, mid=mid, dup=dup)
    a_k, st_k = inner_smo_kernel(*args, max_inner=max_inner, wss=wss,
                                 eta_exclude=eta_exclude)
    a_r, st_r = inner_smo_ref(*args, max_inner=max_inner, wss=wss,
                              eta_exclude=eta_exclude)
    torch.cuda.synchronize()
    assert st_k.tolist() == st_r.tolist()
    assert torch.equal(a_k, a_r)


@pytest.mark.parametrize("mode", ["chain", "rows"])
@pytest.mark.parametrize("wss,q", [(1, 256), (2, 256), (2, 3000)])
def test_iteration_floor_probe_runs(dev, mode, wss, q):
    K = torch.rand(q, q, device=dev)
    before = inner_smo_kernel.launches
    out = iteration_floor_probe(K, 100, wss=wss, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert inner_smo_kernel.launches == before


def test_fit_launches_both_kernels(dev):
    X, Y = mnist_like(n=3000, d=784, noise=30.0, label_noise=0.005)
    rbf_cross_matvec_kernel.launches = 0
    inner_smo_kernel.launches = 0
    m = BinarySVC(SVMConfig(max_iter=10**6), device="cuda",
                  solver_opts=dict(q=256, wss=2, max_inner=512)).fit(X, Y)
    assert m.status_.name == "CONVERGED"
    assert rbf_cross_matvec_kernel.launches > 0
    assert inner_smo_kernel.launches > 0


@pytest.mark.parametrize("q,p,mid,dup,max_inner", [
    (512, 2, False, False, 1024), (1024, 4, False, False, 1024),
    (2048, 8, False, False, 1024), (512, 2, True, True, 8192),
    (1024, 4, True, False, 1024), (2048, 4, True, True, 1024),
    (4096, 16, True, False, 1024), (768, 3, True, False, 1024)])
def test_multipair_kernel_matches_plain(dev, q, p, mid, dup, max_inner):
    """The kernel against its plain version bit for bit: alpha and all four
    stat entries, over every term count the kernel is built for."""
    args = _working_set(q, q + p, dev, mid=mid, dup=dup)
    before = inner_smo_kernel.launches
    a_k, st_k = inner_smo_multipair_kernel(*args, max_inner=max_inner, multipair=p)
    a_r, st_r = inner_smo_multipair_ref(*args, max_inner=max_inner, multipair=p)
    torch.cuda.synchronize()
    assert st_k.tolist() == st_r.tolist()
    assert torch.equal(a_k, a_r)
    assert inner_smo_kernel.launches == before


@pytest.mark.parametrize("n,d,q,block,k_cand", [(1000, 37, 256, 128, 16),
                                                (300, 3, 64, 64, 32),
                                                (4099, 784, 512, 512, 8),
                                                (4099, 784, 2048, 256, 8),
                                                (129, 3, 5, 64, 8)])
def test_fused_select_kernel_matches_plain(dev, n, d, q, block, k_cand):
    rng = np.random.default_rng(n)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    XB = torch.as_tensor(rng.random((q, d)), dtype=torch.float32, device=dev)
    coef = torch.as_tensor(rng.standard_normal(q), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.round(rng.standard_normal(n), 1), dtype=torch.float32,
                        device=dev)
    a = torch.as_tensor(rng.choice([0.0, 10.0, 2.5], size=n), dtype=torch.float32,
                        device=dev)
    y_eff = torch.as_tensor(np.where(rng.random(n) < 0.5, 1, -1)
                            * (rng.random(n) > 0.1), dtype=torch.int32, device=dev)
    df, *cands = fused_fupdate_select_kernel(X, XB, coef, 0.1, None, f, a, y_eff,
                                             10.0, 1e-12, block=block,
                                             k_cand=k_cand)
    want = select_candidates_ref(f + df, a, y_eff, 10.0, 1e-12, n, block, k_cand)
    alone = select_epilogue_probe(df, f, a, y_eff, 10.0, 1e-12, block=block,
                                  k_cand=k_cand)
    torch.cuda.synchronize()
    assert torch.equal(df, rbf_cross_matvec_kernel(X, XB, coef, 0.1))
    for got, w, e in zip(cands, want, alone):
        assert torch.equal(got, w) and torch.equal(e, w)


@pytest.mark.parametrize("mode", ["chain", "rows"])
@pytest.mark.parametrize("q,p", [(512, 2), (2048, 4), (2048, 8), (4096, 16)])
def test_multipair_floor_probe_runs(dev, mode, q, p):
    K = torch.rand(q, q, device=dev)
    before = inner_smo_multipair_kernel.launches
    out = multipair_floor_probe(K, 100, multipair=p, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert inner_smo_multipair_kernel.launches == before


def test_fit_launches_the_multipair_and_select_kernels(dev):
    X, Y = mnist_like(n=3000, d=784, noise=30.0, label_noise=0.005)
    inner_smo_multipair_kernel.launches = 0
    fused_fupdate_select_kernel.launches = 0
    m = BinarySVC(SVMConfig(max_iter=10**6), device="cuda",
                  solver_opts=dict(q=512, wss=1, max_inner=512, multipair=2,
                                   fused_selection=True)).fit(X, Y)
    assert m.status_.name == "CONVERGED"
    assert inner_smo_multipair_kernel.launches > 0
    assert fused_fupdate_select_kernel.launches > 0


# ---------------------------------------------------------------------------
# The pair solver's K-row refresh (csrc/pair_rows.cu) and the pair loop.

# max |kernel - plain| per family, relative to the largest plain value of
# the rows: both are f32 dots of d terms (the kernel's order fixed per lane
# then a butterfly, the plain version's cuBLAS's), so they differ by f32
# summation rounding, ~d * 2^-24 of the dot's scale at worst; poly cubes
# its base (3x the relative error), RBF subtracts the dot from the norms
# and scales the difference by gamma
_PAIR_ROWS_RTOL = {"rbf": 1e-5, "linear": 1e-5, "poly": 3e-5, "sigmoid": 1e-5}
_FAMILY_KW = {"rbf": dict(gamma=0.01), "linear": dict(gamma=0.0),
              "poly": dict(gamma=1.0 / 784, coef0=1.0, degree=3),
              "sigmoid": dict(gamma=1.0 / 784, coef0=-0.5)}


def _pair_rows_inputs(dev, n, d, k, seed=0):
    from tpusvm_torch.ops.rbf import sq_norms

    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.choice(n, size=k, replace=k > n), device=dev)
    return X, idx, sq_norms(X)


# n: a ragged tail of 3 and 1 rows (n % 4 != 0) and fewer rows than one
# task; d: 1 (the SVR path), 3 and 37 (n*d % 4 != 0: the producer stores
# a slab's last floats itself), 784; k: every query-slot template (2, 4,
# 8, 10), one and several subgroups, and k=64, two query groups at d=784
@pytest.mark.parametrize("family", ["rbf", "linear", "poly", "sigmoid"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 20, 33, 64])
@pytest.mark.parametrize("d", [1, 3, 37, 784])
@pytest.mark.parametrize("n", [4099, 4097, 7])
def test_pair_rows_kernel_matches_plain(dev, family, n, d, k):
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel, pair_rows_ref

    X, idx, sn = _pair_rows_inputs(dev, n, d, k)
    need = torch.ones(k, dtype=torch.bool, device=dev)
    kw = dict(family=family, sn=sn, **_FAMILY_KW[family])
    got = pair_rows_kernel(X, idx, need, torch.zeros(k, n, device=dev), **kw)
    want = pair_rows_ref(X, idx, need, torch.zeros(k, n, device=dev), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _PAIR_ROWS_RTOL[family] * scale
    if family == "rbf":
        # each value K(x_i, x_i) of a row's own index is exp(0) = 1 up to
        # the cancellation of the dot form
        own = got[torch.arange(k, device=dev), idx]
        assert float((own - 1.0).abs().max()) <= 1e-5


@pytest.mark.parametrize("family", ["rbf", "poly"])
def test_pair_rows_kernel_skips_and_keeps_bits(dev, family):
    """All need clear: the rows are untouched. Some set: those rows have
    the bits of a full refresh of any k, the others are untouched."""
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel

    n, d, k = 4099, 784, 20
    X, idx, sn = _pair_rows_inputs(dev, n, d, k, seed=1)
    kw = dict(family=family, sn=sn, **_FAMILY_KW[family])
    rows = torch.randn(k, n, device=dev)
    before = rows.clone()
    launches = pair_rows_kernel.launches
    pair_rows_kernel(X, idx, torch.zeros(k, dtype=torch.bool, device=dev), rows,
                     **kw)
    torch.cuda.synchronize()
    assert torch.equal(rows, before)
    assert pair_rows_kernel.launches == launches + 1
    full = pair_rows_kernel(X, idx, torch.ones(k, dtype=torch.bool, device=dev),
                            torch.zeros(k, n, device=dev), **kw)
    need = torch.zeros(k, dtype=torch.bool, device=dev)
    need[[1, 4, 19]] = True
    pair_rows_kernel(X, idx, need, rows, **kw)
    two = pair_rows_kernel(X, idx[[4, 1]], torch.ones(2, dtype=torch.bool,
                                                      device=dev),
                           torch.zeros(2, n, device=dev), **kw)
    torch.cuda.synchronize()
    assert torch.equal(rows[need], full[need])
    assert torch.equal(rows[~need], before[~need])
    assert torch.equal(two, full[[4, 1]])


@pytest.mark.parametrize("family", ["rbf", "sigmoid"])
@pytest.mark.parametrize("n,d,k", [(4099, 784, 20), (4099, 784, 33),
                                   (4099, 784, 64), (999, 784, 256),
                                   (1001, 5000, 2), (1001, 5000, 20),
                                   (257, 6000, 20), (129, 40000, 2),
                                   (65, 50000, 3)])
def test_pair_rows_bits_do_not_depend_on_k_or_need(dev, family, n, d, k):
    """Every row refreshed under a need pattern has the bits of a k=1
    call for its index, and the other rows are untouched; the patterns are
    all set, each flag alone, every other flag and random subsets, at
    k=20 (two slot subgroups), k=33 (four), k=64 and k=256 (two and nine
    query groups at d=784), and at d >= 5000, where no ring of bulk-copy
    stages fits and X and the query rows are read with plain loads, up to
    d=50000, past where a query row would fit in shared memory. Past
    d=5000 gamma shrinks as 784/d, so that gamma * |x - x'|^2 keeps the
    d=784 cases' scale: at gamma=0.01 and d=40000 every RBF value off a
    row's own index is below 1e-28, and the own index's is cancellation
    in sn_i + sn_j - 2 dot alone."""
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel, pair_rows_ref

    X, idx, sn = _pair_rows_inputs(dev, n, d, k, seed=2)
    kw = dict(family=family, sn=sn, **_FAMILY_KW[family])
    if d > 5000:
        kw["gamma"] *= 784 / d
    if d >= 5000:
        want = pair_rows_ref(X, idx, torch.ones(k, dtype=torch.bool, device=dev),
                             torch.zeros(k, n, device=dev), **kw)
        got = pair_rows_kernel(X, idx, torch.ones(k, dtype=torch.bool, device=dev),
                               torch.zeros(k, n, device=dev), **kw)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= _PAIR_ROWS_RTOL[family] * scale
    one = torch.ones(1, dtype=torch.bool, device=dev)
    solo = torch.cat([pair_rows_kernel(X, idx[r:r + 1], one,
                                       torch.zeros(1, n, device=dev), **kw)
                      for r in range(k)])
    rng = np.random.default_rng(k)
    patterns = [np.ones(k, bool), np.arange(k) % 2 == 0]
    patterns += [np.arange(k) == r for r in range(k)]
    patterns += [rng.random(k) < p for p in (0.1, 0.3, 0.5, 0.7, 0.9)]
    for pat in patterns:
        need = torch.as_tensor(pat, device=dev)
        rows = torch.randn(k, n, device=dev)
        before = rows.clone()
        pair_rows_kernel(X, idx, need, rows, **kw)
        torch.cuda.synchronize()
        assert torch.equal(rows[need], solo[need])
        assert torch.equal(rows[~need], before[~need])


def test_pair_rows_kernel_refuses_a_misaligned_x(dev):
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel

    n, d, k = 1000, 37, 2
    buf = torch.rand(n * d + 1, device=dev)
    X = buf[1:].view(n, d)  # contiguous, 4 bytes past an aligned start
    assert X.is_contiguous() and X.data_ptr() % 16 == 4
    idx = torch.tensor([3, 5], device=dev)
    need = torch.ones(k, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pair_rows_kernel(X, idx, need, torch.zeros(k, n, device=dev),
                         family="linear")


@pytest.mark.parametrize("family", ["rbf", "linear", "poly", "sigmoid"])
def test_pair_rows_equals_the_parent_kernel(dev, family):
    """The kernel's rows against an earlier version's, bit for bit, when
    TPUSVM_PARENT_TREE names that version's checkout (such as the parent
    commit unpacked with `git archive` under build/); its pair_rows is
    built there by its own _build.py (scripts/kernel_trees.py)."""
    import os
    import sys
    from pathlib import Path

    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel

    tree = os.environ.get("TPUSVM_PARENT_TREE")
    if not tree:
        pytest.skip("set TPUSVM_PARENT_TREE to an earlier checkout to compare")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from kernel_trees import pair_rows_of

    parent = pair_rows_of(tree)
    for n, d, k in [(4099, 784, 2), (4099, 784, 20), (4097, 1, 2), (7, 3, 3),
                    (1001, 37, 8), (4099, 784, 33), (2003, 784, 64),
                    (1001, 5000, 20), (257, 6000, 20), (129, 40000, 2)]:
        X, idx, sn = _pair_rows_inputs(dev, n, d, k, seed=k)
        kw = dict(family=family, sn=sn, **_FAMILY_KW[family])
        need = torch.as_tensor(np.arange(k) % 3 != 1, device=dev)
        ours = pair_rows_kernel(X, idx, need, torch.zeros(k, n, device=dev), **kw)
        theirs = parent(X, idx, need, torch.zeros(k, n, device=dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(ours, theirs), (n, d, k)


def test_pair_solver_graph_chunk_equals_eager(dev):
    """A captured chunk replayed against the same chunks run eagerly: the
    same alpha, n_iter, status and row refreshes, bit for bit."""
    from tpusvm_torch.data.synthetic import rings
    from tpusvm_torch.solver.smo import smo_solve

    X, Y = rings(n=2000, seed=3)
    Xs = torch.as_tensor((X - X.min(0)) / (X.max(0) - X.min(0)),
                         dtype=torch.float32, device=dev)
    Yt = torch.as_tensor(Y, device=dev)
    kw = dict(C=1.0, gamma=5.0, accum_dtype=torch.float64, max_iter=10**6,
              chunk=64, device="cuda")
    g = smo_solve(Xs, Yt, graph=True, **kw)
    e = smo_solve(Xs, Yt, graph=False, **kw)
    assert g.graphed and not e.graphed and g.chunks > 1
    assert torch.equal(g.alpha, e.alpha)
    assert (g.n_iter, g.status, g.row_refreshes, g.b) == (
        e.n_iter, e.status, e.row_refreshes, e.b)
    assert g.status.name == "CONVERGED"
    assert g.host_syncs == g.chunks + 1


def test_pair_solver_takes_a_misaligned_view(dev):
    """X as a contiguous view 4 bytes past an aligned start (d=3): the
    solver copies it for the kernel's bulk copies and fits as it does on
    a fresh tensor, bit for bit."""
    from tpusvm_torch.data.synthetic import rings
    from tpusvm_torch.solver.smo import smo_solve

    X, Y = rings(n=600, seed=5)
    Xs = ((X - X.min(0)) / (X.max(0) - X.min(0))).astype(np.float32)
    X3 = np.concatenate([Xs, Xs[:, :1]], axis=1)  # d=3
    buf = torch.zeros(X3.size + 1, device=dev)
    buf[1:] = torch.as_tensor(X3.ravel(), device=dev)
    view = buf[1:].view(X3.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    kw = dict(C=1.0, gamma=5.0, accum_dtype=torch.float64, max_iter=10**6,
              device="cuda")
    a = smo_solve(view, torch.as_tensor(Y, device=dev), **kw)
    b = smo_solve(view.clone(), torch.as_tensor(Y, device=dev), **kw)
    assert torch.equal(a.alpha, b.alpha)
    assert (a.n_iter, a.status, a.b) == (b.n_iter, b.status, b.b)
    assert a.status.name == "CONVERGED"


@pytest.mark.parametrize("family", ["rbf", "linear", "poly", "sigmoid"])
def test_pair_solver_on_the_card_matches_the_cpu(dev, family):
    """The card's run (kernel rows, graph chunks) against the CPU's (plain
    rows): the same status and SV-ID set, b in the cross-engine band."""
    from tpusvm_torch.data.synthetic import rings
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel
    from tpusvm_torch.solver.smo import smo_solve

    X, Y = rings(n=600, seed=4)
    Xs = ((X - X.min(0)) / (X.max(0) - X.min(0))).astype(np.float32)
    kw = dict(C=1.0, accum_dtype=torch.float64, max_iter=10**6, kernel=family,
              **{k: v for k, v in _FAMILY_KW[family].items() if k != "gamma"},
              gamma=5.0 if family == "rbf" else 0.5)
    launches = pair_rows_kernel.launches
    c = smo_solve(torch.tensor(Xs), torch.tensor(Y), device="cuda", **kw)
    h = smo_solve(torch.tensor(Xs), torch.tensor(Y), device="cpu", **kw)
    assert pair_rows_kernel.launches > launches
    assert c.status == h.status
    if family != "sigmoid":
        assert c.status.name == "CONVERGED"
    sv = lambda r: set(np.nonzero(r.alpha.numpy() > 1e-8)[0])  # noqa: E731
    assert len(sv(c) ^ sv(h)) <= max(2, len(sv(h)) // 25)
    assert abs(c.b - h.b) <= 1e-3


def test_batched_pair_solver_on_the_card_equals_solo_runs(dev):
    from tpusvm_torch.data.synthetic import mnist_like_multiclass
    from tpusvm_torch.solver.smo import smo_solve, smo_solve_batched

    X, labels = mnist_like_multiclass(n=800, d=64, n_classes=4, noise=30.0)
    Xs = torch.as_tensor((X - X.min(0)) / np.maximum(X.max(0) - X.min(0), 1e-12),
                         dtype=torch.float32, device=dev)
    Ys = np.stack([np.where(labels == c, 1, -1) for c in range(4)]).astype(np.int32)
    kw = dict(C=10.0, gamma=0.05, accum_dtype=torch.float64, max_iter=10**6,
              chunk=32, device="cuda")
    batched = smo_solve_batched(Xs, torch.as_tensor(Ys, device=dev), **kw)
    for k in range(4):
        solo = smo_solve(Xs, torch.as_tensor(Ys[k], device=dev), **kw)
        head = batched.head(k)
        assert torch.equal(head.alpha, solo.alpha)
        assert (head.n_iter, head.status, head.b) == (solo.n_iter, solo.status,
                                                      solo.b)


# ---- slice 7: refine, shrinking, the K-row cache and the loop's carry ----

def _rings_problem(dev, n=1024):
    from tpusvm_torch.data import MinMaxScaler, rings

    X, Y = rings(n=n, seed=11)
    Xs = MinMaxScaler().fit_transform(X).astype(np.float32)
    return (torch.as_tensor(Xs, device=dev), torch.as_tensor(Y, device=dev),
            dict(C=10.0, gamma=10.0, q=256, max_inner=512,
                 accum_dtype=torch.float64, device=dev))


def test_refine_and_unshrink_rebuilds_run_kernel_1(dev):
    """Both rebuilds of f launch the fused f-update on the card and agree
    with its plain version within kernel #1's band, 1e-5 * sum|coef|."""
    from tpusvm_torch.ops.rbf import sq_norms
    from tpusvm_torch.solver.blocked import blocked_smo_solve, refine_f
    from tpusvm_torch.solver.shrink import _rebuild_f

    X, Y, kw = _rings_problem(dev)
    r = blocked_smo_solve(X, Y, **kw)
    yf = Y.double()
    valid = torch.ones_like(Y, dtype=torch.bool)
    sn = sq_norms(X)
    kern = dict(gamma=10.0, coef0=0.0, degree=3)
    tol = 1e-5 * float((r.alpha * yf).abs().sum())
    rbf_cross_matvec_kernel.launches = 0
    got = refine_f(X, r.alpha, yf, yf, valid, 1024, kernel="rbf", sn=sn,
                   kern=kern)
    assert rbf_cross_matvec_kernel.launches == 1
    want = refine_f(X.cpu(), r.alpha.cpu(), yf.cpu(), yf.cpu(), valid.cpu(),
                    1024, kernel="rbf", sn=sn.cpu(), kern=kern)
    assert float((got.cpu() - want).abs().max()) <= tol
    a = r.alpha.cpu().numpy()
    kk = dict(kern, kernel="rbf", kernel_fast=True)
    got = _rebuild_f(X, X, Y, valid, a, Y.float(), kk, sn)
    assert rbf_cross_matvec_kernel.launches == 2
    want = _rebuild_f(X.cpu(), X.cpu(), Y.cpu(), valid.cpu(), a,
                      Y.float().cpu(), kk,
                      sn.cpu())
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.parametrize("extra", [
    {}, dict(refine=1024), dict(krow_cache=512), dict(shrink_stable=3),
    dict(fused_selection=True, wss=1), dict(multipair=2, q=512, wss=1)],
    ids=["kernels", "refine", "krow_cache", "shrink_stable",
         "fused_selection", "multipair"])
def test_pause_and_resume_on_the_card_is_bit_identical(dev, extra):
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    X, Y, kw = _rings_problem(dev)
    kw.update(extra)
    whole, st_whole = blocked_smo_solve(X, Y, return_state=True, **kw)
    state, k = None, 0
    while state is None or state.status == 0:
        k += 1
        res, state = blocked_smo_solve(X, Y, resume_state=state, pause_at=k,
                                       return_state=True, **kw)
    assert torch.equal(res.alpha, whole.alpha)
    assert torch.equal(state.f, st_whole.f)
    assert (res.b, res.n_iter, res.n_outer, res.status) == (
        whole.b, whole.n_iter, whole.n_outer, whole.status)


def test_checkpointed_fit_on_the_card_is_bit_identical(dev, tmp_path):
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.solver.checkpoint import (WatchdogTimeout,
                                                checkpointed_blocked_solve)

    X, Y, kw = _rings_problem(dev)
    plain = blocked_smo_solve(X, Y, **kw)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(WatchdogTimeout):
        checkpointed_blocked_solve(X, Y, checkpoint_path=ck,
                                   checkpoint_every=2, watchdog=lambda: True,
                                   **kw)
    res = checkpointed_blocked_solve(X, Y, checkpoint_path=ck,
                                     checkpoint_every=2, resume=True, **kw)
    assert torch.equal(res.alpha, plain.alpha) and res.b == plain.b


def test_a_misaligned_x_view_solves_as_a_fresh_copy(dev):
    """A compacted bucket's X need not start on a 16-byte boundary: the
    solve on a view 4 bytes past one equals the solve on a fresh copy bit
    for bit (kernel #1's wrapper copies it for its TMA loads)."""
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    X, Y, kw = _rings_problem(dev, n=768)
    X = torch.nn.functional.pad(X, (0, 2))  # d = 4, a 16-byte row pitch
    buf = torch.empty(X.numel() + 1, device=dev)
    Xm = buf[1:].view(X.shape)
    Xm.copy_(X)
    assert Xm.data_ptr() % 16 != 0
    a = blocked_smo_solve(Xm, Y, **kw)
    b = blocked_smo_solve(Xm.clone(), Y, **kw)
    assert torch.equal(a.alpha, b.alpha) and a.b == b.b


def test_shrinking_and_cache_on_the_card_launch_kernels_1_and_2(dev):
    """A shrinking solve launches #1 (its f-updates and un-shrink rebuild)
    and #2; a cached solve launches #2 and takes its f-update from rows.
    Both match the CPU run's SV-ID set, status and b within 1e-4."""
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.solver.shrink import shrinking_blocked_solve

    X, Y, kw = _rings_problem(dev, n=2048)
    cpu = dict(kw, device="cpu")
    for fn, extra in ((shrinking_blocked_solve,
                       dict(shrink_every=2, shrink_stable=2, shrink_min=256)),
                      (blocked_smo_solve, dict(krow_cache=512))):
        rbf_cross_matvec_kernel.launches = inner_smo_kernel.launches = 0
        r = fn(X, Y, **kw, **extra)
        assert inner_smo_kernel.launches > 0
        if fn is shrinking_blocked_solve:
            assert rbf_cross_matvec_kernel.launches > 0
        else:
            assert rbf_cross_matvec_kernel.launches == 0
            assert r.cache_hits + r.cache_misses == 256 * r.n_outer
        c = fn(X.cpu(), Y.cpu(), **cpu, **extra)
        assert r.status == c.status == 1
        sv = lambda a: set(torch.nonzero(a.cpu() > 1e-8).flatten().tolist())
        assert sv(r.alpha) == sv(c.alpha)
        assert abs(r.b - c.b) <= 1e-4


# ---- the fleet's problem-axis launches of #1 and #2 -------------------------

def _lanes_case(dev, B, n, d, q, seed):
    """B working sets over one X: distinct index sets, gammas and Cs, mixed
    cold and mid-solve alphas, inactive members."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.random((n, d)), dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.stack([rng.choice(n, q, replace=False)
                                    for _ in range(B)]), device=dev)
    XB = X[idx]
    gammas = 0.5 + rng.random(B)
    Cs = rng.choice([1.0, 2.5, 10.0], size=B)
    y = torch.as_tensor(np.where(rng.random((B, q)) < 0.5, 1.0, -1.0),
                        dtype=torch.float32, device=dev)
    a = torch.as_tensor(np.where(rng.random((B, q)) < 0.3,
                                 rng.random((B, q)) * Cs[:, None], 0.0),
                        dtype=torch.float32, device=dev)
    f = torch.as_tensor(rng.standard_normal((B, q)), dtype=torch.float32,
                        device=dev) - y
    act = torch.as_tensor(rng.random((B, q)) < 0.95, device=dev)
    K = torch.stack([rbf_cross(XB[b], XB[b], float(gammas[b]))
                     for b in range(B)])
    return X, XB, gammas, Cs, y, a, f, act, K


@pytest.mark.parametrize("B,q,wss,ex", [(4, 256, 1, False), (5, 512, 2, False),
                                        (16, 2048, 2, False), (3, 256, 2, True)])
def test_inner_smo_batched_equals_solo_launches(dev, B, q, wss, ex):
    from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_batched_kernel,
                                                 inner_smo_batched_ref)

    X, XB, gammas, Cs, y, a, f, act, K = _lanes_case(dev, B, 3000, 16, q, B + q)
    args = (K, y, a, f, act, torch.as_tensor(Cs), 1e-12, 1e-5)
    kw = dict(max_inner=1024, wss=wss, eta_exclude=ex)
    a_out, stat = inner_smo_batched_kernel(*args, **kw)
    a_ref, st_ref = inner_smo_batched_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a_out, a_ref) and torch.equal(stat, st_ref)
    for b in range(B):
        a1, s1 = inner_smo_kernel(K[b], y[b], a[b], f[b], act[b],
                                  float(Cs[b]), 1e-12, 1e-5, **kw)
        assert torch.equal(a_out[b], a1) and torch.equal(stat[b], s1)


@pytest.mark.parametrize("B,q,wss,ex", [(4, 256, 1, False), (5, 512, 2, False),
                                        (16, 2048, 2, False), (3, 2176, 2, True)])
def test_boxed_inner_smo_equals_its_plain_version(dev, B, q, wss, ex):
    """The boxed subproblem of seeded lanes (float64 seeds, some within a
    float32 ulp of C), mixed with plain lanes in one launch: the launch
    equals its plain version, and each lane a solo launch (boxed or
    plain), bit for bit; q = 2176 keeps members in shared memory."""
    from tpusvm_torch.ops.cuda.inner_smo import (boxed_operands,
                                                 inner_smo_batched_kernel,
                                                 inner_smo_batched_ref)

    X, XB, gammas, Cs, y, a, f, act, K = _lanes_case(dev, B, 3000, 16, q, B + q)
    rng = np.random.default_rng(q)
    C_t = torch.as_tensor(Cs, device=dev)[:, None]
    a64 = a.double() * (1 - 1e-9 * torch.as_tensor(rng.random((B, q)),
                                                   device=dev))
    near = torch.as_tensor(rng.random((B, q)) < 0.2, device=dev)
    a64 = torch.where(near, C_t - 1e-7 * torch.as_tensor(
        rng.random((B, q)), device=dev), a64)
    f64 = f.double()
    boxed = torch.as_tensor(np.arange(B) % 2 == 0, device=dev)
    d0, f_c, lo, hi = boxed_operands(a64, f64, C_t, q // 2)
    a_in = torch.where(boxed[:, None], d0.double(), a64)
    f_in = torch.where(boxed[:, None], f_c.double(), f64)
    args = (K, y, a_in, f_in, act, torch.as_tensor(Cs), 1e-12, 1e-5)
    kw = dict(max_inner=1024, wss=wss, eta_exclude=ex)
    a_out, stat = inner_smo_batched_kernel(*args, box=(lo, hi, boxed), **kw)
    a_ref, st_ref = inner_smo_batched_ref(*args, box=(lo, hi, boxed), **kw)
    torch.cuda.synchronize()
    assert torch.equal(a_out, a_ref) and torch.equal(stat, st_ref)
    for b in range(B):
        box = (lo[b], hi[b]) if bool(boxed[b]) else None
        a1, s1 = inner_smo_kernel(K[b], y[b], a_in[b], f_in[b], act[b],
                                  float(Cs[b]), 1e-12, 1e-5, box=box, **kw)
        assert torch.equal(a_out[b], a1) and torch.equal(stat[b], s1)


@pytest.mark.parametrize("B,n,d,q", [(4, 4099, 784, 512), (3, 1000, 37, 200),
                                     (16, 4000, 64, 2048)])
def test_fused_fupdate_batched_equals_solo_launches(dev, B, n, d, q):
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        rbf_cross_matvec_batched_kernel, rbf_cross_matvec_batched_ref)
    from tpusvm_torch.ops.rbf import sq_norms

    X, XB, gammas, *_ = _lanes_case(dev, B, n, d, q, n + q)
    gammas = gammas * 0.01
    rng = np.random.default_rng(q)
    coef = torch.as_tensor(rng.standard_normal((B, q)), dtype=torch.float32,
                           device=dev)
    sn = sq_norms(X)
    got = rbf_cross_matvec_batched_kernel(X, XB, coef, torch.as_tensor(gammas),
                                          sn)
    want = rbf_cross_matvec_batched_ref(X, XB, coef, gammas, sn)
    torch.cuda.synchronize()
    for b in range(B):
        solo = rbf_cross_matvec_kernel(X, XB[b].contiguous(), coef[b],
                                       float(gammas[b]), sn)
        assert torch.equal(got[b], solo)
        assert float((got[b] - want[b]).abs().max()) <= \
            1e-5 * float(coef[b].abs().sum())


@pytest.mark.parametrize("precision", ["bf16_f32", "bf16_f32c", "raw_bf16"])
def test_matmul_p_on_the_card_matches_the_cpu(dev, precision):
    """The rungs on the card against their CPU version (bf16 operands
    upcast and multiplied at full f32) within 2^-9 sum|a||b|, and the
    backend flags restored after each call."""
    from tpusvm_torch.ops.rbf import matmul_p

    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.random((513, 784)), dtype=torch.float32)
    B = torch.as_tensor(rng.random((784, 300)), dtype=torch.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    got = matmul_p(A.to(dev), B.to(dev), precision).cpu()
    want = matmul_p(A, B, precision)
    band = 2.0 ** -9 * (A.abs() @ B.abs())
    assert got.dtype == torch.float32
    assert bool(((got - want).abs() <= band).all())
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


def test_fleet_on_the_card_equals_solo_solves_and_launches_the_problem_axis(dev):
    """Each fleet lane equals the solo blocked solve on the card (the kernel
    engine, the fused f-update) bit for bit; the fleet launches the
    problem-axis #2 and #1 and no solo #2; lanes are bit-identical with
    their companions reordered."""
    from tpusvm_torch.fleet import fleet_train
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        rbf_cross_matvec_batched_kernel)
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_batched_kernel
    from tpusvm_torch.solver.blocked import blocked_smo_solve

    X, Y, kw = _rings_problem(dev, n=1024)
    Ys = [Y, -Y, torch.where(torch.arange(1024, device=dev) % 3 == 0, 1, -1)]
    Cs, gs = [10.0, 1.0, 2.0], [10.0, 5.0, 2.0]
    opts = dict(q=256, max_inner=512, accum_dtype=torch.float64, wss=2)
    for fn in (inner_smo_batched_kernel, rbf_cross_matvec_batched_kernel,
               inner_smo_kernel):
        fn.launches = 0
    fl = fleet_train(X, Ys, Cs, gs, device=dev, **opts)
    assert inner_smo_batched_kernel.launches > 0
    assert rbf_cross_matvec_batched_kernel.launches > 0
    assert inner_smo_kernel.launches == 0
    for r, y, C, g in zip(fl, Ys, Cs, gs):
        solo = blocked_smo_solve(X, y, C=C, gamma=g, device=dev, inner="kernel",
                                 fused_fupdate=True, **opts)
        assert torch.equal(r.alpha, solo.alpha) and float(r.b) == solo.b
    rev = fleet_train(X, Ys[::-1], Cs[::-1], gs[::-1], device=dev, **opts)
    for a, b in zip(fl, rev[::-1]):
        assert torch.equal(a.alpha, b.alpha)


def test_float64_features_solve_on_the_card_in_float64_without_kernels(dev):
    # the kernels take float32 only: float64 X resolves to the torch
    # engines in float64 on the card, and an explicit kernel is refused
    from tpusvm_torch.data import rings
    from tpusvm_torch.data.scaler import MinMaxScaler
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.status import Status

    X, Y = rings(n=512, seed=5)
    X = torch.as_tensor(MinMaxScaler().fit_transform(X), dtype=torch.float64,
                        device=dev)
    Y = torch.as_tensor(Y, device=dev)
    kw = dict(C=10.0, gamma=10.0, q=128, max_inner=256,
              accum_dtype=torch.float64, device=dev)
    before = (rbf_cross_matvec_kernel.launches, inner_smo_kernel.launches)
    r = blocked_smo_solve(X, Y, **kw)
    cpu = blocked_smo_solve(X.cpu(), Y.cpu(), **dict(kw, device="cpu"))
    assert (rbf_cross_matvec_kernel.launches, inner_smo_kernel.launches) \
        == before
    assert r.alpha.dtype == torch.float64
    assert r.status == cpu.status == Status.CONVERGED
    sv = set(torch.nonzero(r.alpha > 1e-8).flatten().tolist())
    assert sv == set(torch.nonzero(cpu.alpha > 1e-8).flatten().tolist())
    assert abs(float(r.b) - float(cpu.b)) <= 1e-4
    for engine in (dict(inner="kernel"), dict(fused_fupdate=True)):
        with pytest.raises(ValueError, match="float64"):
            blocked_smo_solve(X, Y, **kw, **engine)


def test_pod_on_the_card_equals_the_inprocess_cascade(dev, tmp_path):
    # two worker processes on the card, blocked leaves: the in-process
    # cascade's bits, #1 and #2 launched in each worker
    from tpusvm_torch.config import CascadeConfig
    from tpusvm_torch.parallel.cascade import cascade_fit
    from tpusvm_torch.pod import pod_fit
    from tpusvm_torch.stream import ingest_arrays, open_dataset

    X, Y = mnist_like(n=4096, d=64, seed=3)
    ingest_arrays(str(tmp_path / "ds"), X, Y, rows_per_shard=1024)
    ds = open_dataset(str(tmp_path / "ds"))
    cfg = SVMConfig(C=10.0, gamma=0.02)
    cc = CascadeConfig(n_shards=2, sv_capacity=1024, topology="star")
    opts = dict(q=256, max_inner=512)
    res = pod_fit(str(tmp_path / "ds"), cfg, cc, solver="blocked",
                  solver_opts=opts, device=dev)
    ctrl = cascade_fit(ds.scaler().transform(X), Y, cfg, cc,
                       solver="blocked", solver_opts=opts, device=dev)
    assert res.converged and np.array_equal(res.sv_ids, ctrl.sv_ids)
    assert res.sv_alpha.tobytes() == ctrl.sv_alpha.tobytes()
    assert res.b == ctrl.b and res.rounds == ctrl.rounds
    for w in res.worker_launches:
        assert w.get("fused_fupdate", 0) > 0 and w.get("inner_smo", 0) > 0


def _serve_model(dev, kind):
    """A small fitted model of `kind` and rows to score with it."""
    from tpusvm_torch.data import rings
    from tpusvm_torch.models import OneVsRestSVC

    X, Y = rings(n=240, seed=2)
    if kind == "ovr":
        rng = np.random.default_rng(0)
        centers = np.array([[0, 0], [6, 0], [0, 6], [6, 6]], float)
        lm = rng.integers(0, 4, 300).astype(np.int32)
        Xm = centers[lm] + rng.normal(0, 0.8, (300, 2))
        return OneVsRestSVC(SVMConfig(C=10.0, gamma=2.0), solver="blocked",
                            device=dev).fit(Xm, lm), Xm
    cfg = {"binary": SVMConfig(C=10.0, gamma=10.0),
           "poly": SVMConfig(C=1.0, gamma=1.0, kernel="poly", coef0=1.0),
           "rff": SVMConfig(C=10.0, gamma=10.0, kernel="rff",
                            rff_dim=256)}[kind]
    return BinarySVC(cfg, device=dev).fit(X, Y), X


@pytest.mark.parametrize("kind", ["binary", "poly", "rff", "ovr"])
def test_serve_graph_replay_equals_eager_and_decision_function(dev, kind,
                                                               tmp_path):
    """At every bucket: the captured graph's replay, the bucket program run
    eagerly on the worker's stream and on the default stream, and the
    estimator's decision_function on the default stream, bit for bit; and
    through the batcher at every row count 1..max_batch."""
    from tpusvm_torch.serve import ServeConfig, Server

    est, X = _serve_model(dev, kind)
    path = str(tmp_path / "m.npz")
    est.save(path)
    rng = np.random.default_rng(5)
    Xq = X[rng.permutation(len(X))[:64]]
    with Server(ServeConfig(max_batch=16), device="cuda") as srv:
        srv.load_model("m", path)
        assert srv.warmup() == {"m": 5}
        w = srv._worker("m")
        assert w.cache.graphed
        for b in w.cache.buckets:
            rows = w.entry.scale(w.entry.validate_rows(Xq[:b]))
            replay, _ = w.cache.scores(rows)
            side = w.cache.eager_scores(rows)
            default = w.cache.eager_scores(
                rows, stream=torch.cuda.current_stream())
            want = np.asarray(est.decision_function(Xq[:b]))
            assert replay.tobytes() == side.tobytes() == default.tobytes() \
                == want.tobytes(), b
        for m in range(1, 17):
            res = srv.submit_many("m", Xq[:m])
            assert all(r.ok for r in res)
            got = np.stack([np.asarray(r.scores) for r in res])
            assert got.tobytes() == np.asarray(
                est.decision_function(Xq[:m])).tobytes(), m
        assert srv.metrics("m")["recompiles"] == 0


def test_serve_swap_under_load_on_the_card_keeps_memory_flat(dev, tmp_path):
    """Four clients stream rows while eight swaps alternate two models:
    every response is one generation's bits, none is lost, and the device
    memory after a swap equals that after the swap two before (the same
    model serving)."""
    import gc
    import threading

    from tpusvm_torch.data import rings
    from tpusvm_torch.serve import ServeConfig, Server

    Xa, Ya = rings(n=240, seed=2)
    Xb, Yb = rings(n=240, seed=9)
    A = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=dev).fit(Xa, Ya)
    B = BinarySVC(SVMConfig(C=10.0, gamma=5.0), device=dev).fit(Xb, Yb)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    A.save(pa)
    B.save(pb)
    Xq, _ = rings(n=32, seed=3)
    refA = np.asarray(A.decision_function(Xq))
    refB = np.asarray(B.decision_function(Xq))
    assert refA.tobytes() != refB.tobytes()
    bad, served, mem = [], [0], []
    lock = threading.Lock()
    stop = threading.Event()
    gc.collect()  # earlier tests' servers: garbage freed now, not mid-loop
    with Server(ServeConfig(max_batch=8), device="cuda") as srv:
        srv.load_model("m", pa)
        srv.warmup()

        def client(t):
            i = t
            while not stop.is_set():
                r = srv.submit("m", Xq[i % 32], timeout_s=30.0)
                with lock:
                    if not r.ok:
                        bad.append(r.status)
                    elif r.scores not in (refA[i % 32], refB[i % 32]):
                        bad.append(float(r.scores))
                    else:
                        served[0] += 1
                i += 4

        ts = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        for k in range(8):
            srv.swap("m", pb if k % 2 == 0 else pa)
            torch.cuda.synchronize()
            # the bytes the live tensors requested: the allocated bytes
            # add the slack of whichever cached blocks served them
            mem.append((torch.cuda.memory_stats()["requested_bytes.all.current"],
                        torch.cuda.memory_reserved()))
        stop.set()
        for t in ts:
            t.join(30.0)
        assert not any(t.is_alive() for t in ts)
        assert srv.registry.generation("m") == 9
    assert not bad and served[0] > 0
    assert [m[0] for m in mem[2:]] == [m[0] for m in mem[:-2]], mem


def test_autopilot_kill_arm_on_the_card_resumes_bit_for_bit(dev, tmp_path):
    """Phase 23(a)'s kill arm at a small size: the autopilot's seeded
    refresh, killed at its first solver checkpoint and resumed by a
    rebuilt supervisor, equals a direct refresh_fit of its donor on the
    same rows bit for bit, and its fit launched #1 and #2."""
    from tpusvm_torch import faults
    from tpusvm_torch.autopilot import (Autopilot, AutopilotConfig,
                                        DriftThresholds)
    from tpusvm_torch.serve.refresh import refresh_fit
    from tpusvm_torch.status import AutopilotStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset

    X, Y = mnist_like(n=4096, d=64, noise=30, label_noise=0.005, seed=587)
    opts = dict(q=256, wss=2, max_inner=512)
    data = str(tmp_path / "data")
    ingest_arrays(data, X[:3072], Y[:3072], rows_per_shard=1024)
    donor = str(tmp_path / "donor.npz")
    BinarySVC(SVMConfig(C=10.0, gamma=1.0 / 64), solver_opts=opts,
              device=dev).fit(X[:3072], Y[:3072]).save(donor)
    cfg = AutopilotConfig(
        data_dir=data, model_path=donor, out_path=str(tmp_path / "g.npz"),
        thresholds=DriftThresholds(growth=0.1, feature=None, score=None),
        checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=1,
        seed=1, device="cuda")
    pilot = Autopilot(cfg, log_fn=None)
    w = ShardWriter.open_append(data)
    w.append(X[3072:], Y[3072:])
    w.close()
    plan = faults.FaultPlan([faults.FaultRule(
        point="solver.outer_checkpoint", kind="kill", at_hit=2)], seed=0)
    with pytest.raises(faults.SimulatedKill):
        with faults.active(plan):
            pilot.tick()
    for fn in (rbf_cross_matvec_kernel, inner_smo_kernel):
        fn.launches = 0
    out = Autopilot(cfg, resume=True, log_fn=None).tick()
    assert out["status"] == AutopilotStatus.REFRESHED
    assert rbf_cross_matvec_kernel.launches > 0 and inner_smo_kernel.launches > 0
    Xg, Yg = open_dataset(data).load_arrays()
    plain = refresh_fit(donor, Xg, Yg, out_path=str(tmp_path / "p.npz"),
                        device=dev)
    got = BinarySVC.load(cfg.out_path, device=dev)
    assert plain.status_.name == "CONVERGED"
    assert got.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()
    assert np.array_equal(got.sv_ids_, plain.sv_ids_) and got.b_ == plain.b_


def test_tenants_kill_arm_on_the_card_resumes_bit_for_bit(dev, tmp_path):
    """Phase 23(b)'s kill arm at a small size: a coalesced warm refresh of
    eight tenants (phase 23's C palette) killed at its second
    fleet-checkpoint write and resumed equals the uninterrupted launch bit
    for bit; the launches ran the problem-axis #1 and #2 (1b, 2b)."""
    from tpusvm_torch import faults
    from tpusvm_torch.data.synthetic import mnist_like_multiclass
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        rbf_cross_matvec_batched_kernel)
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_batched_kernel
    from tpusvm_torch.tenants import (TenantRecord, provision_tenants,
                                      refresh_drifted)

    Xm, lm = mnist_like_multiclass(n=3000, d=64, noise=30.0)
    opts = dict(q=256, wss=2, max_inner=512)

    def records():
        return [TenantRecord(f"t{i}", positive_label=i % 10,
                             C=(2.5, 10.0, 40.0)[i % 3],
                             gamma=(0.5, 1.0, 2.0)[(i // 3) % 3] / 64,
                             row_mod=2 if i % 8 == 7 else None)
                for i in range(8)]

    donors = str(tmp_path / "donors")
    recs = records()
    for fn in (inner_smo_batched_kernel, rbf_cross_matvec_batched_kernel):
        fn.launches = 0
    provision_tenants(Xm[:2500], lm[:2500], recs, artifacts_dir=donors,
                      solver_opts=opts, device="cuda")
    assert inner_smo_batched_kernel.launches > 0
    assert rbf_cross_matvec_batched_kernel.launches > 0

    def run(name, plan=None):
        rs = records()
        for r in rs:
            r.model_path = f"{donors}/{r.tenant_id}.npz"
        kw = dict(artifacts_dir=str(tmp_path / name), checkpoint_every=2,
                  resume=True, solver_opts=opts, device="cuda")
        if plan is not None:
            with pytest.raises(faults.SimulatedKill):
                with faults.active(plan):
                    refresh_drifted(Xm, lm, rs, **kw)
        return refresh_drifted(Xm, lm, rs, **kw)

    ctl = run("ctl")
    got = run("kill", faults.FaultPlan([faults.FaultRule(
        point="tenants.store", kind="kill", at_hit=2)], seed=0))
    for tid, o in ctl.items():
        assert o["mode"] == "fleet" and o["status"].name == "CONVERGED"
        # the seeded rounds ran in the boxed kernel, none on the loop engine
        assert o["n_rescue"] == 0, (tid, o)
        a = np.load(o["out_path"])
        b = np.load(got[tid]["out_path"])
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), f"{tid}:{k}"


def test_router_over_two_card_replicas_keeps_decision_function_bits(
        dev, tmp_path):
    """Two in-process replicas on the card behind the router and its HTTP
    front: every routed score is the artifact's decision_function bits on
    the card, with the placed replica's listener stopped midway (failover
    to the other), and the fleet view counts every routed request."""
    import json
    import urllib.request

    from tpusvm_torch.data import rings
    from tpusvm_torch.obs.registry import MetricsRegistry
    from tpusvm_torch.router import Router, RouterConfig, make_router_http
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.http import (make_http_server, start_http_thread,
                                         stop_http_server)

    X, Y = rings(n=240, seed=2)
    path = str(tmp_path / "m.npz")
    BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=dev).fit(X, Y).save(path)
    Xq, _ = rings(n=64, seed=3)
    from tpusvm_torch.models import load_any

    want = np.asarray(load_any(path, device="cuda").decision_function(Xq))
    servers, fronts = [], []
    for _ in range(2):
        srv = Server(ServeConfig(max_batch=8), device="cuda")
        srv.load_model("m", path)
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        servers.append(srv)
        fronts.append(httpd)
    urls = [f"http://{h.server_address[0]}:{h.server_address[1]}"
            for h in fronts]
    router = Router(RouterConfig(replicas=tuple(urls), replication=2,
                                 poll_interval_s=10.0),
                    registry=MetricsRegistry(), log_fn=None)
    router.poller.poll_once()
    httpd = make_router_http(router, port=0)
    router.attach_http(httpd, start_http_thread(httpd))
    base = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    try:
        got = []
        for i in range(len(Xq)):
            if i == len(Xq) // 2:
                placed = router.replica_set.placement("m")[0]
                stop_http_server(fronts[urls.index(placed)])
            req = urllib.request.Request(
                base + "/v1/models/m:predict",
                data=json.dumps({"instances": [Xq[i].tolist()]}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got.append(json.loads(r.read())["scores"][0])
        assert np.asarray(got, np.float32).tobytes() == want.tobytes()
        # every request scored once, over the two replicas together (the
        # dark one has no listener to scrape: read its payload in-process)
        from tpusvm_torch.obs.fleet import merge_fleet

        merged = merge_fleet([s.fleet_snapshot() for s in servers]
                             + [router.fleet_payload()])
        total = {n: sum(e["value"] for e in merged["metrics"]
                        if e["name"] == n)
                 for n in ("serve.ok", "router.requests", "router.failovers")}
        assert total["serve.ok"] == total["router.requests"] == len(Xq)
        assert total["router.failovers"] > 0
    finally:
        router.close()
        for srv in servers:
            srv.close()


def test_train_profile_records_cuda_activity_of_kernels_1_and_2(dev, tmp_path):
    # --profile on the card: a torch.profiler trace naming the launches of
    # the f-update (#1) and the inner subproblem (#2); --trace beside it
    # names the capture dir, and the fit's bits are the unprofiled fit's
    import os

    from tpusvm_torch.cli import main
    from tpusvm_torch.obs import read_trace

    prof_dir = str(tmp_path / "prof")
    trace = str(tmp_path / "t.jsonl")
    flags = ["train", "--synthetic", "mnist_like", "--n", "3000", "--n-test",
             "500", "--d", "64", "--C", "10", "--gamma", "0.02", "--q", "256"]
    assert main(flags + ["--profile", prof_dir, "--trace", trace,
                         "--save", str(tmp_path / "a.npz")]) == 0
    assert main(flags + ["--save", str(tmp_path / "b.npz")]) == 0
    with open(os.path.join(prof_dir, "trace.json")) as f:
        text = f.read()
    assert "rbf_cross_matvec_kernel" in text and "inner_smo_kernel" in text
    recs = read_trace(trace)
    assert [r["attrs"]["dir"] for r in recs if r["kind"] == "event"
            and r["name"] == "profile.capture"] == [prof_dir]
    with np.load(str(tmp_path / "a.npz")) as a, \
            np.load(str(tmp_path / "b.npz")) as b:
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_pair_chunk_graph_capture_is_one_compile_record(dev):
    from tpusvm_torch.obs import prof
    from tpusvm_torch.obs.registry import MetricsRegistry

    X, Y = mnist_like(n=2000, d=64, seed=3)
    cfg = SVMConfig(C=10.0, gamma=0.02)
    plain = BinarySVC(cfg, solver="pair", device="cuda").fit(X, Y)
    events = []
    with prof.profiling(registry=MetricsRegistry(),
                        event_sink=lambda n, **a: events.append(a)):
        on = BinarySVC(cfg, solver="pair", device="cuda").fit(X, Y)
    assert on.sv_alpha_.tobytes() == plain.sv_alpha_.tobytes()
    assert on.b_ == plain.b_
    recs = [e for e in events if e["executable"] == "solver.pair_chunk"]
    assert len(recs) == 1 and recs[0]["compile_s"] > 0
    assert recs[0]["cost_available"] is False and recs[0]["rows"] == 2000
