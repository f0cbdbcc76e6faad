"""The bf16 matmul_precision rungs in the port, on the CPU.

`matmul_p` on each rung against the JAX package's `matmul_p` on the same
numpy operands (made from a seed): the operands' bfloat16 rounding is
bit-equal and the sums agree within 2^-9 * sum|a||b| (both packages sum
exact bf16 x bf16 products in f32, in their own order). The resolver's
refusals and the blocked solver's pairing rules raise where the JAX
package's do. There is no live JAX reference for the shrinking driver's
drift guard on this tree (the JAX package's own test of it fails), so the
bf16 solves are held to the port's f32 solve and to the f64 oracle by the
gates of benchmarks/solver_ladder.py: CONVERGED, SV-set flips <=
max(2, |SV|/25), |b - b_f32| <= 1e-3; and the torch.backends flags are
unchanged after every solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.config import RAW_BF16 as J_RAW
from tpusvm.config import resolve_matmul_precision as j_resolve
from tpusvm.ops.rbf import matmul_p as j_matmul_p
from tpusvm.solver.blocked import blocked_smo_solve as j_solve
from tpusvm_torch.config import RAW_BF16, SVMConfig, resolve_matmul_precision
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                         mnist_like)
from tpusvm_torch.ops.rbf import coef_matvec, matmul_p
from tpusvm_torch.oracle import smo_train
from tpusvm_torch.solver.blocked import (blocked_smo_solve,
                                         resolve_solver_config)
from tpusvm_torch.solver.shrink import shrinking_blocked_solve
from tpusvm_torch.status import Status

jax.config.update("jax_enable_x64", True)

RUNGS = ["float32", "highest", "bf16_f32", "bf16_f32c", "raw_bf16"]


def _operands(seed, m=37, k=300, n=19):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    B = rng.random((k, n)).astype(np.float32)
    return A, B


def test_raw_token_is_the_jax_token():
    assert RAW_BF16 == J_RAW


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_matmul_p_matches_jax(rung, seed):
    A, B = _operands(seed)
    got = matmul_p(torch.tensor(A), torch.tensor(B), rung).numpy()
    want = np.asarray(j_matmul_p(jnp.asarray(A), jnp.asarray(B), rung))
    assert got.dtype == np.float32 and want.dtype == np.float32
    band = 2.0 ** -9 * (np.abs(A).astype(np.float64) @ np.abs(B))
    assert (np.abs(got.astype(np.float64) - want) <= band).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_operand_rounding_is_bit_equal(seed):
    A, B = _operands(seed)
    t = torch.tensor(A).to(torch.bfloat16).view(torch.int16).numpy()
    j = np.asarray(jnp.asarray(A).astype(jnp.bfloat16)).view(np.int16)
    assert np.array_equal(t, j)
    # the compensated rung's residual too
    tr = (torch.tensor(A) - torch.tensor(A).to(torch.bfloat16).float()).to(
        torch.bfloat16).view(torch.int16).numpy()
    ja = jnp.asarray(A)
    jr = np.asarray((ja - ja.astype(jnp.bfloat16).astype(jnp.float32)).astype(
        jnp.bfloat16)).view(np.int16)
    assert np.array_equal(tr, jr)


@pytest.mark.parametrize("rung", ["bf16_f32", "bf16_f32c"])
def test_bf16_product_keeps_the_f32_accumulator(rung):
    """The f32 sums are returned as they are, not rounded to bf16: some
    entries are not bf16 values, and bf16_f32 is the f64 product of the
    rounded operands to f32 summation error (1e-6 relative)."""
    A, B = _operands(3)
    got = torch.tensor(matmul_p(torch.tensor(A), torch.tensor(B), rung).numpy())
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    if rung == "bf16_f32":
        Ab = torch.tensor(A).to(torch.bfloat16).double()
        Bb = torch.tensor(B).to(torch.bfloat16).double()
        err = (got.double() - Ab @ Bb).abs()
        assert bool((err <= 1e-6 * (Ab.abs() @ Bb.abs())).all())


def test_coef_matvec_stays_full_f32_on_the_bf16_rungs():
    A, B = _operands(4)
    v = torch.tensor(B[:, 0])
    full = coef_matvec(torch.tensor(A), v)
    for rung in ("bf16_f32", "bf16_f32c", "float32"):
        assert torch.equal(coef_matvec(torch.tensor(A), v, rung), full)


@pytest.mark.parametrize("bad", ["default", "bf16", "tf32"])
def test_resolver_refusals_match_jax(bad):
    with pytest.raises(ValueError) as t_err:
        resolve_matmul_precision(bad)
    with pytest.raises(ValueError) as j_err:
        j_resolve(bad)
    if bad == "default":
        assert "RAW SINGLE-PASS" in str(t_err.value)
        assert "RAW SINGLE-PASS" in str(j_err.value)
    for p in (None, "float32", "highest", "bf16_f32", "bf16_f32c", RAW_BF16):
        assert resolve_matmul_precision(p) == j_resolve(p)


def _data(n=256, d=16):
    X, Y = mnist_like(n=n, d=d, noise=BENCH_NOISE,
                      label_noise=BENCH_LABEL_NOISE, seed=587)
    return MinMaxScaler().fit_transform(X).astype(np.float32), Y


_BASE = dict(C=10.0, gamma=0.00125 * 784 / 16, tau=1e-5, q=64, max_inner=256,
             max_iter=10**7)


@pytest.mark.parametrize("kw", [
    dict(matmul_precision="bf16_f32"),
    dict(matmul_precision="bf16_f32c"),
    dict(matmul_precision="default"),
    dict(matmul_precision="default", refine=0, max_refines=2),
    dict(matmul_precision="bf16_f32", refine=64, max_refines=0),
    dict(matmul_precision="fp8"),
])
def test_pairing_errors_raise_where_jax_raises(kw):
    X, Y = _data(64, 4)
    with pytest.raises(ValueError):
        blocked_smo_solve(X, Y, device="cpu", **_BASE, **kw)
    with pytest.raises(ValueError):
        j_solve(jnp.asarray(X), jnp.asarray(Y), **_BASE, **kw)


@pytest.mark.parametrize("rung", ["bf16_f32", "bf16_f32c", "default"])
def test_fused_fupdate_refused_on_the_reduced_rungs(rung):
    assert resolve_solver_config(60000, 2048, matmul_precision=rung)[2] is False
    assert resolve_solver_config(60000, 2048)[2] is True
    with pytest.raises(ValueError, match="full-f32"):
        resolve_solver_config(60000, 2048, fused_fupdate=True,
                              matmul_precision=rung)
    X, Y = _data(256, 16)
    with pytest.raises(ValueError, match="full-f32"):
        blocked_smo_solve(X, Y, device="cpu", fused_fupdate=True, refine=256,
                          **dict(_BASE, q=128), matmul_precision=rung)


def test_shrinking_refuses_raw_single_pass():
    X, Y = _data(64, 4)
    with pytest.raises(ValueError, match="raw single pass"):
        shrinking_blocked_solve(X, Y, device="cpu", matmul_precision="default",
                                refine=64, **_BASE)


def _flags():
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            getattr(m, "fp32_precision", None))


def _sv(alpha):
    return set(np.nonzero(np.asarray(alpha) > 1e-8)[0].tolist())


@pytest.fixture(scope="module")
def f32_reference():
    X, Y = _data()
    r = blocked_smo_solve(X, Y, device="cpu", accum_dtype=torch.float64,
                          **_BASE)
    assert r.status == Status.CONVERGED
    o = smo_train(X, Y, SVMConfig(C=_BASE["C"], gamma=_BASE["gamma"],
                                  max_iter=10**7))
    return X, Y, r, o


def _ladder_gates(res, ref):
    sv0 = _sv(ref.alpha)
    assert res.status == Status.CONVERGED
    assert len(_sv(res.alpha) ^ sv0) <= max(2, len(sv0) // 25)
    assert abs(res.b - ref.b) <= 1e-3


@pytest.mark.parametrize("rung,drive", [
    ("bf16_f32", "refine"), ("bf16_f32c", "refine"), ("default", "refine"),
    ("bf16_f32", "shrink"), ("bf16_f32c", "shrink")])
def test_bf16_solves_meet_the_ladder_gates(f32_reference, rung, drive):
    """Against the port's f32 solve and the f64 oracle; the backend flags
    are the same before and after."""
    X, Y, ref, oracle = f32_reference
    before = _flags()
    kw = dict(_BASE, accum_dtype=torch.float64, device="cpu",
              matmul_precision=rung)
    if drive == "refine":
        res = blocked_smo_solve(X, Y, refine=len(Y), max_refines=2, **kw)
        assert res.n_refines >= 1
    else:
        res, hist = shrinking_blocked_solve(
            X, Y, shrink_every=4, shrink_stable=2, shrink_min=64,
            return_history=True, **kw)
        events = {h["event"] for h in hist}
        # the drift guard ran: a rebuild ended the bf16 phase, either by
        # the anneal or by a verified claim
        assert events & {"anneal", "verify"}
    assert _flags() == before
    _ladder_gates(res, ref)
    sv_o = _sv(oracle.alpha)
    assert len(_sv(res.alpha) ^ sv_o) <= max(2, len(sv_o) // 25)
    assert abs(res.b - oracle.b) <= 1e-3


def test_flags_restored_when_they_were_set():
    """matmul_p switches the flags for its product and puts back whatever
    it found, also a non-default setting."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    try:
        m.allow_bf16_reduced_precision_reduction = True
        A, B = _operands(5)
        for rung in ("bf16_f32", "bf16_f32c", RAW_BF16):
            matmul_p(torch.tensor(A), torch.tensor(B), rung)
            assert m.allow_bf16_reduced_precision_reduction is True
            assert m.allow_tf32 is saved[0]
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def test_cli_precision_flag(tmp_path, capsys):
    from tpusvm_torch.cli import main

    args = ["train", "--synthetic", "rings", "--n", "300", "--n-test", "100",
            "--gamma", "5", "--C", "1", "--q", "128", "--device", "cpu",
            "--precision", "bf16_f32", "--solver-opt", "refine=300",
            "--save", str(tmp_path / "m.npz")]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "status = CONVERGED" in out
    from tpusvm_torch.models import BinarySVC

    assert BinarySVC.load(str(tmp_path / "m.npz"),
                          device="cpu").train_precision_ == "bf16_f32"
    for bad, msg in (
            (["--precision", "bf16_f32", "--solver-opt",
              "matmul_precision=bf16_f32c"], "same knob"),
            (["--precision", "bf16_f32", "--solver", "pair"], "ladder knob"),
            (["--precision", "bf16_f32", "--mode", "oracle"], "no effect")):
        with pytest.raises(SystemExit, match=msg):
            main(["train", "--synthetic", "rings", "--n", "100",
                  "--device", "cpu"] + bad)
