"""The port's SV buffers and partition against the JAX package's, bit for bit.

Band: every output field equal bit for bit (floats compared as their bit
patterns, so -0.0 and +0.0 differ) and every count equal, on inputs made
from a seed with numpy: duplicate IDs inside and across the two sets,
invalid rows between valid ones, counts above the output capacity, empty
buffers, and alpha of float32 and float64. `partition` (contiguous,
stratified, n < P) equals tpusvm.data.partition.partition exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusvm.data.partition import partition as j_partition
from tpusvm.parallel import cascade as j_cascade
from tpusvm.parallel import svbuffer as jsb
from tpusvm_torch.data.partition import partition as t_partition
from tpusvm_torch.parallel import cascade as t_cascade
from tpusvm_torch.parallel import svbuffer as tsb


def _np_buf(rng, cap, d, dtype, alpha_dtype=None, id_range=12, p_valid=0.7):
    """Numpy fields of a buffer: ids drawn from a small range (so they
    repeat), a random validity mask (invalid rows between valid ones)."""
    ids = rng.integers(0, id_range, cap).astype(np.int32)
    valid = rng.random(cap) < p_valid
    ids = np.where(valid, ids, -1).astype(np.int32)
    return dict(
        X=rng.standard_normal((cap, d)).astype(dtype),
        Y=np.where(valid, np.where(rng.random(cap) < 0.5, 1, -1),
                   0).astype(np.int32),
        alpha=np.where(valid, rng.random(cap), 0.0).astype(
            alpha_dtype or dtype),
        ids=ids,
        valid=valid,
    )


def _jax(f):
    return jsb.SVBuffer(**{k: jnp.asarray(v) for k, v in f.items()})


def _torch(f):
    return tsb.SVBuffer(**{k: torch.as_tensor(v) for k, v in f.items()})


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a


def _same(jbuf, tbuf):
    for name in jsb.SVBuffer._fields:
        j = np.asarray(getattr(jbuf, name))
        t = getattr(tbuf, name).numpy()
        assert j.dtype == t.dtype, (name, j.dtype, t.dtype)
        assert j.shape == t.shape, (name, j.shape, t.shape)
        np.testing.assert_array_equal(_bits(j), _bits(t), err_msg=name)


_DTYPES = [(np.float32, None), (np.float64, None)]
_CASES = [
    # (cap, cap_out, p_valid): count > cap_out, count < cap_out, empty
    (40, 64, 0.7),
    (40, 8, 0.9),
    (40, 40, 1.0),
    (0, 16, 0.7),
    (25, 16, 0.0),
]


@pytest.mark.parametrize("dtype,adt", _DTYPES)
@pytest.mark.parametrize("cap,cap_out,p_valid", _CASES)
def test_compact_and_dedup_match_jax(dtype, adt, cap, cap_out, p_valid):
    rng = np.random.default_rng(cap * 7 + cap_out)
    f = _np_buf(rng, cap, 3, dtype, adt, p_valid=p_valid)
    jout, jcount = jsb.compact(_jax(f), cap_out)
    tout, tcount = tsb.compact(_torch(f), cap_out)
    _same(jout, tout)
    assert int(jcount) == tcount
    _same(jsb.dedup_first(_jax(f)), tsb.dedup_first(_torch(f)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap_p,cap_s,cap_out", [
    (30, 50, 96), (30, 50, 20), (0, 40, 32), (30, 0, 32), (0, 0, 4)])
def test_merge_dedup_matches_jax(dtype, cap_p, cap_s, cap_out):
    rng = np.random.default_rng(cap_p + 3 * cap_s + cap_out)
    # ids repeat inside each set and across the two
    p = _np_buf(rng, cap_p, 4, dtype, id_range=25)
    s = _np_buf(rng, cap_s, 4, dtype, id_range=25)
    jm, jc = jsb.merge_dedup(_jax(p), _jax(s), cap_out)
    tm, tc = tsb.merge_dedup(_torch(p), _torch(s), cap_out)
    _same(jm, tm)
    assert int(jc) == tc


def test_merge_dedup_mixed_alpha_dtypes_match_jax():
    # a warm buffer with f64 alpha (a resumed mixed-precision checkpoint)
    # against f32 features: alpha lands in the features' dtype, as in JAX
    rng = np.random.default_rng(5)
    p = _np_buf(rng, 20, 3, np.float32, np.float64)
    s = _np_buf(rng, 30, 3, np.float32)
    jm, jc = jsb.merge_dedup(_jax(p), _jax(s), 40)
    tm, tc = tsb.merge_dedup(_torch(p), _torch(s), 40)
    _same(jm, tm)
    assert int(jc) == tc


@pytest.mark.parametrize("dtype,adt", [(np.float32, np.float64),
                                       (np.float64, np.float64),
                                       (np.float32, np.float32)])
@pytest.mark.parametrize("cap_out", [64, 6])
def test_extract_svs_matches_jax(dtype, adt, cap_out):
    rng = np.random.default_rng(cap_out)
    f = _np_buf(rng, 48, 3, dtype)
    # solver alphas in the accumulator dtype: zeros, tiny, above sv_tol
    alpha = rng.choice([0.0, 1e-9, 1e-8, 0.3, 10.0], 48).astype(adt)
    jo, jc = jsb.extract_svs(_jax(f), jnp.asarray(alpha), 1e-8, cap_out)
    to, tc = tsb.extract_svs(_torch(f), torch.as_tensor(alpha), 1e-8, cap_out)
    _same(jo, to)
    assert int(jc) == tc
    # the stored alpha is in X's dtype
    assert to.alpha.dtype == to.X.dtype


@pytest.mark.parametrize("n_leaves,merged_cap", [(1, 16), (3, 40), (4, 12)])
def test_star_merge_matches_jax(n_leaves, merged_cap):
    rng = np.random.default_rng(n_leaves)
    leaves = [_np_buf(rng, 16, 2, np.float32, id_range=30)
              for _ in range(n_leaves)]
    jm, jc = j_cascade.star_merge([_jax(f) for f in leaves], merged_cap)
    tm, tc = t_cascade.star_merge([_torch(f) for f in leaves], merged_cap)
    _same(jm, tm)
    assert int(jc) == tc


def test_empty_and_from_arrays_match_jax():
    _same(jsb.empty(5, 3, jnp.float64), tsb.empty(5, 3, torch.float64))
    rng = np.random.default_rng(0)
    f = _np_buf(rng, 10, 2, np.float32, np.float64)
    j = jsb.from_arrays(*(jnp.asarray(f[k]) for k in jsb.SVBuffer._fields))
    t = tsb.from_arrays(*(torch.as_tensor(f[k]) for k in jsb.SVBuffer._fields))
    _same(j, t)


@pytest.mark.parametrize("n,P,stratified", [
    (130, 8, False),   # trailing shards empty
    (130, 8, True),
    (512, 3, False),
    (512, 3, True),
    (5, 8, False),     # n < P
    (5, 8, True),
    (64, 1, False),
])
def test_partition_matches_jax(n, P, stratified):
    rng = np.random.default_rng(n + P)
    X = rng.standard_normal((n, 3))
    Y = np.where(rng.random(n) < 0.3, 1, -1).astype(np.int32)
    j = j_partition(X, Y, P, stratified=stratified)
    t = t_partition(X, Y, P, stratified=stratified)
    for name in j._fields:
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_partition_label_sorted_three_classes_matches_jax():
    Y = np.repeat(np.array([2, 0, 1], np.int32), [7, 11, 5])
    X = np.arange(len(Y) * 2, dtype=np.float32).reshape(-1, 2)
    for P in (2, 4):
        j = j_partition(X, Y, P, stratified=True)
        t = t_partition(X, Y, P, stratified=True)
        for name in j._fields:
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
