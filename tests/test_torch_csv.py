"""The port's CSV reader against the JAX package's, bit for bit.

A CSV written by tpusvm.data.write_csv (a seeded mnist_like draw, repr()
floats) reads to the same X and Y bytes in both packages, under every
option the reference's reader has: n_limit, positive_label, raw labels,
short rows, a header-only file, the block reader and the regression
reader. Tolerance: none (np.array_equal on float64 X and int32 Y, and the
dtypes).
"""

import numpy as np
import pytest

from tpusvm.data import csv_reader as j_csv
from tpusvm.data.synthetic import mnist_like as j_mnist_like
from tpusvm_torch.data import csv_reader as t_csv


def _same(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert a[0].shape == b[0].shape
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def digits_csv(tmp_path_factory):
    X, _ = j_mnist_like(n=120, d=12, seed=5)
    labels = np.random.default_rng(5).integers(0, 10, 120).astype(np.int32)
    path = str(tmp_path_factory.mktemp("csv") / "digits.csv")
    j_csv.write_csv(path, X, labels)
    return path


@pytest.mark.parametrize("kw", [
    {},
    dict(n_limit=37),
    dict(n_limit=0),
    dict(positive_label=3),
    dict(binary=False),
    dict(binary=False, n_limit=50),
])
def test_read_csv_matches_jax(digits_csv, kw):
    _same(t_csv.read_csv(digits_csv, **kw), j_csv.read_csv(digits_csv, **kw))


def test_short_rows_and_header_only(tmp_path):
    path = tmp_path / "short.csv"
    path.write_text("a,b,label\n1.5,2.5,1\n7\n\n0.25,-1e-3,4\n3,4,1\n")
    for kw in ({}, dict(n_limit=2), dict(binary=False)):
        _same(t_csv.read_csv(str(path), **kw), j_csv.read_csv(str(path), **kw))
    X, Y = t_csv.read_csv(str(path))
    assert X.shape == (3, 2) and Y.tolist() == [1, -1, 1]
    head = tmp_path / "head.csv"
    head.write_text("f0,f1,f2,label\n")
    _same(t_csv.read_csv(str(head)), j_csv.read_csv(str(head)))
    assert t_csv.read_csv(str(head))[0].shape == (0, 3)
    _same(t_csv.read_csv_regression(str(head)),
          j_csv.read_csv_regression(str(head)))
    assert list(t_csv.read_csv_blocks(str(head))) == []


@pytest.mark.parametrize("block_rows,n_limit", [(16, None), (50, 77), (1000, None)])
def test_read_csv_blocks_matches_jax(digits_csv, block_rows, n_limit):
    t = list(t_csv.read_csv_blocks(digits_csv, block_rows=block_rows,
                                   n_limit=n_limit, positive_label=2))
    j = list(j_csv.read_csv_blocks(digits_csv, block_rows=block_rows,
                                   n_limit=n_limit, positive_label=2))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _same(a, b)
    whole = t_csv.read_csv(digits_csv, n_limit=n_limit, positive_label=2)
    _same((np.concatenate([b[0] for b in t]),
           np.concatenate([b[1] for b in t])), whole)
    with pytest.raises(ValueError, match="block_rows"):
        next(t_csv.read_csv_blocks(digits_csv, block_rows=0))


@pytest.mark.parametrize("n_limit", [None, 9])
def test_read_csv_regression_matches_jax(tmp_path, n_limit):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(40, 3))
    path = str(tmp_path / "reg.csv")
    with open(path, "w") as f:
        f.write("x0,x1,x2,t\n")
        for row, t in zip(X, rng.normal(size=40)):
            f.write(",".join(repr(float(v)) for v in row) + f",{float(t)!r}\n")
    a = t_csv.read_csv_regression(path, n_limit=n_limit)
    _same(a, j_csv.read_csv_regression(path, n_limit=n_limit))
    assert a[1].dtype == np.float64


def test_write_csv_writes_the_jax_bytes(tmp_path):
    X, Y = j_mnist_like(n=30, d=5, seed=2)
    j_csv.write_csv(str(tmp_path / "j.csv"), X, Y)
    t_csv.write_csv(str(tmp_path / "t.csv"), X, Y)
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
