"""CSV dataset reader with the reference's exact semantics.

The port's copy of the JAX package's tpusvm/data/csv_reader.py (numpy
only), so that a CSV reads to the same X and Y bits in both packages.

Reference: read_CSV in main3.cpp:13-54 (and the n_limit-capped variant in
gpu_svm_main4.cu:16-59):
  - the first line is a header and is discarded; the number of features is
    (number of header fields - 1) — the last column is the label;
  - data rows with fewer than 2 comma-separated fields are skipped;
  - the label is the last field, parsed as int, mapped `label != 1 -> -1`
    (one-vs-rest, digit "1" vs. rest);
  - optional `n_limit` caps the number of rows kept (gpu_svm_main4.cu:38-40).

One generalisation beyond the reference: `positive_label` parameterises the
one-vs-rest mapping (the reference hard-codes digit "1", main3.cpp:49-52) —
`binary=True, positive_label=k` maps `label != k -> -1`. The default k=1
reproduces the reference bit-for-bit.

Returns float64 row-major X and int32 Y, matching the reference's
vector<double>/vector<int>.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from tpusvm_torch.utils.durable import fsync_replace


def _iter_rows(f, n_limit: Optional[int], binary: bool, positive_label: int):
    """Shared row loop: yields (features list, mapped label) per kept row."""
    kept = 0
    for line in f:
        if n_limit is not None and kept >= n_limit:
            break
        fields = line.rstrip("\n").split(",")
        if len(fields) < 2:  # must have at least one feature + label
            continue
        label = int(float(fields[-1]))
        if binary:
            label = 1 if label == positive_label else -1
        kept += 1
        yield [float(v) for v in fields[:-1]], label


def read_csv(
    filename: str,
    n_limit: Optional[int] = None,
    binary: bool = True,
    positive_label: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read a labelled CSV the way the reference does.

    Args:
      filename: path to a CSV whose last column is an integer label.
      n_limit: if given, keep at most this many data rows (gpu_svm_main4.cu).
      binary: map labels `!= positive_label -> -1` (the reference's
        one-vs-rest mapping, main3.cpp:49-52); False keeps raw integer
        labels for multi-class use.
      positive_label: the class mapped to +1 in binary mode (default 1,
        the reference's hard-coded digit).

    Returns:
      (X, Y): X float64 of shape (n, n_features); Y int32 of shape (n,) with
      values in {+1, -1} when binary, raw labels otherwise.
    """
    xs = []
    ys = []
    with open(filename, "r") as f:
        header = f.readline()  # discarded; defines the column count
        n_features = len(header.rstrip("\n").split(",")) - 1
        for row, label in _iter_rows(f, n_limit, binary, positive_label):
            xs.append(row)
            ys.append(label)
    if not ys:
        return np.zeros((0, max(n_features, 0)), np.float64), np.zeros((0,), np.int32)
    X = np.asarray(xs, dtype=np.float64)
    Y = np.asarray(ys, dtype=np.int32)
    return X, Y


def read_csv_regression(
    filename: str,
    n_limit: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read a CSV whose last column is a CONTINUOUS regression target.

    Same layout rules as read_csv (header discarded, <2-field rows
    skipped, n_limit cap) but the target keeps its float value instead of
    the reference's int-parse + one-vs-rest mapping — the epsilon-SVR
    input path. Returns (X float64, t float64).
    """
    xs = []
    ts = []
    kept = 0
    with open(filename, "r") as f:
        header = f.readline()
        n_features = len(header.rstrip("\n").split(",")) - 1
        for line in f:
            if n_limit is not None and kept >= n_limit:
                break
            fields = line.rstrip("\n").split(",")
            if len(fields) < 2:
                continue
            kept += 1
            xs.append([float(v) for v in fields[:-1]])
            ts.append(float(fields[-1]))
    if not ts:
        return (np.zeros((0, max(n_features, 0)), np.float64),
                np.zeros((0,), np.float64))
    return np.asarray(xs, np.float64), np.asarray(ts, np.float64)


def read_csv_blocks(
    filename: str,
    block_rows: int = 8192,
    n_limit: Optional[int] = None,
    binary: bool = True,
    positive_label: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream a labelled CSV as (X, Y) blocks of at most block_rows rows.

    Identical row/label semantics to read_csv (the concatenation of all
    yielded blocks equals read_csv's output bit-for-bit) with peak memory
    bounded by one block — the ingest path for datasets that do not fit in
    RAM (the JAX package's sharded ingest). Yields nothing for a header-only
    file.
    """
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    with open(filename, "r") as f:
        f.readline()  # header: discarded; column count checked row-wise
        xs, ys = [], []
        for row, label in _iter_rows(f, n_limit, binary, positive_label):
            xs.append(row)
            ys.append(label)
            if len(ys) == block_rows:
                yield (np.asarray(xs, np.float64), np.asarray(ys, np.int32))
                xs, ys = [], []
        if ys:
            yield (np.asarray(xs, np.float64), np.asarray(ys, np.int32))


def write_csv(filename: str, X: np.ndarray, Y: np.ndarray) -> None:
    """Write (X, Y) in the format read_csv expects (header + last-column label)."""
    n, d = X.shape
    tmp = filename + ".tmp"
    with open(tmp, "w") as f:
        f.write(",".join([f"f{j}" for j in range(d)] + ["label"]) + "\n")
        for i in range(n):
            f.write(",".join(repr(float(v)) for v in X[i]) + f",{int(Y[i])}\n")
    fsync_replace(tmp, filename)
