"""The benchmark's data generator: a frozen copy of `mnist_like` and
`mnist_like_multiclass` from tpusvm_torch/data/synthetic.py (as of the
port's last bring-up commit), so that a later change to the port's
generator cannot move the yardstick. Same seed, same arrays, bit for bit
(perfbench/tests/test_perfbench_harness.py holds the two together).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mnist_like_multiclass(
    n: int = 60000, d: int = 784, n_classes: int = 10, rank: int = 32, seed: int = 587,
    noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped multi-class problem; returns raw class ids.

    Each class lives on its own low-rank affine manifold in [0, 255]^d,
    clipped and rounded like pixel data; `noise` adds per-pixel gaussian
    noise (std in pixel units) to make the classes overlap.
    """
    rng = np.random.default_rng(seed)
    per = np.full(n_classes, n // n_classes)
    per[: n % n_classes] += 1
    xs = []
    for c in range(n_classes):
        basis = rng.normal(0, 1, size=(rank, d))
        center = rng.uniform(30, 225, size=(d,)) * (rng.random(d) < 0.25)
        coeff = rng.normal(0, 18.0, size=(per[c], rank))
        Xc = center + coeff @ basis
        if noise > 0:
            Xc += rng.normal(0, noise, size=Xc.shape)
        np.clip(Xc, 0, 255, out=Xc)
        np.rint(Xc, out=Xc)
        xs.append(Xc)
    X = np.concatenate(xs, axis=0)
    labels = np.concatenate(
        [np.full(per[c], c, np.int32) for c in range(n_classes)]
    )
    perm = rng.permutation(n)
    return X[perm], labels[perm]


def mnist_like(
    n: int = 60000, d: int = 784, n_classes: int = 10, rank: int = 32,
    positive_class: int = 1, seed: int = 587, noise: float = 0.0,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped one-vs-rest problem: labels in {+1,-1}.

    `label_noise` flips that fraction of labels, drawn from a separate
    rng stream (X is unaffected).
    """
    X, labels = mnist_like_multiclass(n, d, n_classes, rank, seed, noise)
    Y = np.where(labels == positive_class, 1, -1).astype(np.int32)
    if label_noise > 0:
        flip_rng = np.random.default_rng(seed + 104729)
        idx = flip_rng.choice(n, int(label_noise * n), replace=False)
        Y[idx] = -Y[idx]
    return X, Y


def make_data(cfg: dict, seed: int) -> dict:
    """The configuration's rows and labels, split into the training rows
    and the held-out rows: {"X", "X_test"} (float64, raw pixels) and
    {"Y", "Y_test"} (+1/-1 for a binary task) or {"labels",
    "labels_test"} (class ids for one-vs-rest).

    The rows are the configuration's own draw (its data seed), so every
    seed poses the same problem at the same size; `seed` orders them:
    the training rows and the held-out rows each in an order of their
    own. The order moves the working sets' tie-breaks and the kernels'
    summation order, so each seed's solve takes a path of its own."""
    g = cfg["data"]
    n_train = int(g["n_train"])
    kw = dict(n=int(g["n"]), d=int(g["d"]), n_classes=int(g["n_classes"]),
              rank=int(g["rank"]), seed=int(g["seed"]),
              noise=float(g["noise"]))
    if cfg["task"] == "binary":
        X, y = mnist_like(positive_class=int(g["positive_class"]),
                          label_noise=float(g["label_noise"]), **kw)
        names = ("Y", "Y_test")
    else:
        X, y = mnist_like_multiclass(**kw)
        names = ("labels", "labels_test")
    rng = np.random.default_rng(int(seed))
    tr = rng.permutation(n_train)
    te = n_train + rng.permutation(X.shape[0] - n_train)
    return {"X": X[tr], names[0]: y[tr], "X_test": X[te], names[1]: y[te]}
