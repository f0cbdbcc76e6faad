"""Deterministic synthetic datasets (numpy, seeded).

The same generators as the JAX package's, so the same seed gives the same
arrays bit for bit:

  - `blobs`: two Gaussian clusters;
  - `rings`: two concentric annuli (not linearly separable);
  - `svr_sine`: continuous regression targets (epsilon-SVR);
  - `mnist_like`: an MNIST-shaped (n, 784) one-vs-rest problem with a
    low-rank "digit manifold" per class.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# the command line's mnist_like recipe: pixel noise 330 and no label flips
# keep held-out accuracy off the 1.0 ceiling
BENCH_NOISE = 330.0
BENCH_LABEL_NOISE = 0.0
# the 10-class recipe: every class overlaps every other under an argmax
# decision, so the noise is a little lower
BENCH_NOISE_MULTICLASS = 300.0


def blobs(
    n: int = 200, d: int = 2, sep: float = 3.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Two Gaussian blobs at +/- sep/2 along each axis. Labels {+1,-1}."""
    rng = np.random.default_rng(seed)
    n_pos = n // 2
    n_neg = n - n_pos
    Xp = rng.normal(loc=+sep / 2, scale=1.0, size=(n_pos, d))
    Xn = rng.normal(loc=-sep / 2, scale=1.0, size=(n_neg, d))
    X = np.concatenate([Xp, Xn], axis=0)
    Y = np.concatenate([np.ones(n_pos, np.int32), -np.ones(n_neg, np.int32)])
    perm = rng.permutation(n)
    return X[perm], Y[perm]


def rings(
    n: int = 400, r_inner: float = 1.0, r_outer: float = 3.0, noise: float = 0.15,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two concentric rings in 2-D. Inner ring = +1, outer ring = -1."""
    rng = np.random.default_rng(seed)
    n_pos = n // 2
    n_neg = n - n_pos
    theta = rng.uniform(0, 2 * np.pi, size=n)
    r = np.concatenate(
        [
            r_inner + rng.normal(0, noise, n_pos),
            r_outer + rng.normal(0, noise, n_neg),
        ]
    )
    X = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    Y = np.concatenate([np.ones(n_pos, np.int32), -np.ones(n_neg, np.int32)])
    perm = rng.permutation(n)
    return X[perm], Y[perm]


def svr_sine(
    n: int = 400, d: int = 2, noise: float = 0.05, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth regression problem for epsilon-SVR: continuous targets.

    X uniform on [-3, 3]^d; the target is a sine of the first coordinate
    plus 0.25 times each other coordinate, plus gaussian target noise.
    Returns (X, t) with t float64.
    """
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, size=(n, d))
    t = np.sin(X[:, 0])
    for j in range(1, d):
        t = t + 0.25 * X[:, j]
    if noise > 0:
        t = t + rng.normal(0, noise, size=n)
    return X, t


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
