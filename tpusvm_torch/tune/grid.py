"""The (C, gamma) search space and its log-space geometry.

The port's copy of the JAX package's tpusvm/tune/grid.py (stdlib only).

SVM hyperparameter response surfaces are smooth in (log C, log gamma) —
the standard grid-search practice (and the reason warm-starting from a
log-space neighbour works: nearby points share most of their active set).
This module owns the space itself: explicit value lists, the snake
traversal order that maximises step-to-step adjacency for the warm-start
chain, and the log-space distance the nearest-neighbour seeding keys on.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple


class GridSpec(NamedTuple):
    """Cartesian (C, gamma) grid. Values must be positive (log-space)."""

    C_values: Tuple[float, ...]
    gamma_values: Tuple[float, ...]

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.C_values), len(self.gamma_values))

    def points(self) -> List[Tuple[float, float]]:
        """All (C, gamma) points in snake order: C ascending, gamma
        alternating direction per C-row, so consecutive points differ in
        exactly one coordinate by one grid step — every fit after the
        first has an immediately-adjacent already-solved neighbour to
        warm-start from."""
        Cs = sorted(self.C_values)
        gs = sorted(self.gamma_values)
        pts = []
        for i, C in enumerate(Cs):
            row = gs if i % 2 == 0 else gs[::-1]
            pts.extend((C, g) for g in row)
        return pts


def make_grid(C_values: Sequence[float],
              gamma_values: Sequence[float]) -> GridSpec:
    Cs = tuple(float(c) for c in C_values)
    gs = tuple(float(g) for g in gamma_values)
    if not Cs or not gs:
        raise ValueError("grid needs at least one C and one gamma value")
    if any(v <= 0 for v in Cs + gs):
        raise ValueError("C and gamma grid values must be positive "
                         "(the search space is log-scaled)")
    if len(set(Cs)) != len(Cs) or len(set(gs)) != len(gs):
        raise ValueError("grid values must be distinct")
    return GridSpec(C_values=Cs, gamma_values=gs)


def log_grid(center_C: float, center_gamma: float, span: int = 2,
             step: float = 4.0) -> GridSpec:
    """A (2*span+1)^2 grid of multiplicative `step`s around a center point.

    The zero-config search space: centered on the caller's best guess
    (e.g. the reference's preset constants), step=4 covers ~2.4 decades
    per axis at span=2 — the coarse pass of the classic two-stage grid
    refinement.
    """
    if span < 0:
        raise ValueError(f"span must be >= 0, got {span}")
    if step <= 1.0:
        raise ValueError(f"step must be > 1, got {step}")
    return make_grid(
        [center_C * step ** e for e in range(-span, span + 1)],
        [center_gamma * step ** e for e in range(-span, span + 1)],
    )


def log_distance(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    """Euclidean distance in (log C, log gamma) space."""
    return math.hypot(math.log(a[0]) - math.log(b[0]),
                      math.log(a[1]) - math.log(b[1]))


def nearest_point(target: Tuple[float, float],
                  candidates: Sequence[Tuple[float, float]]) -> int:
    """Index of the log-space-nearest candidate; ties break to the earliest
    (solve-order) candidate so the choice is deterministic."""
    if not candidates:
        raise ValueError("no candidates")
    best, best_d = 0, float("inf")
    for i, c in enumerate(candidates):
        d = log_distance(target, c)
        if d < best_d:
            best, best_d = i, d
    return best
