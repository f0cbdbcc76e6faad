"""Min-max feature scaling with the reference's semantics.

Per-feature scaling to [0, 1]; a degenerate range (< 1e-12) counts as 1.0,
so a constant feature passes through shifted by its min. The test set is
always scaled with the TRAIN set's min/max. numpy throughout, bit-identical
to the JAX package's scaler on the same array.

For a sharded dataset the same global min/max is assembled without holding
X: per-shard partials merge exactly (min and max are selections, so an
elementwise minimum/maximum over partials equals a fit on the concatenated
array), and `MinMaxScaler.from_stats` builds the scaler from the merge
(stream/stats.py is the manifest-side producer).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

_DEGENERATE_RANGE = 1e-12


def merge_minmax(
    parts: Iterable[Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard (min_val, max_val) partials into the global min/max,
    bit-identical to np.min/np.max over the concatenated rows. Raises on
    an empty iterable."""
    lo = hi = None
    for p_lo, p_hi in parts:
        p_lo = np.asarray(p_lo)
        p_hi = np.asarray(p_hi)
        if lo is None:
            lo, hi = p_lo.copy(), p_hi.copy()
        else:
            np.minimum(lo, p_lo, out=lo)
            np.maximum(hi, p_hi, out=hi)
    if lo is None:
        raise ValueError("merge_minmax: no partial stats to merge")
    return lo, hi


@dataclasses.dataclass
class MinMaxScaler:
    """Per-feature min-max scaler. fit() on train data only."""

    min_val: np.ndarray | None = None
    max_val: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "MinMaxScaler":
        self.min_val = np.min(X, axis=0)
        self.max_val = np.max(X, axis=0)
        return self

    @classmethod
    def from_stats(cls, min_val: np.ndarray,
                   max_val: np.ndarray) -> "MinMaxScaler":
        """A fitted scaler from precomputed per-feature min/max (a
        manifest's merged stats): transform() then behaves exactly as
        after fit() on the full array, the degenerate-range branch
        included."""
        min_val = np.asarray(min_val)
        max_val = np.asarray(max_val)
        if min_val.shape != max_val.shape:
            raise ValueError(
                f"min/max shape mismatch: {min_val.shape} vs {max_val.shape}")
        if np.any(max_val < min_val):
            raise ValueError("from_stats: max_val < min_val on some feature")
        return cls(min_val=min_val, max_val=max_val)

    @property
    def range_(self) -> np.ndarray:
        r = self.max_val - self.min_val
        return np.where(r < _DEGENERATE_RANGE, 1.0, r)

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.min_val is None:
            raise RuntimeError("scaler not fitted")
        return (X - self.min_val) / self.range_

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)
