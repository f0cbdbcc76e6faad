"""Min-max feature scaling with the reference's semantics.

Per-feature scaling to [0, 1]; a degenerate range (< 1e-12) counts as 1.0,
so a constant feature passes through shifted by its min. The test set is
always scaled with the TRAIN set's min/max. numpy throughout, bit-identical
to the JAX package's scaler on the same array.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_DEGENERATE_RANGE = 1e-12


@dataclasses.dataclass
class MinMaxScaler:
    """Per-feature min-max scaler. fit() on train data only."""

    min_val: np.ndarray | None = None
    max_val: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "MinMaxScaler":
        self.min_val = np.min(X, axis=0)
        self.max_val = np.max(X, axis=0)
        return self

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
