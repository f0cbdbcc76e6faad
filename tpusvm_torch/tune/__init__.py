"""Hyperparameter search (`python -m tpusvm_torch tune`), the port of
tpusvm/tune/:

  - `folds`   — deterministic, stratified k-fold splitting;
  - `grid`    — the (C, gamma) search space: value lists, snake order,
    log-space geometry;
  - `warm`    — warm starts: each point's alphas seeded from its nearest
    solved neighbour in log-(C, gamma) space, made feasible for the new
    box (`blocked_smo_solve(alpha0=..., warm_start=True)`);
  - `search`  — the driver: grid and successive-halving schedules over
    fold x point fits with per-fold caches (scaled X, row norms) and
    plateau early-stopping, sequential or one fleet a rung and fold;
  - `results` — the versioned `TuneResult` JSON artifact, the JAX
    package's format.
"""

from tpusvm_torch.tune.folds import Fold, stratified_kfold
from tpusvm_torch.tune.grid import GridSpec, log_grid, make_grid
from tpusvm_torch.tune.results import (
    TuneResult,
    format_table,
    is_tune_result,
    load_tune_result,
    save_tune_result,
)
from tpusvm_torch.tune.search import TuneConfig, normalize_kernel_specs, tune

__all__ = [
    "normalize_kernel_specs",
    "Fold",
    "stratified_kfold",
    "GridSpec",
    "log_grid",
    "make_grid",
    "TuneConfig",
    "tune",
    "TuneResult",
    "format_table",
    "save_tune_result",
    "load_tune_result",
    "is_tune_result",
]
