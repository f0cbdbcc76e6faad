"""Kernel families and the tasks built on them.

dispatch.py routes the solvers' four kernel computations by family name
("rbf" | "linear" | "poly" | "sigmoid", and the approximate "rff" |
"nystrom" names, which route through linear); svr.py is the epsilon-SVR
variable doubling; platt.py is Platt probability calibration.
"""

from tpusvm_torch.config import APPROX_FAMILIES, KERNEL_FAMILIES
from tpusvm_torch.kernels.dispatch import (cross, cross_matvec, is_approx,
                                           matvec, needs_norms, rows_at,
                                           sq_norms_for, validate_family)
from tpusvm_torch.kernels.platt import fit_platt, log_loss, platt_proba
from tpusvm_torch.kernels.svr import collapse_duals, doubled_problem

__all__ = [
    "KERNEL_FAMILIES",
    "APPROX_FAMILIES",
    "rows_at",
    "cross",
    "cross_matvec",
    "matvec",
    "needs_norms",
    "is_approx",
    "sq_norms_for",
    "validate_family",
    "doubled_problem",
    "collapse_duals",
    "fit_platt",
    "platt_proba",
    "log_loss",
]
