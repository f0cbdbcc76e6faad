"""Hyperparameters of the port's SVM estimators.

The defaults are the reference's constants (C and gamma of its MNIST run,
tau, eps, sv_tol, max_iter), so a zero-argument config is a parity
config. The field names follow the JAX package's SVMConfig, so a config
moves between the packages through the shared `.npz` artifact.
"""

from __future__ import annotations

import dataclasses

import torch

# kernel families the JAX package knows; the approximate ones ("rff",
# "nystrom") need the explicit feature maps, which are not ported yet
KERNEL_FAMILIES = ("rbf", "linear", "poly", "sigmoid", "rff", "nystrom")
APPROX_FAMILIES = ("rff", "nystrom")


def refuse_approx(family: str) -> None:
    """NotImplementedError for the approximate families at the model layer."""
    if family in APPROX_FAMILIES:
        raise NotImplementedError(
            f"kernel={family!r} is an approximate-kernel family; its "
            "feature maps are not ported yet (ROADMAP Queue 1 item 10). "
            "The exact families rbf, linear, poly and sigmoid run"
        )


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """C: box constraint. gamma: kernel width (RBF exp(-gamma |a-b|^2)) or
    scale (poly/sigmoid gamma a.b). tau: stopping tolerance (converged when
    b_low <= b_high + 2 tau). eps: index-set tolerance, eta guard and
    [U, V] slack. sv_tol: alpha > sv_tol defines a support vector.
    max_iter: cap on total alpha updates. kernel: "rbf", "linear", "poly"
    or "sigmoid" ("rff"/"nystrom" are refused). degree: poly degree.
    coef0: poly/sigmoid additive term. epsilon: the epsilon-SVR tube
    half-width (EpsilonSVR only)."""

    C: float = 10.0
    gamma: float = 0.00125
    tau: float = 1e-5
    eps: float = 1e-12
    sv_tol: float = 1e-8
    max_iter: int = 100000
    kernel: str = "rbf"
    degree: int = 3
    coef0: float = 0.0
    epsilon: float = 0.1

    def __post_init__(self):
        if self.kernel not in KERNEL_FAMILIES:
            raise ValueError(
                f"unknown kernel family {self.kernel!r}; supported: "
                f"{list(KERNEL_FAMILIES)}"
            )
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if self.epsilon < 0:
            raise ValueError(f"epsilon must be >= 0, got {self.epsilon}")
        refuse_approx(self.kernel)


def resolve_accum_dtype(accum_dtype):
    """"auto" -> torch.float64 (f32 features, f64 O(n) accumulators: f32
    accumulators alone can stall SMO near convergence); None stays None
    (same as the features); a torch dtype passes through."""
    if isinstance(accum_dtype, str):
        if accum_dtype != "auto":
            raise ValueError(
                f"accum_dtype must be 'auto', None, or a torch dtype; "
                f"got {accum_dtype!r}"
            )
        return torch.float64
    return accum_dtype
