"""Hyperparameters of the port's binary RBF C-SVC.

Restricted to the fields this slice implements; the defaults are the
reference's constants (C and gamma of its MNIST run, tau, eps, sv_tol,
max_iter), so a zero-argument config is a parity config.
"""

from __future__ import annotations

import dataclasses

import torch

# kernel families the JAX package knows; only "rbf" is ported so far
KERNEL_FAMILIES = ("rbf", "linear", "poly", "sigmoid", "rff", "nystrom")


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """C: box constraint. gamma: RBF width, K(a, b) = exp(-gamma |a-b|^2).
    tau: stopping tolerance (converged when b_low <= b_high + 2 tau).
    eps: index-set tolerance, eta guard and [U, V] slack. sv_tol: alpha >
    sv_tol defines a support vector. max_iter: cap on total alpha updates.
    kernel: only "rbf"; the other families come with a later slice."""

    C: float = 10.0
    gamma: float = 0.00125
    tau: float = 1e-5
    eps: float = 1e-12
    sv_tol: float = 1e-8
    max_iter: int = 100000
    kernel: str = "rbf"

    def __post_init__(self):
        if self.kernel not in KERNEL_FAMILIES:
            raise ValueError(
                f"unknown kernel family {self.kernel!r}; supported: "
                f"{list(KERNEL_FAMILIES)}"
            )
        if self.kernel != "rbf":
            raise NotImplementedError(
                f"kernel={self.kernel!r} is not ported yet: kernel families "
                "and tasks come with slice 2 of the port (ROADMAP Queue 1 "
                "item 6); this slice runs the RBF kernel only"
            )


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
