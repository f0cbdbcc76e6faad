"""Hyperparameters of the port's SVM estimators.

The defaults are the reference's constants (C and gamma of its MNIST run,
tau, eps, sv_tol, max_iter), so a zero-argument config is a parity
config. The field names follow the JAX package's SVMConfig, so a config
moves between the packages through the shared `.npz` artifact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    max_iter: cap on total alpha updates. max_rounds: cascade round cap
    (mpi_svm_main3.cpp:544). kernel: "rbf", "linear", "poly"
    or "sigmoid" ("rff"/"nystrom" are refused). degree: poly degree.
    coef0: poly/sigmoid additive term. epsilon: the epsilon-SVR tube
    half-width (EpsilonSVR only)."""

    C: float = 10.0
    gamma: float = 0.00125
    tau: float = 1e-5
    eps: float = 1e-12
    sv_tol: float = 1e-8
    max_iter: int = 100000
    max_rounds: int = 50
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


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Shapes and topology of the cascade (a copy of the JAX package's).

    SV sets travel as fixed-capacity padded buffers with validity masks.

    n_shards: the leaf count P (the reference's `mpirun -np P`).
    sv_capacity: the most support vectors one merged model may hold; must
      be >= the true global SV count, and overflow raises at run time.
    topology: "tree" = the classical binary-reduction cascade
      (mpi_svm_main3.cpp), "star" = the modified two-layer cascade
      (mpi_svm_main2.cpp).
    star_merge_capacity: the capacity of the star's layer-2 merged solve
      (rank 0's retrain over the union of the leaves' SV sets). None =
      n_shards * sv_capacity, the structural bound, which cannot overflow.
      A tighter value makes the layer-2 solve smaller; a round whose union
      overflows it is re-run at the full bound with a RuntimeWarning, and
      the fit stays there. Star only: setting it with "tree" raises.
    """

    n_shards: int = 8
    sv_capacity: int = 4096
    topology: str = "tree"
    star_merge_capacity: Optional[int] = None

    def __post_init__(self):
        if self.topology not in ("tree", "star"):
            raise ValueError(f"unknown cascade topology: {self.topology!r}")
        if self.topology == "tree" and (self.n_shards & (self.n_shards - 1)) != 0:
            # mpi_svm_main3.cpp:420-428 aborts on a non-power-of-two world
            raise ValueError(
                f"tree cascade requires a power-of-two shard count, got {self.n_shards}"
            )
        if self.star_merge_capacity is not None:
            if self.topology != "star":
                raise ValueError(
                    "star_merge_capacity only applies to the star topology; "
                    f"got topology={self.topology!r}"
                )
            if self.star_merge_capacity < 1:
                raise ValueError(
                    f"star_merge_capacity must be >= 1, "
                    f"got {self.star_merge_capacity}"
                )

    def resolved_star_merge_capacity(self) -> int:
        """star_merge_capacity, or the concatenation bound P * sv_capacity
        when it is None."""
        cap = self.star_merge_capacity
        if cap is None:
            cap = self.n_shards * self.sv_capacity
        return cap


# ---------------------------------------------------------------- precision
# The contraction-precision rungs of the blocked solver's f-update and K-row
# refresh (ops/rbf.py:matmul_p), as the JAX package names them:
#   "float32" / "highest": full f32 (the trust tier);
#   "bf16_f32":  operands rounded to bfloat16, products accumulated in f32;
#   "bf16_f32c": the same plus one compensated pass, (A - bf16(A)) @ bf16(B);
#   RAW_BF16:    the backend's single-pass product: TF32 on a CUDA card,
#                plain f32 on the CPU (as XLA's CPU "default" is).
# RAW_BF16 is reached only by this token: the string "default" raises here,
# and the blocked solver translates its own matmul_precision="default" to
# RAW_BF16 after checking the refine pairing that keeps it safe.
RAW_BF16 = "raw_bf16"

MATMUL_PRECISIONS = ("float32", "highest", "bf16_f32", "bf16_f32c",
                     RAW_BF16)

BF16_RUNGS = ("bf16_f32", "bf16_f32c")


def resolve_matmul_precision(precision):
    """The knob -> a MATMUL_PRECISIONS token: None -> "float32"; the tokens
    to themselves; "default" always raises ValueError (jax's name for raw
    single-pass bf16 reads like "no preference")."""
    if precision is None:
        return "float32"
    if precision == "default":
        raise ValueError(
            "precision='default' is jax's name for RAW SINGLE-PASS "
            "products (bf16 on a TPU, TF32 on a CUDA card), not 'the "
            "default precision'. Request it explicitly as "
            "tpusvm_torch.config.RAW_BF16, use the solver knob "
            "matmul_precision='default' (which validates the refine "
            "pairing first), or pick a ladder rung: 'float32' (trust "
            "anchor), 'bf16_f32' (bf16 operands, f32 accumulation), "
            "'bf16_f32c' (compensated)."
        )
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(
            f"unknown matmul precision {precision!r}; supported: "
            f"{list(MATMUL_PRECISIONS)} (None = 'float32')"
        )
    return precision


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


# Named dataset presets mirroring the reference's edit-in-place dataset
# switch (main3.cpp:308-313): each maps to (C, gamma). A copy of the JAX
# package's DATASET_PRESETS.
DATASET_PRESETS = {
    "mnist": (10.0, 0.00125),
    "banknote": (1.0, 0.125),
    "debug": (1.0, 0.125),
}


def preset(name: str, **overrides) -> SVMConfig:
    """An SVMConfig from a named dataset preset, with field overrides."""
    if name not in DATASET_PRESETS:
        raise ValueError(f"unknown preset {name!r}; known: "
                         f"{sorted(DATASET_PRESETS)}")
    C, gamma = DATASET_PRESETS[name]
    return dataclasses.replace(SVMConfig(C=C, gamma=gamma), **overrides)
