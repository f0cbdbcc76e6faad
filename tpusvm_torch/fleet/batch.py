"""Problem packing and power-of-two bucketing for fleet solves (the port
of tpusvm/fleet/batch.py, which imports no JAX; a copy, as the port
imports nothing of the JAX package).

A fleet solve batches B optimisation problems that share one training
matrix X but differ in (y, C, gamma) (one-vs-rest heads, a tune rung's
(C, gamma) population, per-tenant classifiers) into one lockstep solve
(tpusvm_torch/fleet/solve.py):

  * power-of-two problem-count buckets, as in the JAX package, whose jit
    signatures they bound; padding problems are inert: an all-zero label
    vector belongs to neither Keerthi index set, so the padded lane ends
    NO_WORKING_SET at its first stop check with alpha identically zero,
    and is frozen (it launches nothing) from then on.

  * per-problem statics validation: every solver knob but the
    per-problem axis (y, valid, alpha0, C, gamma) is shared by the whole
    fleet; the knobs the fleet cannot honour are refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "FleetBatch",
    "bucket_for",
    "pack_problems",
    "UNSUPPORTED_FLEET_OPTS",
    "fleet_opt_errors",
]

# solver knobs a fleet solve cannot honour, with the reason a caller sees
# (the JAX package's knobs and inert values). Values are checked against
# the knob's inert default; requesting anything else raises. inner keeps
# JAX's inert "xla", which names the fleet's own engine here: the
# problem-axis launches of the subproblem kernel (#2) and, for RBF, of the
# f-update (#1), which solve the same wss=1/2 subproblem math as the solo
# engines.
UNSUPPORTED_FLEET_OPTS = {
    "inner": ("xla", "the fleet runs its own engine, the problem-axis "
              "subproblem kernel; the solo engines' names do not apply"),
    "fused_fupdate": (False, "the fleet's f-update is its own problem-axis "
                      "launch of kernel #1 (RBF) or the family's "
                      "contraction"),
    "krow_cache": (0, "the K-row LRU cache carries (slots, n) state per "
                   "problem — a (B, slots, n) carry defeats the cache's "
                   "memory model; deferred"),
    "shrink_stable": (0, "the shrinking driver segments the solve "
                     "host-side per problem; fleet problems share one "
                     "lockstep loop"),
    "pallas_fused_selection": (False, "requires the solo fused f-update "
                               "with candidate selection (kernel #4)"),
    "pallas_eta_exclude": (False, "solo kernel-engine flag; the fleet "
                           "runs its own engine"),
    "pallas_multipair": (1, "solo kernel-engine flag; the fleet runs its "
                         "own engine"),
    "resume_state": (None, "checkpoint/resume of a fleet launch is a "
                     "future PR"),
    "pause_at": (None, "checkpoint/resume of a fleet launch is a "
                 "future PR"),
    "return_state": (False, "checkpoint/resume of a fleet launch is a "
                     "future PR"),
}


def fleet_opt_errors(opts: dict) -> list:
    """Validation errors for solver knobs a fleet solve cannot honour.

    Returns human-readable messages (empty = clean). Knobs at their inert
    defaults pass: only an ACTIVE unsupported knob is refused.
    """
    errors = []
    for key, (inert, why) in UNSUPPORTED_FLEET_OPTS.items():
        if key in opts and opts[key] != inert:
            errors.append(
                f"fleet: {key}={opts[key]!r} is not fleet-compatible "
                f"({why})"
            )
    return errors


def _host(a) -> np.ndarray:
    """A numpy array of a numpy array, a list or a tensor on any device."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def bucket_for(n_problems: int) -> int:
    """Smallest power-of-two bucket holding n_problems (min 1)."""
    if n_problems < 1:
        raise ValueError(f"need at least one problem, got {n_problems}")
    return 1 << (n_problems - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FleetBatch:
    """B problems packed + padded to a power-of-two bucket.

    All arrays carry the bucket-sized leading axis; lanes at index >=
    n_problems are the inert zero-label padding. valids/alpha0s stay
    None when no problem supplied them."""

    Ys: np.ndarray                    # (bucket, n) int32
    Cs: np.ndarray                    # (bucket,) float64
    gammas: np.ndarray                # (bucket,) float64
    valids: Optional[np.ndarray]      # (bucket, n) bool or None
    alpha0s: Optional[np.ndarray]     # (bucket, n) float64 or None
    n_problems: int
    bucket: int


def pack_problems(
    Ys: Sequence[np.ndarray],
    Cs: Sequence[float],
    gammas: Sequence[float],
    valids: Optional[Sequence[Optional[np.ndarray]]] = None,
    alpha0s: Optional[Sequence[Optional[np.ndarray]]] = None,
    bucket: Optional[int] = None,
) -> FleetBatch:
    """Stack per-problem (y, C, gamma[, valid, alpha0]) into a FleetBatch.

    Validates the per-problem dynamics: every label vector has the
    shared row count with labels in {-1, 0, +1} (0 only on rows that
    problem's valid mask excludes — a live zero label would silently
    freeze the row), and C/gamma are positive finite. A None entry in
    alpha0s means that problem starts cold (alpha0 = 0, exactly the
    state the solver's own default builds); a None entry in valids
    means all rows live.

    bucket: explicit bucket size (>= n_problems, power of two); default
    = bucket_for(B).
    """
    B = len(Ys)
    if B == 0:
        raise ValueError("pack_problems: empty problem list")
    if not (len(Cs) == len(gammas) == B):
        raise ValueError(
            f"pack_problems: {B} label vectors but {len(Cs)} C values "
            f"and {len(gammas)} gamma values"
        )
    if valids is not None and len(valids) != B:
        raise ValueError(f"pack_problems: {len(valids)} valid masks "
                         f"for {B} problems")
    if alpha0s is not None and len(alpha0s) != B:
        raise ValueError(f"pack_problems: {len(alpha0s)} alpha0 seeds "
                         f"for {B} problems")

    Ys = [_host(y) for y in Ys]
    n = int(Ys[0].shape[0])
    Y_mat = np.zeros((B, n), np.int32)
    for i, y in enumerate(Ys):
        if y.shape != (n,):
            raise ValueError(
                f"pack_problems: problem {i} has {y.shape} labels; the "
                f"fleet shares X, so every problem needs ({n},)"
            )
        if not np.isin(y, (-1, 0, 1)).all():
            raise ValueError(
                f"pack_problems: problem {i} carries labels outside "
                "{-1, 0, +1}"
            )
        live = y if valids is None or valids[i] is None \
            else y[_host(valids[i]).astype(bool)]
        if (live == 0).any():
            raise ValueError(
                f"pack_problems: problem {i} has zero labels on live "
                "rows — a live y=0 row belongs to neither index set and "
                "silently freezes; mask it invalid instead"
            )
        Y_mat[i] = y.astype(np.int32)

    C_vec = np.asarray(Cs, np.float64)
    g_vec = np.asarray(gammas, np.float64)
    for name, vec in (("C", C_vec), ("gamma", g_vec)):
        if not (np.isfinite(vec).all() and (vec > 0).all()):
            raise ValueError(
                f"pack_problems: every per-problem {name} must be a "
                f"positive finite float, got {vec.tolist()}"
            )

    bkt = bucket_for(B) if bucket is None else bucket
    if bkt < B or bkt & (bkt - 1):
        raise ValueError(
            f"pack_problems: bucket={bkt} must be a power of two >= "
            f"the {B} packed problems"
        )
    pad = bkt - B
    if pad:
        # inert padding: zero labels (outside both index sets), C/gamma
        # at any positive value — the lane ends NO_WORKING_SET at its
        # first stop check with alpha identically zero
        Y_mat = np.concatenate([Y_mat, np.zeros((pad, n), np.int32)])
        C_vec = np.concatenate([C_vec, np.ones(pad)])
        g_vec = np.concatenate([g_vec, np.ones(pad)])

    valid_mat = None
    if valids is not None and any(v is not None for v in valids):
        valid_mat = np.ones((bkt, n), bool)
        for i, v in enumerate(valids):
            if v is not None:
                v = _host(v).astype(bool)
                if v.shape != (n,):
                    raise ValueError(
                        f"pack_problems: problem {i} valid mask has "
                        f"shape {v.shape}, want ({n},)"
                    )
                valid_mat[i] = v

    alpha_mat = None
    if alpha0s is not None and any(a is not None for a in alpha0s):
        alpha_mat = np.zeros((bkt, n), np.float64)
        for i, a in enumerate(alpha0s):
            if a is not None:
                a = _host(a).astype(np.float64)
                if a.shape != (n,):
                    raise ValueError(
                        f"pack_problems: problem {i} alpha0 has shape "
                        f"{a.shape}, want ({n},)"
                    )
                alpha_mat[i] = a

    return FleetBatch(Ys=Y_mat, Cs=C_vec, gammas=g_vec, valids=valid_mat,
                      alpha0s=alpha_mat, n_problems=B, bucket=bkt)
