"""Crash-safe training on one device: periodic, bit-exact solver checkpoints.

The port of tpusvm/solver/checkpoint.py. `checkpointed_blocked_solve` runs
blocked_smo_solve's outer loop in segments of `checkpoint_every` rounds
(pause_at), copies the complete loop carry (`OuterState`: alpha, the
accumulated f, b_high/b_low, the counters, the refine flags, the shrink
counters, the K-row cache, the fused-selection candidates) to the host
between segments, and writes it atomically: a temp file, fsynced, then
renamed over the checkpoint (utils/durable.py).

The bit-identity argument is the JAX package's: a round is a function of
the carry and of the invariants (X, Y, the configuration), numpy holds the
carry's values exactly, so a resumed solve runs the rounds the
uninterrupted one would have run, on the same values.

A checkpoint of another solve is refused by fingerprint, naming the fields
that differ: the file carries the solve's configuration, CRCs of the
training bytes and an `engine` key, so a checkpoint of the JAX package (no
engine key; its trajectory differs from the port's) is refused rather than
resumed. The write sits behind the ``solver.outer_checkpoint`` fault
point inside a Retry (faults/), as in the JAX package: a transient fault
re-runs the whole write, a simulated kill dies before the rename and
leaves the previous checkpoint whole.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.device import resolve_device
from tpusvm_torch.solver.blocked import OuterState, blocked_smo_solve
from tpusvm_torch.status import Status
from tpusvm_torch.utils.durable import fsync_replace

SOLVER_CKPT_VERSION = 1
ENGINE = "tpusvm_torch"

#: the configuration the fingerprint pins (a resumed solve with any of
#: these changed would walk another trajectory); the JAX package's names
_FP_KEYS = ("C", "gamma", "eps", "tau", "max_iter", "q", "max_outer",
            "max_inner", "wss", "inner", "refine", "max_refines",
            "selection", "matmul_precision", "kernel", "degree", "coef0",
            "kernel_fast", "telemetry", "shrink_stable", "krow_cache",
            "pallas_fused_selection", "fused_fupdate", "pallas_multipair",
            "multipair", "pallas_eta_exclude", "eta_exclude",
            "fused_selection", "_seed_in_box")


class WatchdogTimeout(RuntimeError):
    """A checkpointed solve stopped by its supervisor between segments,
    after its latest checkpoint was written, so a resume=True run continues
    bit-identically from that carry."""

    def __init__(self, path: str, n_outer: int):
        self.checkpoint_path = path
        self.n_outer = n_outer
        super().__init__(
            f"solve stopped by watchdog at outer round {n_outer}; resume "
            f"from checkpoint {path!r}")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else str(dtype).replace("torch.", "")


def solve_fingerprint(X, Y, accum_dtype, solver_kwargs: dict) -> dict:
    """JSON-able identity of a solve: engine, shapes, dtypes, data CRCs and
    the configuration."""
    X = _host(X)
    Y = _host(Y)
    fp = {
        "engine": ENGINE,
        "n": int(X.shape[0]),
        "d": int(X.shape[1]),
        "x_dtype": str(X.dtype),
        "accum_dtype": _dtype_name(accum_dtype),
        "x_crc32": zlib.crc32(np.ascontiguousarray(X).tobytes()),
        "y_crc32": zlib.crc32(np.ascontiguousarray(Y).tobytes()),
    }
    for k in _FP_KEYS:
        if k in solver_kwargs:
            fp[k] = solver_kwargs[k]
    return fp


def save_solver_state(path: str, state: OuterState, fingerprint: dict,
                      retry: Optional[faults.Retry] = None) -> None:
    """Atomically write an outer-loop carry and its fingerprint: the
    previous checkpoint stays whole until the new one is on disk.

    The injection point fires inside the retried write, so a transient
    rule fails the write and the retry re-runs it, while a kill rule dies
    where a real crash would: before the rename."""
    arrays = state.arrays()

    def _write():
        faults.point("solver.outer_checkpoint", path=path,
                     round=int(state.n_outer))
        tmp = path + ".tmp"
        np.savez(tmp, ckpt_version=SOLVER_CKPT_VERSION,
                 fingerprint=json.dumps(fingerprint, sort_keys=True),
                 **arrays)
        fsync_replace(tmp + ".npz", path)  # np.savez appends .npz

    if retry is None:
        retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                             op="solver.outer_checkpoint")
    retry(_write)


def load_solver_state(path: str, fingerprint: dict) -> OuterState:
    """Load a carry; refuse a JAX checkpoint, another format version, or
    (naming the differing fields) a checkpoint of another solve."""
    with np.load(path, allow_pickle=False) as z:
        if "ckpt_version" not in z.files:
            raise ValueError(
                f"{path!r} is not a tpusvm solver checkpoint "
                "(no ckpt_version)")
        saved = json.loads(str(z["fingerprint"]))
        if saved.get("engine") != ENGINE:
            raise ValueError(
                f"{path!r} was written by "
                f"{saved.get('engine') or 'the JAX package (tpusvm)'}, not "
                f"by {ENGINE}: the two packages' trajectories differ, so "
                "its carry cannot resume here — restart the solve fresh")
        v = int(z["ckpt_version"])
        if v != SOLVER_CKPT_VERSION:
            raise ValueError(
                f"unsupported solver checkpoint version {v} (this build "
                f"reads version {SOLVER_CKPT_VERSION})")
        want = json.loads(json.dumps(fingerprint, sort_keys=True))
        if saved != want:
            diff = sorted(k for k in set(saved) | set(want)
                          if saved.get(k) != want.get(k))
            raise ValueError(
                "solver checkpoint does not belong to this solve "
                f"(differing fields: {diff}); it was written for "
                f"{ {k: saved.get(k) for k in diff} }, this run has "
                f"{ {k: want.get(k) for k in diff} }")
        return OuterState.from_arrays(z)


def checkpointed_blocked_solve(X, Y, *, checkpoint_path: str,
                               checkpoint_every: int = 64,
                               resume: bool = False,
                               keep_checkpoint: bool = False,
                               watchdog=None, accum_dtype=None,
                               device="cuda", **solver_kwargs):
    """blocked_smo_solve with a checkpoint every `checkpoint_every` rounds.

    After each segment the carry is written atomically to
    `checkpoint_path`. resume=True starts from that file when it exists (a
    missing file means a fresh start); a checkpoint of another solve is
    refused with the differing fields named. A solve that ends deletes its
    checkpoint unless keep_checkpoint=True. The result equals the
    uninterrupted blocked_smo_solve bit for bit.

    A tracer in solver_kwargs goes to every segment (blocked_smo_solve's
    solve.* spans); it is no part of the fingerprint.

    watchdog: a zero-argument callable consulted after each checkpoint is
    on disk; a true answer raises WatchdogTimeout, from which a resume=True
    run continues.
    """
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    for k in ("resume_state", "pause_at", "return_state"):
        if k in solver_kwargs:
            raise ValueError(
                f"{k} belongs to the checkpointed solve's segmenting "
                "surface; it cannot be passed through")
    dev = resolve_device(device)
    fp = solve_fingerprint(X, Y, accum_dtype, solver_kwargs)
    state = None
    if resume and os.path.exists(checkpoint_path):
        state = load_solver_state(checkpoint_path, fp)
    Xd = torch.as_tensor(X, device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                         op="solver.outer_checkpoint")
    while True:
        start = state.n_outer if state is not None else 0
        res, state = blocked_smo_solve(
            Xd, Yd, accum_dtype=accum_dtype, resume_state=state,
            pause_at=start + checkpoint_every, return_state=True,
            device=dev, **solver_kwargs)
        if Status(state.status) != Status.RUNNING:
            if not keep_checkpoint and os.path.exists(checkpoint_path):
                os.remove(checkpoint_path)
            return res
        save_solver_state(checkpoint_path, state, fp, retry=retry)
        if watchdog is not None and watchdog():
            raise WatchdogTimeout(checkpoint_path, state.n_outer)
