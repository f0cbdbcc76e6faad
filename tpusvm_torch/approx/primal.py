"""Streaming primal trainer: linear SVM over mapped features, shard by shard.

The port of tpusvm/approx/primal.py: a deterministic mini-batch Pegasos
solve (Shalev-Shwartz et al. 2007) of

    min_w  lambda/2 ||w||^2 + mean_i hinge(y_i (w.Phi(x_i) - b))

over (Phi(X_shard), Y_shard) blocks off a ShardReader whose prefetch hook
maps each shard on the card, so the (n, D) mapped matrix never exists;
peak residency stays the reader's prefetch_depth + 1 bound plus one batch.
lambda = 1/(C*n), so C keeps its exact-path meaning.

The step runs as plain torch on the card, the JAX step's arithmetic in
f32: eta = 1/(lambda * t_ex) with t_ex counted in EXAMPLES, the projection
onto ||w|| <= 1/sqrt(lambda), the bias's own 1/sqrt(t_b) step on the batch
counter, and a zero-padded tail batch with its mask. Every contraction
goes through ops/rbf.py:matmul_p at the trust tier.

Termination is the JAX package's objective plateau: the epoch-mean
regularised objective must move by at most `tol` relative (floored at
0.05 absolute) between consecutive epochs (CONVERGED); exhausting
`epochs` reports MAX_ITER. The JAX loop reads each batch's objective on
the host; here the epoch's objective sum is an f64 running sum on the
card, in the same order, read once an epoch. Sequential f64 adds of the
same f32 values give the same bits as the host's Python float sum, so the
plateau decision and `epochs_run` follow JAX's, with one host sync an
epoch instead of one a batch.

The result embeds in the standard model layout: f(x) = w.Phi(x) - bias is
a one-support-vector linear model over mapped features (sv_X = w[None, :],
alpha*y = [1], b = bias), so serialization and scoring need nothing new.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpusvm_torch.device import host_to_device
from tpusvm_torch.ops.rbf import matmul_p
from tpusvm_torch.status import Status


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b for 1-d tensors, at the trust tier."""
    return matmul_p(a[None, :], b)[0]


def primal_batch_step(w, b, Z, y, mask, lam, t_ex, t_b):
    """One mini-batch subgradient step; returns (w, b, batch objective).

    Z is a fixed-shape (batch, D) block (a short tail zero-padded with
    mask False), y in {+1, -1} as float, mask the valid rows. lam, t_ex
    and t_b are host numbers; the scalar factors are formed from them in
    f32 on the host (as the JAX step forms them in f32), so the step adds
    no host-to-device copy. The objective is the batch's regularised
    value BEFORE the step."""
    f32 = np.float32
    lam = f32(lam)
    eta = f32(1.0) / (lam * f32(t_ex))
    shrink = float(f32(1.0) - eta * lam)
    radius = float(f32(1.0) / np.sqrt(lam))
    step_b = float(f32(1.0) / np.sqrt(f32(t_b)))
    k = torch.clamp_min(mask.sum().to(Z.dtype), 1.0)
    margin = y * (matmul_p(Z, w) - b)
    zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
    hinge = torch.where(mask, torch.clamp_min(1.0 - margin, 0.0), zero)
    obj = float(f32(0.5) * lam) * _dot(w, w) + hinge.sum() / k
    viol = torch.where(mask & (margin < 1.0), y, zero)
    w = shrink * w + (float(eta) / k) * matmul_p(viol[None, :], Z)[0]
    norm = torch.sqrt(torch.clamp_min(_dot(w, w), 1e-30))
    w = w * torch.clamp_max(radius / norm, 1.0)
    b = b - step_b * viol.sum() / k
    return w, b, obj


@dataclasses.dataclass
class PrimalResult:
    w: np.ndarray          # (D,) primal weights in mapped space
    bias: float            # f(x) = w.Phi(x) - bias
    status: Status         # CONVERGED (objective plateau) | MAX_ITER
    epochs_run: int
    n_steps: int           # mini-batch updates taken
    n_rows: int            # rows consumed per epoch
    objective: float       # final epoch-mean regularised objective
    host_syncs: int = 0    # reads of a card value on the host


def streaming_primal_fit(
    make_reader: Callable[[int], "object"],
    dim: int,
    *,
    C: float,
    n_rows: int,
    batch: int = 1024,
    epochs: int = 64,
    tol: float = 0.05,
    dtype=np.float32,
    device="cuda",
) -> PrimalResult:
    """Fit the streaming primal SVM on `device`.

    make_reader(epoch) returns a FRESH single-pass reader of (Z, Y)
    blocks of mapped features (a stream.ShardReader with the map as its
    transform hook; Z a tensor on `device` or a numpy array). dim is the
    mapped width D; n_rows the manifest row count (sets lambda = 1/(C*n)).
    """
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = torch.device(device)
    dt = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    lam = 1.0 / (float(C) * float(n_rows))
    w = torch.zeros(dim, dtype=dt, device=dev)
    b = torch.zeros((), dtype=dt, device=dev)
    t = 1          # batch counter (the bias step's clock)
    t_ex = 0       # examples-seen counter (the Pegasos clock)
    prev_obj = None
    status = Status.MAX_ITER
    epochs_run = 0
    n_steps = 0
    syncs = 0
    ones = torch.ones(batch, dtype=torch.bool, device=dev)
    for epoch in range(epochs):
        reader = make_reader(epoch)
        obj_sum = torch.zeros((), dtype=torch.float64, device=dev)
        obj_batches, rows_seen = 0, 0
        for Zb, Yb in reader.batches(batch):
            m = len(Zb)
            rows_seen += m
            Zb = torch.as_tensor(Zb, device=dev).to(dt)
            yb = host_to_device(np.asarray(Yb), dt, dev)
            if m < batch:
                # fixed-shape pad: the tail's padded rows are inert
                Zp = torch.zeros((batch, dim), dtype=dt, device=dev)
                Zp[:m] = Zb
                yp = torch.zeros(batch, dtype=dt, device=dev)
                yp[:m] = yb
                mask = torch.arange(batch, device=dev) < m
            else:
                Zp, yp, mask = Zb, yb, ones
            t_ex += m
            w, b, obj = primal_batch_step(w, b, Zp, yp, mask, lam,
                                          float(t_ex), float(t))
            # the host's float(obj) sum, kept on the card in f64
            obj_sum += obj.to(torch.float64)
            obj_batches += 1
            t += 1
            n_steps += 1
        epochs_run += 1
        if rows_seen != n_rows:
            raise ValueError(
                f"streaming primal epoch {epoch} consumed {rows_seen} "
                f"rows, manifest says {n_rows} (reader misconfigured?)"
            )
        epoch_obj = float(obj_sum) / max(obj_batches, 1)
        syncs += 1
        if prev_obj is not None and abs(prev_obj - epoch_obj) <= \
                tol * max(abs(prev_obj), 0.05):
            status = Status.CONVERGED
            prev_obj = epoch_obj
            break
        prev_obj = epoch_obj
    wb = torch.cat([w, b[None]]).cpu().numpy()  # one read for both
    syncs += 1
    w_host, bias = wb[:-1].astype(np.float32), float(wb[-1])
    return PrimalResult(
        w=w_host, bias=bias, status=status, epochs_run=epochs_run,
        n_steps=n_steps, n_rows=n_rows,
        objective=float(prev_obj if prev_obj is not None else 0.0),
        host_syncs=syncs,
    )
