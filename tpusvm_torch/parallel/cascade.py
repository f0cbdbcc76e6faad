"""The Cascade SVM (tree and star topologies) over one process or a group.

The port of tpusvm/parallel/cascade.py. The reference's two MPI cascades:

  - the classical binary-reduction tree (mpi_svm_main3.cpp:565-828): each
    round every rank trains on (received SVs [warm alpha] u own set
    [alpha=0]); at step s the ranks r = s (mod 2s) send their SV set to
    rank r-s and go idle; after log2(P)+1 steps rank 0 holds the model;
  - the modified two-layer star (mpi_svm_main2.cpp:439-769): each round
    every rank trains on (global SVs [warm] u own partition [alpha=0]),
    then rank 0 merges all SV sets (own alphas kept, received ones reset
    to 0) and retrains the merged set.

Two round engines give the same values:

  - group=None: one process runs every rank, leaf after leaf, on one
    device (the JAX package's host loop, which its mesh path equals);
    idle tree ranks are skipped;
  - group=<torch.distributed group>: one process per rank (world size ==
    n_shards). Each rank solves its own leaf on its device; the tree ships
    its SV set to rank r - step (the JAX ppermute); the star gathers the
    leaf SV sets, rank 0 runs the merged layer-2 solve and broadcasts it
    (the reference's own pattern, mpi_svm_main2.cpp:540-621, where the JAX
    mesh runs it replicated); rank 0's model and b are broadcast and the
    per-rank diagnostics gathered, so every rank takes the same branch of
    the host-side round loop. Only rank 0 writes the round checkpoint.

SV sets are capacity-padded SVBuffers (parallel/svbuffer.py); dedup by ID
and the warm-start alpha rules are the reference's. The leaf solves are
the port's solvers, so on the card the blocked leaves run kernels #1 and
#2 and the pair leaves pair_rows. Not ported yet, each refused or left
out by name: the tracer (ROADMAP Queue 1 item 12, which also owns the JAX
package's profiled round call) and the fault hooks around the round and
the checkpoint write (item 13): the round state is written once,
atomically, through utils/durable.py.
"""

from __future__ import annotations

import functools
import os
import time
import warnings
import zlib
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tpusvm_torch.config import (CascadeConfig, SVMConfig,
                                 resolve_accum_dtype)
from tpusvm_torch.data.partition import partition as make_partition
from tpusvm_torch.device import resolve_device
from tpusvm_torch.parallel.group import Exchange, rank_device
from tpusvm_torch.parallel.svbuffer import (SVBuffer, empty, extract_svs,
                                            merge_dedup)
from tpusvm_torch.solver.blocked import blocked_smo_solve
from tpusvm_torch.solver.smo import smo_solve
from tpusvm_torch.status import Status
from tpusvm_torch.utils.durable import fsync_replace

_DIAG_KEYS = ("merged_count", "sv_count", "iters", "status")


class CascadeResult(NamedTuple):
    """The final global model (rank 0's converged SV set) and the run's
    history, as host numpy arrays."""

    sv_X: np.ndarray
    sv_Y: np.ndarray
    sv_alpha: np.ndarray
    sv_ids: np.ndarray
    b: float
    rounds: int
    converged: bool
    history: List[Dict[str, Any]]


_CKPT_VERSION = 1


def save_round_state(path: str, global_sv: SVBuffer, prev_ids, rnd: int,
                     b: float, n_shards: Optional[int] = None,
                     topology: Optional[str] = None) -> None:
    """Write the cascade's inter-round state (the broadcast global SV set
    and the previous round's ID set), with the JAX package's keys, so
    either package resumes from the other's file. Atomic and flushed: a
    temp file, fsynced, then renamed (utils/durable.py).

    n_shards/topology, when given, are stored so a resume under another
    partition or topology is refused (the buffer shapes alone cannot tell
    4 shards from 8)."""
    extra = {}
    if n_shards is not None:
        extra["n_shards"] = n_shards
    if topology is not None:
        extra["topology"] = topology
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            ckpt_version=_CKPT_VERSION,
            round=rnd,
            b=b,
            prev_ids=np.asarray(sorted(prev_ids), np.int32),
            sv_X=global_sv.X.cpu().numpy(),
            sv_Y=global_sv.Y.cpu().numpy(),
            sv_alpha=global_sv.alpha.cpu().numpy(),
            sv_ids=global_sv.ids.cpu().numpy(),
            sv_valid=global_sv.valid.cpu().numpy(),
            **extra,
        )
    fsync_replace(tmp, path)


def check_round_state_config(path: str, n_shards: int,
                             topology: str) -> None:
    """Refuse a checkpoint written under another cascade config. A file
    without a stored config passes (the shape checks still apply)."""
    with np.load(path, allow_pickle=False) as z:
        if "n_shards" in z.files and int(z["n_shards"]) != n_shards:
            raise ValueError(
                f"cascade checkpoint config mismatch: it was written for "
                f"n_shards={int(z['n_shards'])}, this run partitions into "
                f"{n_shards}; resume with the original shard count or "
                "start fresh without --resume"
            )
        if "topology" in z.files and str(z["topology"]) != topology:
            raise ValueError(
                f"cascade checkpoint config mismatch: it was written for "
                f"topology={str(z['topology'])!r}, this run uses "
                f"{topology!r}; resume with the original topology or "
                "start fresh without --resume"
            )


def load_round_state(path: str, dtype=torch.float32, device="cpu"):
    """(global_sv: SVBuffer on `device`, prev_ids: set, next_round: int, b).

    alpha keeps its stored dtype: truncating an f64 alpha would make the
    resumed trajectory leave the uninterrupted one."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["ckpt_version"]) != _CKPT_VERSION:
            raise ValueError(
                f"unsupported cascade checkpoint version {int(z['ckpt_version'])}"
            )
        buf = SVBuffer(
            X=torch.as_tensor(z["sv_X"]).to(device=device, dtype=dtype),
            Y=torch.as_tensor(z["sv_Y"]).to(device),
            alpha=torch.as_tensor(z["sv_alpha"]).to(device),
            ids=torch.as_tensor(z["sv_ids"]).to(device),
            valid=torch.as_tensor(z["sv_valid"]).to(device),
        )
        return (
            buf,
            set(z["prev_ids"].tolist()),
            int(z["round"]) + 1,
            float(z["b"]),
        )


def _resume_fingerprint(status, start_round: int, prev_ids,
                        b: float) -> np.ndarray:
    """A process's summary of the checkpoint state it loaded: [status, next
    round, CRC of the sorted SV-ID set, b bits lo, b bits hi], status 0 =
    file missing, 1 = loaded, 2 = load failed. uint32 fields, as the JAX
    package's."""
    ids = np.asarray(sorted(prev_ids), np.int64)
    b_bits = int(np.float64(b).view(np.uint64))
    return np.array(
        [
            int(status),
            start_round,
            zlib.crc32(ids.tobytes()),
            b_bits & 0xFFFFFFFF,
            b_bits >> 32,
        ],
        np.uint32,
    )


def _check_resume_fingerprints(all_fps: np.ndarray) -> None:
    """Raise unless every process loaded the same checkpoint state.

    all_fps: (process_count, 5) stack of _resume_fingerprint rows. Every
    rank must run the same rounds' collectives from the same global SV
    set, so a resume where rank 0 starts at round N while a rank whose
    host lacks the file starts at round 1 would deadlock. A local load
    failure is folded in as status 2 rather than raised before the
    gather, which would leave the other ranks blocked in it."""
    status = all_fps[:, 0]
    if (status == 2).any():
        bad = np.nonzero(status == 2)[0].tolist()
        raise RuntimeError(
            "cascade resume: checkpoint failed to load on processes "
            f"{bad} (stale shapes or corrupt file); see that process's "
            "chained error. All processes must be restarted with a valid, "
            "identical checkpoint."
        )
    if (all_fps == all_fps[0]).all():
        return
    loaded = status.astype(bool)
    if loaded.any() and not loaded.all():
        missing = np.nonzero(~loaded)[0].tolist()
        raise RuntimeError(
            "cascade resume: checkpoint file present on some processes but "
            f"missing on processes {missing}. Multi-host resume requires "
            "checkpoint_path on a shared filesystem (process 0 writes it); "
            "stage the file to every host or fix the path."
        )
    raise RuntimeError(
        "cascade resume: processes loaded DIVERGENT checkpoint state "
        "(per-process [status, round, id_crc32, b_lo, b_hi] = "
        f"{all_fps.tolist()}). "
        "All processes must read the same checkpoint file — use a shared "
        "filesystem or stage identical copies before restarting."
    )


def _verify_resume_agreement(status, start_round: int, prev_ids, b: float,
                             load_err=None,
                             ex: Optional[Exchange] = None) -> None:
    """Gather every rank's checkpoint fingerprint and raise, on every rank
    and before any round collective, if they disagree (a no-op in one
    process). load_err, the local load failure if any, is chained onto
    the raised error."""
    if ex is None:
        return
    fp = _resume_fingerprint(status, start_round, prev_ids, b)
    all_fps = ex.gather_rows(fp).astype(np.uint32)
    try:
        _check_resume_fingerprints(all_fps)
    except RuntimeError as e:
        if load_err is not None:
            raise e from load_err
        raise


def _solve(train: SVBuffer, cfg: SVMConfig, accum_dtype, solver: str,
           solver_opts: dict, device):
    solve = blocked_smo_solve if solver == "blocked" else smo_solve
    return solve(
        train.X,
        train.Y,
        valid=train.valid,
        alpha0=train.alpha,
        C=cfg.C,
        gamma=cfg.gamma,
        eps=cfg.eps,
        tau=cfg.tau,
        max_iter=cfg.max_iter,
        kernel=cfg.kernel,
        degree=cfg.degree,
        coef0=cfg.coef0,
        warm_start=True,
        accum_dtype=accum_dtype,
        device=device,
        **solver_opts,
    )


def star_merge(svs, merged_cap: int):
    """The star's layer-2 union: rank 0's buffer is primary (alpha kept),
    ranks 1..P-1 are concatenated — full padded buffers, in rank order —
    as secondary (alpha zeroed). Positions matter to dedup_first's (id,
    position) order, so this is exactly the flattened all_gather[1:] of
    the JAX round. Returns (merged buffer of capacity merged_cap,
    pre-truncation count)."""
    primary = svs[0]
    if len(svs) > 1:
        secondary = SVBuffer(*(
            torch.cat([getattr(s, f) for s in svs[1:]])
            for f in SVBuffer._fields
        ))
    else:
        secondary = empty(0, primary.X.shape[1], primary.X.dtype,
                          primary.X.device)
    return merge_dedup(primary, secondary, merged_cap)


def _leaf(part, r: int, dtype, device) -> SVBuffer:
    """Rank r's partition chunk as an SVBuffer (alpha 0) on device."""
    return SVBuffer(
        X=torch.as_tensor(part.X[r]).to(device=device, dtype=dtype),
        Y=torch.as_tensor(part.Y[r]).to(device),
        alpha=torch.zeros(part.X.shape[1], dtype=dtype, device=device),
        ids=torch.as_tensor(part.ids[r]).to(device),
        valid=torch.as_tensor(part.valid[r]).to(device),
    )


def _leaf_step(recv: SVBuffer, own: SVBuffer, cap: int, sv_cap: int, solve,
               sv_tol: float):
    """merge -> solve -> extract: (SV buffer, res, [merged count, SV
    count, iterations, status])."""
    train, mcount = merge_dedup(recv, own, cap)
    res = solve(train)
    sv, svcount = extract_svs(train, res.alpha, sv_tol, sv_cap)
    return sv, res, [mcount, svcount, int(res.n_iter), int(res.status)]


def _tree_round_host(leaves, global_sv, *, n_shards, train_cap, sv_cap,
                     sv_tol, solve, **_):
    """One classical-cascade round as a loop over ranks in this process.

    Diag layout (n_shards, n_steps), idle entries 0 / status -1, as the
    JAX round's; idle ranks are skipped (their outputs are never read)."""
    n_steps = n_shards.bit_length()
    own = dict(enumerate(leaves))
    recv = {r: global_sv for r in range(n_shards)}
    diag = np.zeros((4, n_shards, n_steps), np.int64)
    diag[3] = -1
    b = None
    step, si = 1, 0
    while step <= n_shards:
        for r in range(0, n_shards, step):  # active ranks: r % step == 0
            own[r], res, diag[:, r, si] = _leaf_step(
                recv[r], own[r], train_cap, sv_cap, solve, sv_tol)
            if r == 0:
                b = res.b
        if step < n_shards:
            for r in range(step, n_shards, 2 * step):  # senders
                recv[r - step] = own[r]
        step *= 2
        si += 1
    return own[0], b, dict(zip(_DIAG_KEYS, diag))


def _tree_round_group(leaves, global_sv, *, ex, n_shards, train_cap,
                      sv_cap, sv_tol, solve, **_):
    """One classical-cascade round, this process being rank ex.rank:
    its own leaf's solves, the send to rank - step, rank 0's model
    broadcast and the diagnostics gathered."""
    rank = ex.rank
    n_steps = n_shards.bit_length()
    own, recv = leaves[0], global_sv
    row = np.zeros((4, n_steps), np.int64)
    row[3] = -1
    b = 0.0
    step, si = 1, 0
    while step <= n_shards:
        if rank % step == 0:
            own, res, row[:, si] = _leaf_step(recv, own, train_cap, sv_cap,
                                              solve, sv_tol)
            b = res.b
        if step < n_shards:
            if rank % (2 * step) == step:
                ex.send_buffer(own, rank - step)
            elif rank % (2 * step) == 0:
                recv = ex.recv_buffer(own, rank + step)
        step *= 2
        si += 1
    model = ex.broadcast_buffer(own)
    b = float(ex.broadcast_values([b])[0])
    rows = ex.gather_rows(row)  # (P, 4, n_steps)
    return model, b, dict(zip(_DIAG_KEYS, rows.transpose(1, 0, 2)))


def _star_layer2(svs, merged_cap, sv_cap, sv_tol, solve):
    merged, merged_count = star_merge(svs, merged_cap)
    res2 = solve(merged)
    new_global, gcount = extract_svs(merged, res2.alpha, sv_tol, sv_cap)
    return new_global, res2.b, [merged_count, gcount, int(res2.n_iter),
                                int(res2.status)]


def _star_diag(layer1: np.ndarray, layer2) -> dict:
    """(n_shards, 2) per key: each rank's layer-1 numbers, and the layer-2
    solve's replicated down column 1 (as the JAX all_gather of the
    replicated solve gives them)."""
    col2 = np.broadcast_to(np.asarray(layer2, np.int64), layer1.shape)
    both = np.stack([layer1, col2], axis=2)  # (P, 4, 2)
    return dict(zip(_DIAG_KEYS, both.transpose(1, 0, 2).copy()))


def _star_round_host(leaves, global_sv, *, n_shards, train_cap, merged_cap,
                     sv_cap, sv_tol, solve, **_):
    """One modified-cascade round as a loop over ranks in this process."""
    svs, layer1 = [], []
    for r in range(n_shards):
        sv, _, row = _leaf_step(global_sv, leaves[r], train_cap, sv_cap,
                                solve, sv_tol)
        svs.append(sv)
        layer1.append(row)
    new_global, b, layer2 = _star_layer2(svs, merged_cap, sv_cap, sv_tol,
                                         solve)
    return new_global, b, _star_diag(np.asarray(layer1, np.int64), layer2)


def _star_round_group(leaves, global_sv, *, ex, n_shards, train_cap,
                      merged_cap, sv_cap, sv_tol, solve, **_):
    """One modified-cascade round, this process being rank ex.rank: its
    leaf's solve, the leaf SV sets gathered, the layer-2 solve on rank 0
    and its model, b and numbers broadcast."""
    sv, _, row = _leaf_step(global_sv, leaves[0], train_cap, sv_cap, solve,
                            sv_tol)
    svs = ex.gather_buffers(sv)
    if ex.rank == 0:
        new_global, b, layer2 = _star_layer2(svs, merged_cap, sv_cap,
                                             sv_tol, solve)
    else:
        new_global = empty(sv_cap, sv.X.shape[1], sv.X.dtype, sv.X.device)
        b, layer2 = 0.0, [0, 0, 0, 0]
    new_global = ex.broadcast_buffer(new_global)
    vals = ex.broadcast_values([b, *layer2])
    b, layer2 = float(vals[0]), vals[1:].astype(np.int64)
    return new_global, b, _star_diag(ex.gather_rows(row), layer2)


def cascade_fit(
    X: np.ndarray,
    Y: np.ndarray,
    svm_config: SVMConfig = SVMConfig(),
    cascade_config: CascadeConfig = CascadeConfig(),
    group=None,
    dtype=torch.float32,
    accum_dtype="auto",
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    solver: str = "pair",
    solver_opts: Optional[dict] = None,
    stratified: bool = False,
    partition=None,
    tracer=None,
    device="cuda",
) -> CascadeResult:
    """Train a binary SVM with the cascade.

    X must already be scaled (the reference scales with the global min/max
    before scattering, mpi_svm_main3.cpp:529-539). accum_dtype: "auto" =
    f64 accumulators, None = the features' dtype.

    group: None runs every rank in this process; a torch.distributed
    process group (parallel/group.py: init_group) makes this process rank
    group.rank() of world size == n_shards, and every rank must call
    cascade_fit with the same arguments. device: where the leaves solve
    ("cuda" unless asked otherwise; with a group, rank r takes cuda:{r %
    device_count}).

    partition: a prebuilt data.partition.Partition (already scaled) used
    instead of partitioning X/Y here (X/Y/stratified are then ignored);
    its leaf count must equal n_shards.

    checkpoint_path: the inter-round state (global SV buffer, previous ID
    set) is written there after every round (by rank 0 alone);
    resume=True restarts from that file if it exists (the same X/Y and
    config must be passed again). The file is the JAX package's format.

    solver: the leaf solver, "pair" (default; the reference-faithful one
    each MPI rank runs) or "blocked"; solver_opts: its knobs. The
    shrinking driver's knobs are refused, as in the JAX package.

    stratified: deal each class round-robin over the shards instead of
    the contiguous scatter (data/partition.py).

    tracer: not ported yet (ROADMAP Queue 1 item 12); must be None.
    """
    if solver not in ("pair", "blocked"):
        raise ValueError(f"unknown solver {solver!r}")
    driver_keys = sorted(set(solver_opts or ()) & {
        "shrink_every", "shrink_min", "shrink_gap_factor",
        "max_unshrinks"})
    if driver_keys:
        raise ValueError(
            f"solver_opts {driver_keys} belong to the host-side "
            "shrinking driver (tpusvm.solver.shrink), which cannot run "
            "inside the cascade's shard_map leaves; use --mode single "
            "for shrinking, or drop the knobs (shrink_stable alone is "
            "a valid leaf-solver static: stability tracking only)"
        )
    if tracer is not None:
        raise NotImplementedError(
            "cascade_fit(tracer=...): the trace and telemetry layer is not "
            "ported yet (ROADMAP Queue 1 item 12); pass tracer=None")
    accum_dtype = resolve_accum_dtype(accum_dtype)
    cc = cascade_config
    n_shards = cc.n_shards
    ex = None
    if group is not None:
        ex = Exchange(group)
        if ex.size != n_shards:
            raise ValueError(
                f"the process group has {ex.size} ranks but "
                f"cascade_config.n_shards is {n_shards}: the group engine "
                "runs one rank per shard")
        dev = rank_device(device, ex.rank)
    else:
        dev = resolve_device(device)
    is_rank0 = ex is None or ex.rank == 0
    sv_cap = cc.sv_capacity

    if partition is not None:
        if partition.X.shape[0] != n_shards:
            raise ValueError(
                f"prebuilt partition has {partition.X.shape[0]} leaves, "
                f"cascade_config.n_shards is {n_shards}"
            )
        part = partition
    else:
        part = make_partition(np.asarray(X), np.asarray(Y), n_shards,
                              stratified=stratified)
    chunk = part.X.shape[1]
    d = part.X.shape[2]
    train_cap = chunk + sv_cap
    # the star's layer-2 buffer only holds the deduped union's valid rows;
    # a round that overflows a tight one is re-run at full width below
    merged_cap = cc.resolved_star_merge_capacity()

    global_sv = empty(sv_cap, d, dtype, dev)
    prev_ids: set = set()  # reference: global_ID_sv starts empty
    history: List[Dict[str, Any]] = []
    converged = False
    rounds = 0
    b = 0.0
    start_round = 1

    # resume before any leaf is placed: a refused checkpoint fails at once
    if resume and checkpoint_path is not None:
        ckpt_status = 1 if os.path.exists(checkpoint_path) else 0
        load_err = None
        if ckpt_status:
            # a load failure must not raise before the agreement gather,
            # or the other ranks would block in it: fold it into the
            # fingerprint (status 2) and raise after
            try:
                check_round_state_config(checkpoint_path, n_shards,
                                         cc.topology)
                global_sv, prev_ids, start_round, b = load_round_state(
                    checkpoint_path, dtype, dev)
                if global_sv.capacity != sv_cap or global_sv.X.shape[1] != d:
                    raise ValueError(
                        "cascade checkpoint shapes do not match this run: "
                        f"capacity {global_sv.capacity} vs {sv_cap}, "
                        f"d {global_sv.X.shape[1]} vs {d}"
                    )
            except Exception as e:  # noqa: BLE001 — re-raised below
                ckpt_status, load_err = 2, e
        _verify_resume_agreement(ckpt_status, start_round, prev_ids, b,
                                 load_err, ex)
        if load_err is not None:
            raise load_err
        if ckpt_status == 1:
            if verbose and is_rank0:
                print(f"resuming cascade from round {start_round} "
                      f"({len(prev_ids)} SVs in checkpoint)")
            rounds = start_round - 1
            if start_round > svm_config.max_rounds:
                warnings.warn(
                    f"cascade checkpoint is already at round {rounds} >= "
                    f"max_rounds={svm_config.max_rounds}; returning the "
                    "checkpointed model without training (raise max_rounds "
                    "to continue)",
                    RuntimeWarning,
                    stacklevel=2,
                )

    leaves = ([_leaf(part, ex.rank, dtype, dev)] if ex is not None else
              [_leaf(part, r, dtype, dev) for r in range(n_shards)])
    solve = functools.partial(
        _solve, cfg=svm_config, accum_dtype=accum_dtype, solver=solver,
        solver_opts=dict(solver_opts or {}), device=dev)
    host = ex is None
    if cc.topology == "tree":
        round_fn = _tree_round_host if host else _tree_round_group
    else:
        round_fn = _star_round_host if host else _star_round_group
    common = dict(ex=ex, n_shards=n_shards, train_cap=train_cap,
                  sv_cap=sv_cap, sv_tol=svm_config.sv_tol, solve=solve)

    # the result if the loop never runs (resumed past max_rounds)
    new_global = global_sv
    full_merged_cap = n_shards * sv_cap  # star layer-2 concatenation bound

    for rnd in range(start_round, svm_config.max_rounds + 1):
        t0 = time.perf_counter()
        while True:
            out_global, b_round, diag = round_fn(
                leaves, global_sv, merged_cap=merged_cap, **common)
            if (
                cc.topology == "star"
                and merged_cap < full_merged_cap
                and diag["merged_count"][:, 1].max() > merged_cap
            ):
                # the worker-SV union overflowed the tight layer-2 buffer,
                # so this round's merged solve saw a truncated union:
                # re-run it at the concatenation bound, which always fits,
                # and stay there (the union grows with the global set)
                warnings.warn(
                    f"cascade round {rnd}: worker-SV union of "
                    f"{diag['merged_count'][:, 1].max()} rows "
                    f"overflowed the star merge buffer ({merged_cap}); "
                    f"retrying the round with the full concatenation "
                    f"capacity {full_merged_cap} (set "
                    "star_merge_capacity to avoid the recompile)",
                    RuntimeWarning,
                    stacklevel=2,
                )
                merged_cap = full_merged_cap
                continue
            break
        new_global, b = out_global, float(b_round)
        dt = time.perf_counter() - t0
        rounds = rnd

        # overflow detection: pre-truncation counts against capacities
        if cc.topology == "tree":
            if diag["merged_count"].max() > train_cap:
                raise RuntimeError(
                    f"cascade train buffer overflow: {diag['merged_count'].max()}"
                    f" > capacity {train_cap}; increase sv_capacity"
                )
        else:
            if diag["merged_count"][:, 0].max() > train_cap:
                raise RuntimeError(
                    f"cascade train buffer overflow: "
                    f"{diag['merged_count'][:, 0].max()} > capacity {train_cap}"
                )
        if diag["sv_count"].max() > sv_cap:
            raise RuntimeError(
                f"SV buffer overflow: {diag['sv_count'].max()} SVs > capacity "
                f"{sv_cap}; increase sv_capacity"
            )

        ids_arr = new_global.ids[new_global.valid].cpu().numpy()
        ids_now = set(ids_arr.tolist())
        history.append({
            "round": rnd,
            "sv_count": len(ids_now),
            "sv_ids": np.sort(ids_arr),
            "b": b,
            "time_s": dt,
            "iters": diag["iters"],
            "status": diag["status"],
        })
        bad = diag["status"][diag["status"] >= int(Status.INFEASIBLE_UV)]
        if bad.size:
            warnings.warn(
                f"cascade round {rnd}: solver bail-outs on some shards "
                f"(statuses {sorted(set(Status(int(s)).name for s in bad))}); "
                "the merged model may be partially optimised",
                RuntimeWarning,
                stacklevel=2,
            )
        if verbose and is_rank0:
            print(
                f"=== Round {rnd} === SV count = {len(ids_now)}, "
                f"b = {b:.15f}, {dt:.3f}s"
            )

        if not ids_now:
            # every shard failed to find a working set (e.g. label-sorted
            # input making each partition single-class): fail loudly
            # instead of returning a NaN model
            raise RuntimeError(
                "cascade produced an empty global support-vector set — all "
                "per-shard solves found no working set (is the data sorted "
                "by label, making partitions single-class?); statuses: "
                f"{diag['status'].tolist()}"
            )

        # ID-set convergence test (mpi_svm_main3.cpp:720-744)
        if ids_now == prev_ids:
            converged = True
        prev_ids = ids_now

        if checkpoint_path is not None and is_rank0:
            # every rank holds the same round state; rank 0 alone writes it
            # (the reference's rank-0 IO, and no rename race on a shared
            # filesystem)
            save_round_state(checkpoint_path, new_global, prev_ids, rnd, b,
                             n_shards=n_shards, topology=cc.topology)

        if converged:
            break
        global_sv = new_global

    mask = new_global.valid.cpu().numpy()
    return CascadeResult(
        sv_X=new_global.X.cpu().numpy()[mask],
        sv_Y=new_global.Y.cpu().numpy()[mask],
        sv_alpha=new_global.alpha.cpu().numpy()[mask],
        sv_ids=new_global.ids.cpu().numpy()[mask],
        b=b,
        rounds=rounds,
        converged=converged,
        history=history,
    )
