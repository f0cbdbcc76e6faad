"""One cascade leaf as a worker process (``python -m tpusvm_torch.pod.worker``).

The port of tpusvm/pod/worker.py. The worker connects back to the
coordinator, loads ONLY the manifest shards overlapping its leaf's row set
(stream.ShardReader with the ``shards=`` subset — prefetch pipelined,
residency bounded at prefetch_depth + 1 shards, reported as
``max_live_shards`` in READY), scatters those rows into the exact
(slot-addressed) leaf buffer the port's in-process cascade builds from
``stream.partition_from_dataset`` — byte-identical rows, order, padding
and global IDs — then answers TRAIN requests: merge_dedup(recv, own) ->
solve -> extract_svs, the per-rank body of one cascade step. The worker
is stateless across requests (the coordinator owns all round state and
ships buffers explicitly), which is what makes SIGKILL + revive
resumable: a respawned worker re-derives the identical leaf and the
coordinator re-runs the round from its round-start state.

INIT carries the coordinator's resolved torch device and its intra-op
thread count (on the CPU the count can change a reduction's order, so
the workers take the coordinator's to give its bits). A worker told to
use a CUDA device that has none raises; it never falls back to the CPU.
On the card the leaves solve through the kernels the coordinator has
built: each RESULT frame's meta carries the kernel launches that request
made in this process (``launches``, a key the JAX coordinator never
reads).

Fault point ``pod.worker`` fires at every request entry; an injected
SimulatedKill is escalated to a REAL ``SIGKILL`` on the worker's own
pid — no atexit, no socket shutdown, no flush — so chaos runs measure
exactly what survives genuine process death.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import socket
import sys

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.pod.protocol import extract_ctx, recv_msg, send_msg

#: solver_opts keys routed to the host-side shrinking driver
#: (solver/shrink.py) instead of blocked_smo_solve directly
SHRINK_DRIVER_KEYS = frozenset({
    "shrink_every", "shrink_min", "shrink_gap_factor", "max_unshrinks",
})


def leaf_solve(train, cfg, accum_dtype, solver: str, solver_opts, device):
    """One leaf solve, shrinking-driver aware.

    With any shrink-driver knob present (solver="blocked" only — the
    coordinator validates), the solve runs under
    solver.shrink.shrinking_blocked_solve, which the in-process cascade
    refuses. Otherwise this is exactly parallel.cascade._solve, so a
    knob-free pod run is solve-for-solve identical to the in-process
    cascade.
    """
    opts = dict(solver_opts or {})
    if solver == "blocked" and (SHRINK_DRIVER_KEYS & set(opts)):
        from tpusvm_torch.solver.shrink import shrinking_blocked_solve

        return shrinking_blocked_solve(
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
            **opts,
        )
    from tpusvm_torch.parallel.cascade import _solve

    return _solve(train, cfg, accum_dtype, solver, opts, device)


def leaf_shards(dataset, part_mask: np.ndarray):
    """Manifest shard indices whose row ranges intersect this leaf.

    part_mask: (n_rows,) bool — True where the row belongs to the leaf.
    Contiguous assignment intersects a contiguous shard run; stratified
    deals touch every shard. Either way only these shards' bytes are
    ever read.
    """
    out = []
    for i, info in enumerate(dataset.manifest.shards):
        if part_mask[info.row_start:info.row_start + info.n_rows].any():
            out.append(i)
    return out


def load_leaf(dataset, leaf: int, n_leaves: int, stratified: bool,
              prefetch_depth: int, scale: bool, dtype, device="cpu",
              tracer=None):
    """Build this leaf's padded SVBuffer on `device` by streaming its
    shards.

    Byte-identical to the port's in-process leaf,
    ``parallel.cascade._leaf(partition_from_dataset(dataset, n_leaves,
    stratified, scaler), leaf, dtype, device)``: the same assignment
    (stream.assign.assign_rows), the same scaler, the same float64 staging
    before the cast to `dtype` — so pod SV IDs live in the same global row
    space as the in-memory and streamed cascade paths. Returns (part_buf,
    rows_loaded, shards_read, max_live_shards).
    """
    from tpusvm_torch.parallel.svbuffer import SVBuffer
    from tpusvm_torch.stream.assign import assign_rows
    from tpusvm_torch.stream.reader import ShardReader

    n, d = dataset.n_rows, dataset.n_features
    Y_all = dataset.load_labels() if stratified else None
    asg = assign_rows(n, n_leaves, Y=Y_all, stratified=stratified)
    mask = asg.part == leaf
    subset = leaf_shards(dataset, mask)

    cap = asg.cap
    Xp = np.zeros((cap, d), np.float64)
    Yp = np.zeros((cap,), np.int32)
    ids = np.full((cap,), -1, np.int32)
    valid = np.zeros((cap,), bool)

    scaler = dataset.scaler() if scale else None
    reader = ShardReader(dataset, prefetch_depth=prefetch_depth,
                         scaler=scaler, shards=subset)
    infos = [dataset.manifest.shards[i] for i in subset]
    shard_iter = iter(reader)
    for shard_idx, info in zip(subset, infos):
        span = (tracer.span("pod.shard_prefetch", shard=int(shard_idx))
                if tracer is not None else contextlib.nullcontext())
        with span:
            X, Y = next(shard_iter)
            g = np.arange(info.row_start, info.row_start + len(X))
            sel = np.flatnonzero(mask[g])
            if not sel.size:
                continue
            s = asg.slot[g[sel]]
            Xp[s] = X[sel]
            Yp[s] = Y[sel]
            ids[s] = g[sel].astype(np.int32)
            valid[s] = True
    # the iteration ends (and the reader closes) past the last shard
    for _ in shard_iter:
        pass
    rows = int(valid.sum())
    buf = SVBuffer(
        X=torch.as_tensor(Xp).to(device=device, dtype=dtype),
        Y=torch.as_tensor(Yp).to(device),
        alpha=torch.zeros(cap, dtype=dtype, device=device),
        ids=torch.as_tensor(ids).to(device),
        valid=torch.as_tensor(valid).to(device),
    )
    return buf, rows, len(subset), reader.max_live_shards


def _buf_from_arrays(arrays, prefix: str, device="cpu"):
    """An SVBuffer on `device` from a frame's arrays. Each array is copied
    into a fresh contiguous tensor: a decoded frame's arrays may be
    read-only or unaligned, and the kernels take aligned rows."""
    from tpusvm_torch.parallel.svbuffer import SVBuffer

    return SVBuffer(*(torch.tensor(arrays[prefix + f]).to(device)
                      for f in SVBuffer._fields))


def _buf_to_arrays(buf, prefix: str):
    from tpusvm_torch.parallel.svbuffer import SVBuffer

    return {prefix + f: getattr(buf, f).cpu().numpy()
            for f in SVBuffer._fields}


def kernel_wrappers() -> dict:
    """The kernel wrappers a leaf solve can reach, by name; each counts
    its launches in `.launches`."""
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        fused_fupdate_select_kernel, rbf_cross_matvec_kernel)
    from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_kernel,
                                                 inner_smo_multipair_kernel)
    from tpusvm_torch.ops.cuda.pair_rows import pair_rows_kernel

    return {"fused_fupdate": rbf_cross_matvec_kernel,
            "inner_smo": inner_smo_kernel,
            "inner_smo_multipair": inner_smo_multipair_kernel,
            "fused_fupdate_select": fused_fupdate_select_kernel,
            "pair_rows": pair_rows_kernel}


def _launches(wrappers) -> dict:
    return {k: int(fn.launches) for k, fn in wrappers.items()}


def serve(sock: socket.socket, worker_id: int) -> int:
    """HELLO -> INIT -> READY, then the request loop (TRAIN, SNAPSHOT,
    SHUTDOWN)."""
    send_msg(sock, {"op": "hello", "worker_id": worker_id})
    meta, _ = recv_msg(sock)
    if meta["op"] != "init":
        raise RuntimeError(f"expected init, got {meta['op']!r}")

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.device import resolve_device
    from tpusvm_torch.obs.registry import default_registry
    from tpusvm_torch.parallel.svbuffer import extract_svs, merge_dedup
    from tpusvm_torch.stream.format import open_dataset

    # the coordinator's device (raises here when a card is asked for and
    # none is present) and thread count, before anything is loaded
    torch.set_num_threads(int(meta["threads"]))
    dev = resolve_device(meta["device"])
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    cfg = SVMConfig(**meta["svm_config"])
    dtype = getattr(torch, meta["dtype"])
    accum = getattr(torch, meta["accum_dtype"]) if meta["accum_dtype"] \
        else None
    solver = meta["solver"]
    solver_opts = meta["solver_opts"] or {}
    train_cap = int(meta["train_cap"])
    sv_cap = int(meta["sv_cap"])

    # cross-process tracing (an optional INIT key): this worker opens its
    # own trace file in the coordinator's trace dir, named by worker id AND
    # pid so a revived worker starts a fresh file, carrying the
    # coordinator's propagated context in its meta record
    tracer = None
    tmeta = meta.get("trace")
    if tmeta:
        from tpusvm_torch.obs.trace import TraceContext, Tracer

        tracer = Tracer(
            os.path.join(tmeta["dir"],
                         f"worker{worker_id}.p{os.getpid()}.jsonl"),
            role="pod-worker",
            ctx=TraceContext.from_dict(tmeta.get("ctx")),
            max_bytes=tmeta.get("max_bytes"),
            argv=[f"pod.worker:{worker_id}"],
        )

    reg = default_registry()
    dataset = open_dataset(meta["data"])
    load_span = (tracer.span("pod.leaf_load", phase=True,
                             leaf=int(meta["leaf"]))
                 if tracer is not None else contextlib.nullcontext())
    with load_span:
        part_buf, rows, shards_read, live_hwm = load_leaf(
            dataset, int(meta["leaf"]), int(meta["n_leaves"]),
            bool(meta["stratified"]), int(meta["prefetch_depth"]),
            bool(meta["scale"]), dtype, dev, tracer=tracer,
        )
    reg.gauge("pod.worker_rows").set(float(rows))
    reg.gauge("pod.live_shards").set(float(live_hwm))
    reg.counter("pod.shards_read").inc(shards_read)
    wrappers = kernel_wrappers()
    send_msg(sock, {
        "op": "ready",
        "worker_id": worker_id,
        "rows": rows,
        "shards_read": shards_read,
        "max_live_shards": int(live_hwm),
    })

    while True:
        meta, arrays = recv_msg(sock)
        op = meta["op"]
        # the fault point fires before any span opens, so a SimulatedKill
        # escalating to SIGKILL leaves no torn span line in the trace: the
        # killed worker's file ends at its last request
        faults.point("pod.worker", op=op, worker=worker_id,
                     req=meta.get("req"))
        if op == "shutdown":
            if tracer is not None:
                tracer.metrics_snapshot(reg.snapshot())
                tracer.close()
            send_msg(sock, {"op": "bye", "worker_id": worker_id})
            return 0
        if op == "snapshot":
            send_msg(sock, {"op": "snapshot_reply",
                            "req": meta.get("req"),
                            "worker_id": worker_id,
                            "pid": os.getpid(),
                            "snapshot": reg.snapshot()})
            continue
        if op != "train":
            raise RuntimeError(f"unknown pod request {op!r}")
        reg.counter("pod.worker_requests").inc()
        before = _launches(wrappers)
        rctx = extract_ctx(meta)
        span_attrs = {"req": meta.get("req"), "phase": True}
        if rctx is not None:
            # re-parents this request under the coordinator's pod.round
            span_attrs["ctx"] = rctx.to_dict()
        train_span = (tracer.span("pod.leaf_train", **span_attrs)
                      if tracer is not None else contextlib.nullcontext())
        with train_span:
            recv_buf = _buf_from_arrays(arrays, "recv_", dev)
            own = (part_buf if meta["use_partition"]
                   else _buf_from_arrays(arrays, "own_", dev))
            merge_span = (tracer.span("pod.merge") if tracer is not None
                          else contextlib.nullcontext())
            with merge_span:
                train, mcount = merge_dedup(recv_buf, own, train_cap)
            solve_span = (tracer.span("pod.solve") if tracer is not None
                          else contextlib.nullcontext())
            with solve_span:
                res = leaf_solve(train, cfg, accum, solver, solver_opts,
                                 dev)
            sv, svcount = extract_svs(train, res.alpha, cfg.sv_tol, sv_cap)
        after = _launches(wrappers)
        send_msg(
            sock,
            {
                "op": "result",
                "req": meta["req"],
                "worker_id": worker_id,
                "merged_count": int(mcount),
                "sv_count": int(svcount),
                "n_iter": int(res.n_iter),
                "status": int(res.status),
                "b": float(res.b),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]},
            },
            _buf_to_arrays(sv, "sv_"),
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpusvm_torch.pod.worker",
        description="pod cascade leaf worker (spawned by the coordinator)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--faults", default=None,
                    help="JSON fault plan for chaos runs (initial spawn "
                         "only; the coordinator revives without it)")
    args = ap.parse_args(argv)
    if args.faults:
        faults.activate(faults.load_plan(args.faults))
    sock = socket.create_connection((args.host, args.port), timeout=120)
    sock.settimeout(None)
    try:
        return serve(sock, args.worker_id)
    except faults.SimulatedKill:
        # escalate to REAL process death: no flush, no socket shutdown,
        # no atexit — what the coordinator observes is a genuine SIGKILL
        os.kill(os.getpid(), signal.SIGKILL)
        raise  # unreachable
    finally:
        sock.close()


if __name__ == "__main__":
    sys.exit(main())
