"""Chaos CLI: ``python -m tpusvm_torch.faults <command> [--device cpu]``.

The port of the JAX package's chaos command line (tpusvm/faults/
__main__.py), with the commands whose tiers are ported. Each smoke runs
on the card unless ``--device cpu`` is given.

  validate PLAN.json  Parse + validate a fault plan (rule points/kinds
                      checked against the registry); prints the rules.
  kill-resume-smoke   The crash-safe-training gate. Trains a tiny
                      deterministic problem three ways — uninterrupted
                      plain solve, checkpointed solve, and checkpointed
                      solves KILLED at every checkpoint in turn and then
                      resumed — and asserts every variant produces
                      bit-identical model state (alpha bytes, SV ids, b).
                      Also proves transient checkpoint-write faults are
                      retried to success. Non-zero exit on any failure.
  pod-chaos-smoke     The pod-cascade gate (tpusvm_torch.pod): an
                      out-of-core multiprocess cascade trains from a
                      sharded dataset three ways — an uninterrupted
                      control, a run whose worker 1 REALLY SIGKILLs
                      itself mid-round (revived by the coordinator, the
                      round re-run from coordinator-held state), and a
                      run whose COORDINATOR is killed entering round 2
                      then resumed from its fsync'd per-round
                      checkpoint. Asserts: both recovery arms are
                      BIT-IDENTICAL to the control (SV-ID set, alpha
                      bytes, b), the worker kill actually fired (>= 1
                      revive) and the coordinator kill left a durable
                      checkpoint behind, and every dataset row is
                      accounted for across the workers in every arm. The
                      JAX command's third arm (the traced re-run) waits
                      for the trace layer (ROADMAP Queue 1 item 12).

  swap-chaos-smoke    The hot-swap gate (tpusvm_torch.serve): client
                      threads stream requests at a served model while
                      eight swaps alternate between two models with
                      distinct scores under a seeded fault plan (a kill
                      mid-stage, a corrupted staged artifact, latency on
                      the others). Asserts: every response is bitwise one
                      of the two generations' scores (no torn reads), no
                      request is lost, the kill fired and left the old
                      generation serving, the corruption came back as a
                      classified ModelLoadError with /healthz degraded,
                      and a clean swap afterwards recovers health.

The JAX package's other chaos commands belong to tiers not ported yet;
each says so, names its ROADMAP Queue 1 item, and exits 2.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

#: chaos commands of tiers not ported yet -> (tier, ROADMAP Queue 1 item)
NOT_PORTED = {
    "autopilot-chaos-smoke": ("the closed loop (autopilot)", "11(c)"),
    "tenant-chaos-smoke": ("the closed loop (tenants)", "11(c)"),
    "router-chaos-smoke": ("the router", "11(d)"),
}


def _kill_resume_smoke(device: str) -> int:
    import os

    import numpy as np
    import torch

    from tpusvm_torch import faults
    from tpusvm_torch.data import MinMaxScaler, rings
    from tpusvm_torch.oracle import get_sv_indices
    from tpusvm_torch.solver.blocked import blocked_smo_solve
    from tpusvm_torch.solver.checkpoint import checkpointed_blocked_solve
    from tpusvm_torch.status import Status

    EVERY = 4
    X, Y = rings(n=400, seed=11)
    Xs = torch.as_tensor(MinMaxScaler().fit_transform(X), dtype=torch.float32)
    Yd = torch.as_tensor(Y)
    kw = dict(C=10.0, gamma=10.0, q=16, accum_dtype=torch.float64,
              device=device)

    plain = blocked_smo_solve(Xs, Yd, **kw)
    if Status(int(plain.status)) != Status.CONVERGED:
        print(f"KILL-RESUME SMOKE FAILED: reference solve ended "
              f"{Status(int(plain.status)).name}")
        return 1
    ref_alpha = plain.alpha.cpu().numpy()
    ref_sv = get_sv_indices(ref_alpha, 1e-8)
    n_ckpts = max(1, int(plain.n_outer) // EVERY)
    failures = []

    def run(ck, resume=False):
        return checkpointed_blocked_solve(
            Xs, Yd, checkpoint_path=ck, checkpoint_every=EVERY,
            resume=resume, **kw,
        )

    def identical(res):
        a = res.alpha.cpu().numpy()
        return (a.tobytes() == ref_alpha.tobytes()
                and np.array_equal(get_sv_indices(a, 1e-8), ref_sv)
                and float(res.b) == float(plain.b))

    with tempfile.TemporaryDirectory() as td:
        # 1. checkpointed-but-never-killed == plain, bit for bit
        ck = os.path.join(td, "ck.npz")
        if not identical(run(ck)):
            failures.append("uninterrupted checkpointed solve diverged "
                            "from the plain solve")

        # 2. kill at EVERY checkpoint, resume, still bit-identical
        for k in range(1, n_ckpts + 1):
            ckk = os.path.join(td, f"ck{k}.npz")
            plan = faults.FaultPlan(
                [faults.FaultRule(point="solver.outer_checkpoint",
                                  kind="kill", at_hit=k)], seed=0)
            died = False
            try:
                with faults.active(plan):
                    run(ckk)
            except faults.SimulatedKill:
                died = True
            if not died:
                failures.append(f"kill rule at checkpoint {k} never fired")
                continue
            if not identical(run(ckk, resume=True)):
                failures.append(
                    f"resume after kill at checkpoint {k} is not "
                    "bit-identical")

        # 3. transient write faults are retried to success
        ckt = os.path.join(td, "ckt.npz")
        plan = faults.FaultPlan(
            [faults.FaultRule(point="solver.outer_checkpoint",
                              kind="transient", max_hits=2)], seed=0)
        with faults.active(plan):
            if not identical(run(ckt)):
                failures.append("solve under transient checkpoint-write "
                                "faults diverged")

    if failures:
        for f in failures:
            print(f"KILL-RESUME SMOKE FAILED: {f}")
        return 1
    print(f"kill-resume smoke ok: {n_ckpts} kill points, "
          f"{int(plain.n_outer)} outer rounds, {len(ref_sv)} SVs — every "
          f"resumed solve bit-identical to the uninterrupted run "
          f"(device {device})")
    return 0


def _pod_chaos_smoke(device: str) -> int:
    import json
    import os
    import warnings

    from tpusvm_torch import faults
    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.pod import pod_fit
    from tpusvm_torch.stream import ingest_arrays

    warnings.filterwarnings("ignore", category=UserWarning)

    X, Y = rings(n=192, seed=3)
    cfg = SVMConfig(C=10.0, gamma=10.0, max_rounds=12)
    cc = CascadeConfig(n_shards=4, sv_capacity=128, topology="tree")
    failures = []
    with tempfile.TemporaryDirectory() as td:
        ds = os.path.join(td, "ds")
        ingest_arrays(ds, X, Y, rows_per_shard=24)

        ctrl = pod_fit(ds, cfg, cc, device=device)
        ctrl_ids = set(ctrl.sv_ids.tolist())
        ctrl_alpha = ctrl.sv_alpha.tobytes()
        if not ctrl.converged:
            print("POD CHAOS SMOKE FAILED: control run did not converge")
            return 1

        def check(arm, res):
            if set(res.sv_ids.tolist()) != ctrl_ids:
                failures.append(f"{arm}: SV-ID set diverges from control")
            elif res.sv_alpha.tobytes() != ctrl_alpha:
                failures.append(f"{arm}: alpha bytes diverge from control")
            if res.b != ctrl.b:
                failures.append(f"{arm}: b diverges "
                                f"({res.b!r} vs {ctrl.b!r})")
            if sum(res.worker_rows) != len(Y):
                failures.append(f"{arm}: rows lost — workers hold "
                                f"{sum(res.worker_rows)} of {len(Y)}")

        # arm 1: worker 1 REALLY SIGKILLs itself on its 2nd request (mid
        # round 2, after its round-1 result already merged); the
        # coordinator revives it and re-runs the round from its own held
        # state — any stale pre-kill reply a surviving worker queued must
        # be discarded, or alpha bytes diverge here
        plan = os.path.join(td, "plan.json")
        tmp = plan + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format_version": 1, "seed": 0, "rules": [
                {"point": "pod.worker", "kind": "kill", "at_hit": 2}]}, f)
        os.replace(tmp, plan)
        r1 = pod_fit(ds, cfg, cc, worker_faults={1: plan}, device=device)
        if r1.revives < 1:
            failures.append("worker-kill arm: the kill never fired "
                            "(zero revives)")
        check("worker-kill arm", r1)

        # arm 2: the COORDINATOR dies entering round 2, leaving the
        # round-1 checkpoint (fsync_replace'd) behind; a fresh
        # coordinator resumes from it — workers reload their leaves from
        # the manifest and the merged trajectory replays
        ck = os.path.join(td, "ck.npz")
        killed = False
        try:
            with faults.active(faults.FaultPlan(
                    [faults.FaultRule(point="pod.round", kind="kill",
                                      at_hit=2)])):
                pod_fit(ds, cfg, cc, checkpoint_path=ck, device=device)
        except faults.SimulatedKill:
            killed = True
        if not killed:
            failures.append("coordinator-kill arm: the kill never fired")
        elif not os.path.exists(ck):
            failures.append("coordinator-kill arm: no durable checkpoint "
                            "at the kill")
        else:
            r2 = pod_fit(ds, cfg, cc, checkpoint_path=ck, resume=True,
                         device=device)
            check("coordinator-resume arm", r2)

    if failures:
        for f in failures:
            print(f"POD CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"pod chaos smoke ok: {ctrl.rounds} rounds, "
          f"{len(ctrl_ids)} SVs, worker SIGKILL revived "
          f"({r1.revives} revive) and coordinator kill resumed — both "
          "bit-identical to the uninterrupted control, zero rows lost "
          f"(device {device}; the traced arm waits for ROADMAP Queue 1 "
          "item 12)")
    return 0


def _validate(path: str) -> int:
    from tpusvm_torch import faults

    plan = faults.load_plan(path)
    print(f"fault plan ok: {path} (seed {plan.seed}, "
          f"{len(plan.rules)} rules)")
    for r in plan.rules:
        if r.at_hit is not None:
            extra = f" at_hit={r.at_hit}"
        elif r.max_hits is not None:
            extra = f" p={r.p:g} max_hits={r.max_hits}"
        else:
            extra = f" p={r.p:g}"
        if r.kind == "latency":
            extra += f" delay_ms={r.delay_ms:g}"
        print(f"  {r.point}: {r.kind}{extra}")
    return 0


def _swap_chaos_smoke(device: str) -> int:
    import os
    import threading

    import numpy as np

    from tpusvm_torch import faults
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ModelLoadError, ServeConfig, Server

    failures = []
    Xa, Ya = rings(n=240, seed=2)
    Xb, Yb = rings(n=240, seed=9)
    A = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=device).fit(Xa, Ya)
    B = BinarySVC(SVMConfig(C=10.0, gamma=5.0), device=device).fit(Xb, Yb)
    Xq, _ = rings(n=32, seed=3)

    with tempfile.TemporaryDirectory() as td, \
            Server(ServeConfig(max_batch=8), device=device) as srv:
        pa = os.path.join(td, "a.npz")
        pb = os.path.join(td, "b.npz")
        A.save(pa)
        B.save(pb)
        srv.load_model("m", pa)
        srv.warmup()
        refA, _ = srv.predict_direct("m", Xq)
        srv.swap("m", pb)
        refB, _ = srv.predict_direct("m", Xq)
        srv.swap("m", pa)
        if np.array_equal(refA, refB):
            print("SWAP CHAOS SMOKE FAILED: the two models are not "
                  "distinguishable — the torn-read check is vacuous")
            return 1

        # the chaos plan: kill one stage mid-swap, corrupt one staged
        # artifact's bytes, latency on the others — all seeded
        plan = faults.FaultPlan([
            faults.FaultRule(point="serve.swap", kind="kill", at_hit=2),
            faults.FaultRule(point="registry.load", kind="corrupt",
                             at_hit=4),
            faults.FaultRule(point="serve.swap", kind="latency",
                             p=0.5, delay_ms=5.0),
        ], seed=20260805)

        stop = threading.Event()
        bad = []
        bad_lock = threading.Lock()
        served = [0]

        def client(t):
            i = t
            while not stop.is_set():
                r = srv.submit("m", Xq[i % 32], timeout_s=10.0)
                if not r.ok:
                    with bad_lock:
                        bad.append(("status", r.status))
                else:
                    s = np.asarray(r.scores)
                    if s != refA[i % 32] and s != refB[i % 32]:
                        with bad_lock:
                            bad.append(("torn", i % 32, float(s)))
                    with bad_lock:
                        served[0] += 1
                i += 1

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        killed = corrupted = ok_swaps = 0
        with faults.active(plan):
            for t in threads:
                t.start()
            for k in range(8):
                target = pb if k % 2 == 0 else pa
                try:
                    srv.swap("m", target)
                    ok_swaps += 1
                except faults.SimulatedKill:
                    killed += 1  # mid-stage death: nothing flipped
                except ModelLoadError:
                    corrupted += 1
                    h = srv.health()
                    if h["status"] != "degraded":
                        failures.append(
                            "healthz not degraded after a corrupt staged "
                            f"artifact (got {h['status']})")
                # the old generation must still answer, bitwise
                s, _ = srv.predict_direct("m", Xq)
                if not (np.array_equal(s, refA)
                        or np.array_equal(s, refB)):
                    failures.append(
                        f"scores after swap attempt {k} match neither "
                        "generation")
            stop.set()
            for t in threads:
                t.join(30.0)
        if any(t.is_alive() for t in threads):
            failures.append("a client thread did not finish")
        if bad:
            failures.append(f"client anomalies under chaos: {bad[:5]} "
                            f"({len(bad)} total)")
        if served[0] == 0:
            failures.append("no request was served under chaos")
        if killed == 0:
            failures.append("the kill rule never fired")
        if corrupted == 0:
            failures.append("the corrupt rule never produced a classified "
                            "load failure")
        # recovery: a clean swap clears the degraded flag
        faults.deactivate()
        srv.swap("m", pb)
        h = srv.health()
        if h["status"] != "ok":
            failures.append(f"clean swap did not recover health: {h}")
        gen = h["swap"]["m"]["generation"]
    if failures:
        for f in failures:
            print(f"SWAP CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"swap chaos smoke ok: {ok_swaps} swaps flipped, {killed} killed "
          f"mid-stage, {corrupted} corrupt stages rolled back, {served[0]} "
          f"responses, 0 torn/lost, final generation {gen}, health ok")
    return 0

def _device(prog: str, rest) -> str:
    ap = argparse.ArgumentParser(prog=f"python -m tpusvm_torch.faults {prog}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the solves and the server run (default: the card)")
    return ap.parse_args(rest).device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "kill-resume-smoke":
        return _kill_resume_smoke(_device(cmd, rest))
    if cmd == "pod-chaos-smoke":
        return _pod_chaos_smoke(_device(cmd, rest))
    if cmd == "swap-chaos-smoke":
        return _swap_chaos_smoke(_device(cmd, rest))
    if cmd == "validate":
        if len(rest) != 1:
            print("usage: python -m tpusvm_torch.faults validate PLAN.json")
            return 2
        return _validate(rest[0])
    if cmd in NOT_PORTED:
        tier, item = NOT_PORTED[cmd]
        print(f"{cmd}: its tier, {tier}, is not ported yet (ROADMAP Queue 1 "
              f"item {item})")
        return 2
    print(f"unknown command {cmd!r}; see --help")
    return 2


if __name__ == "__main__":
    sys.exit(main())
