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
                      accounted for across the workers in every arm. A
                      third arm re-runs the worker kill TRACED: the
                      coordinator's and every worker's trace file (the
                      revived worker's a fresh one) merge into one
                      timeline with no unresolved parent, bit-identical
                      to the control.

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
  autopilot-chaos-smoke
                      The closed-loop gate (tpusvm_torch.autopilot): a
                      control arm (deploy, append, one refresh swapped
                      into a live server) and a chaos arm of the same loop
                      with a fault on every stage (a kill in the append's
                      journal, in a shard write, at the refresh's entry
                      and at the solver checkpoint; a failed staged swap;
                      a corrupt artifact read; latency on scoring and
                      ticks), every killed "process" rebuilt with
                      resume=True, under client load. Asserts: the chaos
                      dataset's manifest and rows equal the control's,
                      the refreshed model is bit-identical to the
                      control's, no response is torn or lost, the failed
                      swap rolled back to a degraded old generation and
                      health recovered.
  tenant-chaos-smoke  The multi-tenant gate (tpusvm_torch.tenants): 64
                      tenants provisioned in one cold fleet launch over
                      one corpus, a control arm's coalesced refresh, and a
                      chaos arm killed at its second fleet-checkpoint
                      write under client load, then rebuilt with
                      resume=True; then one corrupt staged artifact.
                      Asserts: every recovered refit is bit-identical to
                      the control's, no torn response, fleet checkpoints
                      reaped after the swapping-stage commit, every view
                      fingerprint equal, the corrupt swap pinned exactly
                      one tenant (PARTIAL) which the next tick refreshed.
  router-chaos-smoke  The routing-tier gate (tpusvm_torch.router): three
                      REAL `python -m tpusvm_torch serve` replica
                      processes on ephemeral ports (found through their
                      serve_state.json) behind an in-process router and
                      its HTTP front, four client threads through it, and
                      a router.forward fault plan (two transients, latency
                      on a fifth of the forwards). Replicas 0 and 1 are
                      SIGKILLed in turn under load and revived on their
                      recorded ports from --state, then a staggered
                      rollout swaps the fleet to a second model. Asserts:
                      zero lost or torn responses (every score one
                      generation's offline decision_function bits), each
                      revived replica back on its address with its
                      replica id, a skew-free rollout to a uniform
                      generation vector, placement bytes that reproduce
                      for one seed, the fault point fired, and the router
                      healthy at the end.

Every chaos command of the JAX package is ported: `NOT_PORTED` is empty.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

#: chaos commands of tiers not ported yet -> (tier, ROADMAP Queue 1 item);
#: every one is ported
NOT_PORTED: dict = {}


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

        # arm 3: the worker-kill arm again, TRACED: chaos must not break
        # the distributed trace fabric. The killed worker's file ends at
        # its last request (SIGKILL leaves no torn span line), the REVIVED
        # worker opens a fresh per-pid file whose root spans re-parent
        # under the coordinator through the propagated context, and the
        # fit stays bit-identical to the control
        from tpusvm_torch.obs.report import (merge_trace_files,
                                             render_report, reparent_stats)
        from tpusvm_torch.obs.trace import Tracer

        tdir = os.path.join(td, "trace")
        os.makedirs(tdir)
        tracer = Tracer(os.path.join(tdir, "coordinator.jsonl"),
                        role="pod-coordinator", argv=["pod-chaos"])
        faults.set_event_sink(tracer.event)
        try:
            r3 = pod_fit(ds, cfg, cc, worker_faults={1: plan},
                         tracer=tracer, trace_dir=tdir, device=device)
        finally:
            faults.set_event_sink(None)
            tracer.close()
        if r3.revives < 1:
            failures.append("traced arm: the kill never fired "
                            "(zero revives)")
        check("traced arm", r3)
        tfiles = sorted(os.path.join(tdir, f) for f in os.listdir(tdir)
                        if f.endswith(".jsonl"))
        # 1 coordinator + 4 workers + >= 1 revived worker (a fresh pid, a
        # fresh file): the kill must be visible in the file census
        if len(tfiles) < 6:
            failures.append(
                f"traced arm: expected >=6 trace files (coordinator + 4 "
                f"workers + revived worker), found {len(tfiles)}")
        stats = {"files": len(tfiles), "reparented": 0}
        try:
            recs = merge_trace_files(tfiles)
            stats = reparent_stats(recs)
            if "pod-worker" not in stats["roles"]:
                failures.append("traced arm: no pod-worker spans in the "
                                "merged timeline")
            if stats["unresolved"]:
                failures.append(
                    f"traced arm: {stats['unresolved']} root span(s) "
                    "failed to re-parent (revived worker's context "
                    "broken?)")
            if not stats["reparented"]:
                failures.append("traced arm: zero spans re-parented "
                                "across processes")
            render_report(recs)  # the merged timeline must render
        except (ValueError, KeyError) as e:
            failures.append(f"traced arm: merged trace unusable: {e}")

    if failures:
        for f in failures:
            print(f"POD CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"pod chaos smoke ok: {ctrl.rounds} rounds, "
          f"{len(ctrl_ids)} SVs, worker SIGKILL revived "
          f"({r1.revives} revive) and coordinator kill resumed — both "
          "bit-identical to the uninterrupted control, zero rows lost; "
          f"traced re-run stitched {stats['files']} files "
          f"({stats['reparented']} spans re-parented, 0 unresolved) "
          f"while staying bit-identical (device {device})")
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

def _autopilot_chaos_smoke(device: str) -> int:
    import os
    import threading

    import numpy as np

    from tpusvm_torch import faults
    from tpusvm_torch.autopilot import Autopilot, AutopilotConfig, DriftThresholds
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.status import AutopilotStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset

    failures = []
    X, Y = rings(n=400, seed=11)
    BATCHES = [(s, s + 40) for s in range(240, 400, 40)]
    Xq = X[:24]

    def setup(td):
        """One complete closed loop: dataset, deployed artifact, server,
        supervisor config. Identical for control and chaos arms."""
        data = os.path.join(td, "data")
        ingest_arrays(data, X[:240], Y[:240], rows_per_shard=64)
        deployed = os.path.join(td, "deployed.npz")
        BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=device).fit(
            X[:240], Y[:240]).save(deployed)
        srv = Server(ServeConfig(max_batch=8), device=device)
        srv.load_model("m", deployed)
        srv.warmup()
        cfg = AutopilotConfig(
            data_dir=data, model_path=deployed,
            out_path=os.path.join(td, "m.refresh.npz"),
            name="m",
            thresholds=DriftThresholds(growth=0.55, feature=None,
                                       score=None, jitter_frac=0.0),
            hysteresis=1, cooldown_s=0.0,
            checkpoint_path=os.path.join(td, "refresh_ck.npz"),
            checkpoint_every=1,
            breaker_threshold=5, breaker_cooldown_s=0.05,
            seed=20260805, device=device,
        )
        return data, deployed, srv, cfg

    with tempfile.TemporaryDirectory() as td:
        # ---------------- control arm: uninterrupted closed loop
        cdir = os.path.join(td, "control")
        os.makedirs(cdir)
        data_c, deployed_c, srv_c, cfg_c = setup(cdir)
        with srv_c:
            refA, _ = srv_c.predict_direct("m", Xq)
            # the supervisor deploys BEFORE the data grows: its state
            # records the deployed model's 240-row provenance
            pilot = Autopilot(cfg_c, server=srv_c, log_fn=lambda m: None)
            w = ShardWriter.open_append(data_c)
            for a, b in BATCHES:
                w.append(X[a:b], Y[a:b])
            w.close()
            out = pilot.tick()
            if out["status"] != AutopilotStatus.REFRESHED:
                print(f"AUTOPILOT CHAOS SMOKE FAILED: control arm did "
                      f"not refresh ({out['status'].name})")
                return 1
            # the served scores of BOTH complete generations: the chaos
            # arm's torn-read oracle (its refit is gated bit-identical
            # to this control artifact, so these are the only two score
            # vectors any chaos response may bitwise-match)
            refB, _ = srv_c.predict_direct("m", Xq)
        control = BinarySVC.load(cfg_c.out_path, device=device)
        ds_c = open_dataset(data_c)
        control_manifest = ds_c.manifest.to_json()

        # ---------------- chaos arm: same loop, kills at every stage
        hdir = os.path.join(td, "chaos")
        os.makedirs(hdir)
        data_h, deployed_h, srv_h, cfg_h = setup(hdir)
        # one fault on every stage of the closed loop: the append's
        # journal commit, the raw shard write, the refresh entry, the
        # solver checkpoint (kill at its FIRST write — the warm fit
        # converges within a couple of segments), a staged-swap failure
        # (transient — deterministic rollback; corrupt staged BYTES are
        # swap-chaos-smoke's dedicated gate), a corrupt artifact read on
        # the retry, and latency on scoring and ticks
        plan = faults.FaultPlan([
            faults.FaultRule(point="stream.append", kind="kill",
                             at_hit=2),
            faults.FaultRule(point="ingest.write_shard", kind="kill",
                             at_hit=3),
            faults.FaultRule(point="autopilot.refresh", kind="kill",
                             at_hit=1),
            faults.FaultRule(point="solver.outer_checkpoint",
                             kind="kill", at_hit=1),
            faults.FaultRule(point="serve.swap", kind="transient",
                             at_hit=1),
            faults.FaultRule(point="registry.load", kind="corrupt",
                             at_hit=2),
            faults.FaultRule(point="serve.score", kind="latency",
                             p=0.3, delay_ms=2.0, max_hits=16),
            faults.FaultRule(point="autopilot.tick", kind="latency",
                             p=0.5, delay_ms=1.0, max_hits=8),
        ], seed=20260805)

        with srv_h:
            refA_h, _ = srv_h.predict_direct("m", Xq)
            if not np.array_equal(refA_h, refA):
                failures.append("chaos deployed generation does not "
                                "serve the control's scores — arms are "
                                "not comparable")
            if np.array_equal(refA, refB):
                failures.append("deployed and refreshed models are "
                                "indistinguishable — the torn-"
                                "generation check is vacuous")
            stop = threading.Event()
            bad = []
            bad_lock = threading.Lock()

            def client(t):
                i = t
                while not stop.is_set():
                    r = srv_h.submit("m", Xq[i % 24], timeout_s=10.0)
                    if r.ok:
                        s = np.asarray(r.scores)
                        if s != refA[i % 24] and s != refB[i % 24]:
                            with bad_lock:
                                bad.append(("torn", i % 24, float(s)))
                    elif r.status.name not in ("TIMEOUT",):
                        with bad_lock:
                            bad.append(("status", r.status.name))
                    i += 1

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(4)]
            kills = 0
            degraded_seen = False
            # deploy the supervisor before the data grows (and before
            # the chaos starts): its crash-safe state file is what every
            # restarted incarnation resumes from
            pilot = Autopilot(cfg_h, server=srv_h, log_fn=lambda m: None)
            with faults.active(plan):
                for t in threads:
                    t.start()
                # appends with restart-on-kill (the killed "process" is
                # rebuilt with resume=True and replays its batch stream)
                for attempt in range(12):
                    try:
                        w = ShardWriter.open_append(
                            data_h, resume=attempt > 0)
                        for a, b in BATCHES:
                            w.append(X[a:b], Y[a:b])
                        w.close()
                        break
                    except faults.SimulatedKill:
                        kills += 1
                else:
                    failures.append("append never completed within the "
                                    "restart budget")
                # supervise with restart-on-kill until the refresh lands
                statuses = []
                for attempt in range(24):
                    try:
                        out = pilot.tick()
                    except faults.SimulatedKill:
                        kills += 1
                        pilot = Autopilot(cfg_h, server=srv_h,
                                          resume=True,
                                          log_fn=lambda m: None)
                        continue
                    statuses.append(out["status"])
                    if out["status"] == AutopilotStatus.REFRESH_FAILED \
                            and srv_h.health()["status"] == "degraded":
                        degraded_seen = True
                    if out["status"] == AutopilotStatus.REFRESHED:
                        s, _ = srv_h.predict_direct("m", Xq)
                        if not np.array_equal(s, refB):
                            failures.append(
                                "post-swap served scores do not "
                                "bitwise-match the control "
                                "generation")
                        break
                else:
                    failures.append(
                        "no refresh landed within the tick budget: "
                        f"{[s.name for s in statuses]}")
                stop.set()
                for t in threads:
                    t.join(10.0)
            faults.deactivate()

            # ---------------- the gates
            if kills == 0:
                failures.append("no kill rule ever fired — the chaos "
                                "arm degenerated to the control arm")
            if not degraded_seen:
                failures.append(
                    "the failed staged swap never rolled back to a "
                    "degraded-health old generation "
                    f"(serve.swap hits {plan.hits('serve.swap')}, "
                    f"registry.load hits {plan.hits('registry.load')})")
            if bad:
                failures.append(f"client anomalies under chaos: "
                                f"{bad[:5]} ({len(bad)} total)")
            if srv_h.health()["status"] != "ok":
                failures.append(
                    f"health did not recover: {srv_h.health()}")

        # journal audit: zero rows lost or duplicated
        ds_h = open_dataset(data_h)
        if ds_h.manifest.to_json() != control_manifest:
            failures.append("chaos dataset manifest differs from the "
                            "uninterrupted control (rows lost, "
                            "duplicated, or mis-sharded)")
        if os.path.exists(os.path.join(data_h, "ingest.journal.json")):
            failures.append("append journal survived the commit")
        Xc, Yc = ds_c.load_arrays()
        Xh, Yh = ds_h.load_arrays()
        if not (np.array_equal(Xc, Xh) and np.array_equal(Yc, Yh)):
            failures.append("chaos dataset rows differ from control")

        # the refit is bit-identical to the uninterrupted control
        if os.path.exists(cfg_h.out_path):
            chaos = BinarySVC.load(cfg_h.out_path, device=device)
            if chaos.sv_alpha_.tobytes() != control.sv_alpha_.tobytes() \
                    or not np.array_equal(chaos.sv_ids_,
                                          control.sv_ids_) \
                    or chaos.b_ != control.b_:
                failures.append(
                    "post-recovery refreshed model is NOT bit-identical "
                    f"to the control run ({len(chaos.sv_ids_)} vs "
                    f"{len(control.sv_ids_)} SVs, b {chaos.b_!r} vs "
                    f"{control.b_!r})")
        else:
            failures.append("chaos arm never produced a refreshed "
                            "artifact")

    if failures:
        for f in failures:
            print(f"AUTOPILOT CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"autopilot chaos smoke ok: {kills} kills absorbed "
          "(append journal / shard write / refresh entry / solver "
          "checkpoint), failed staged swap rolled back degraded then "
          "recovered, 0 torn/lost responses, dataset journal-audited "
          "equal, refreshed model bit-identical to the uninterrupted "
          "control")
    return 0


def _tenant_chaos_smoke(device: str) -> int:
    import glob
    import os
    import threading

    import numpy as np

    from tpusvm_torch import faults
    from tpusvm_torch.autopilot import DriftThresholds
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.status import TenantsStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset
    from tpusvm_torch.tenants import (
        TenantRecord,
        TenantsConfig,
        TenantsSupervisor,
        provision_tenants,
        tenant_labels,
        view_fingerprint,
    )

    failures = []
    N_T = 64
    D, K = 6, 8
    N0, N1, N2 = 320, 160, 160
    rng = np.random.default_rng(20260806)
    labels_all = rng.integers(0, K, size=N0 + N1 + N2).astype(np.int32)
    means = rng.normal(0.0, 2.0, size=(K, D))
    # f64 host rows: the serve tier validates/scales queries in f64
    # (registry.validate_rows), so the bitwise served-vs-offline oracle
    # contract is stated for f64 inputs — exactly what clients POST
    X_all = means[labels_all] + rng.normal(0.0, 1.0,
                                           size=(N0 + N1 + N2, D))
    # the appended batches are distribution-shifted so every tenant's
    # refreshed solution genuinely differs from its donor (the
    # torn-generation oracle needs two DISTINGUISHABLE generations)
    X_all[N0:] += 0.75
    Xq = X_all[:8]
    C_PAL, G_PAL = (1.0, 3.0, 10.0), (0.5, 1.5, 5.0)
    # the supervisor's knobs, and the cold provision's too: the plain
    # subproblem on the CPU is a loop a lane, so an uncapped q (the whole
    # corpus) would spend minutes there
    SOLVER_OPTS = {"q": 32, "max_inner": 8}

    def mk_records():
        recs = []
        for i in range(N_T):
            recs.append(TenantRecord(
                tenant_id=f"t{i:02d}", positive_label=i % K,
                C=C_PAL[i % 3], gamma=G_PAL[(i // 3) % 3],
                row_mod=2 if i % 8 == 7 else None,
                row_ofs=(i // 8) % 2 if i % 8 == 7 else 0))
        return recs

    def setup(td):
        """One complete platform: shared dataset, 64 provisioned donors
        (ONE cold fleet launch), supervisor config. Identical for
        control and chaos arms."""
        data = os.path.join(td, "data")
        donors = os.path.join(td, "donors")
        arts = os.path.join(td, "artifacts")
        os.makedirs(donors)
        ingest_arrays(data, X_all[:N0], labels_all[:N0],
                      rows_per_shard=64)
        recs = mk_records()
        provision_tenants(X_all[:N0], labels_all[:N0], recs,
                          artifacts_dir=donors, solver_opts=SOLVER_OPTS,
                          device=device)
        cfg = TenantsConfig(
            data_dir=data,
            store_path=os.path.join(td, "tenants_store.json"),
            artifacts_dir=arts,
            thresholds=DriftThresholds(growth=0.25, feature=None,
                                       score=None, jitter_frac=0.0),
            hysteresis=1, cooldown_s=0.0,
            checkpoint_every=2, min_fleet=2,
            breaker_threshold=5, breaker_cooldown_s=0.05,
            seed=20260806,
            solver_opts=SOLVER_OPTS, device=device,
        )
        return data, recs, cfg

    def append(data, a, b):
        w = ShardWriter.open_append(data)
        w.append(X_all[a:b], labels_all[a:b])
        w.close()

    with tempfile.TemporaryDirectory() as td:
        # ---------------- control arm: uninterrupted platform
        cdir = os.path.join(td, "control")
        os.makedirs(cdir)
        data_c, recs_c, cfg_c = setup(cdir)
        sup = TenantsSupervisor(cfg_c, log_fn=lambda m: None)
        for rec in recs_c:
            sup.register(rec)
        out = sup.tick()
        if out["status"] != TenantsStatus.WATCHING:
            print("TENANT CHAOS SMOKE FAILED: control arm drifted "
                  "before any append")
            return 1
        append(data_c, N0, N0 + N1)
        out = sup.tick()
        if out["status"] != TenantsStatus.REFRESHED:
            print(f"TENANT CHAOS SMOKE FAILED: control arm did not "
                  f"refresh ({out['status'].name})")
            return 1
        append(data_c, N0 + N1, N0 + N1 + N2)
        tids = sorted(st.tenant_id for st in recs_c)
        # both complete generations of every tenant, as OFFLINE oracles
        # (serving is bitwise-equal to offline f32 decision_function —
        # the serve-tier contract): the chaos arm's torn-read reference
        refOld, refNew, control_art = {}, {}, {}
        for tid in tids:
            refOld[tid] = np.asarray(BinarySVC.load(
                os.path.join(cdir, "donors", tid + ".npz"),
                device=device).decision_function(Xq))
            m = BinarySVC.load(os.path.join(cdir, "artifacts",
                                            tid + ".npz"), device=device)
            refNew[tid] = np.asarray(m.decision_function(Xq))
            control_art[tid] = m
        distinct = sum(not np.array_equal(refOld[t], refNew[t])
                       for t in tids)
        if distinct < N_T // 2:
            failures.append(
                f"only {distinct}/{N_T} tenants changed across the "
                "refresh — the torn-generation check is vacuous")
        ds_c = open_dataset(data_c)
        control_manifest = ds_c.manifest.to_json()
        Xc, Yc = ds_c.load_arrays()

        # ---------------- chaos arm: same platform, killed mid-fleet
        hdir = os.path.join(td, "chaos")
        os.makedirs(hdir)
        data_h, recs_h, cfg_h = setup(hdir)
        srv = Server(ServeConfig(max_batch=8), device=device)
        for rec in recs_h:
            srv.load_model(rec.tenant_id, rec.model_path)
        with srv:
            sup_h = TenantsSupervisor(cfg_h, server=srv,
                                      log_fn=lambda m: None)
            for rec in recs_h:
                sup_h.register(rec)
            out = sup_h.tick()
            if out["status"] != TenantsStatus.WATCHING:
                failures.append("chaos arm drifted before any append")
            for tid in tids:
                s, _ = srv.predict_direct(tid, Xq)
                if not np.array_equal(np.asarray(s), refOld[tid]):
                    failures.append(
                        f"chaos donor generation of {tid} does not "
                        "serve the control's scores — arms are not "
                        "comparable")
                    break
            append(data_h, N0, N0 + N1)

            # the kill plan counts tenants.store hits WITHIN the
            # refresh tick (activated only now, so registration writes
            # don't shift the count): hit 1 is the stage="fitting"
            # store commit, hits 2.. are the fleet segment checkpoints
            # — at_hit=3 dies at the SECOND checkpoint write, i.e. with
            # a durable first-segment checkpoint on disk
            plan = faults.FaultPlan([
                faults.FaultRule(point="tenants.store", kind="kill",
                                 at_hit=3),
                faults.FaultRule(point="tenants.tick", kind="latency",
                                 p=0.5, delay_ms=1.0, max_hits=8),
                faults.FaultRule(point="serve.score", kind="latency",
                                 p=0.3, delay_ms=2.0, max_hits=16),
            ], seed=20260806)
            stop = threading.Event()
            bad = []
            bad_lock = threading.Lock()

            def client(t):
                i = t
                while not stop.is_set():
                    tid = tids[(7 * t + i) % N_T]
                    r = srv.submit(tid, Xq[i % 8], timeout_s=10.0)
                    if r.ok:
                        s = np.asarray(r.scores)
                        if s != refOld[tid][i % 8] \
                                and s != refNew[tid][i % 8]:
                            with bad_lock:
                                bad.append(("torn", tid, i % 8,
                                            float(s)))
                    elif r.status.name not in ("TIMEOUT",):
                        with bad_lock:
                            bad.append(("status", r.status.name))
                    i += 1
                    # paced: 64 models' requests would otherwise take the
                    # host from the supervisor under test
                    stop.wait(0.005)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(3)]
            kills = 0
            ck_at_kill = False
            with faults.active(plan):
                for t in threads:
                    t.start()
                statuses = []
                for attempt in range(16):
                    try:
                        out = sup_h.tick()
                    except faults.SimulatedKill:
                        kills += 1
                        # the evidence that recovery RESUMES rather
                        # than restarts: a durable fleet checkpoint
                        # exists at the moment of death
                        if glob.glob(os.path.join(
                                hdir, "artifacts", "fleet_*.ck.npz")):
                            ck_at_kill = True
                        sup_h = TenantsSupervisor(
                            cfg_h, server=srv, resume=True,
                            log_fn=lambda m: None)
                        continue
                    statuses.append(out["status"])
                    if out["status"] == TenantsStatus.REFRESHED:
                        break
                else:
                    failures.append(
                        "no coalesced refresh landed within the tick "
                        f"budget: {[s.name for s in statuses]}")
                stop.set()
                for t in threads:
                    t.join(10.0)
            faults.deactivate()

            # ---------------- phase-1 gates
            if kills == 0:
                failures.append("the kill rule never fired — the chaos "
                                "arm degenerated to the control arm")
            if kills and not ck_at_kill:
                failures.append(
                    "killed mid-fleet-refresh with NO durable segment "
                    "checkpoint on disk — recovery would re-fit from "
                    "scratch")
            if bad:
                failures.append(f"client anomalies under chaos: "
                                f"{bad[:5]} ({len(bad)} total)")
            if glob.glob(os.path.join(hdir, "artifacts",
                                      "fleet_*.ck.npz")):
                failures.append("fleet checkpoints survived the "
                                "swapping-stage commit")
            for tid in tids:
                rec = sup_h.state.tenants[tid]
                if rec.generation != 1:
                    failures.append(
                        f"{tid} generation {rec.generation} != 1 after "
                        "the recovered refresh")
                    continue
                s, _ = srv.predict_direct(tid, Xq)
                s = np.asarray(s)
                if not np.array_equal(s, refNew[tid]):
                    still_old = np.array_equal(s, refOld[tid])
                    failures.append(
                        f"post-recovery served scores of {tid} do not "
                        "bitwise-match the control generation "
                        f"(max |delta| "
                        f"{float(np.max(np.abs(s - refNew[tid])))!r}, "
                        f"still the donor generation: {still_old})")
                chaos = BinarySVC.load(os.path.join(
                    hdir, "artifacts", tid + ".npz"), device=device)
                ctrl = control_art[tid]
                if chaos.sv_alpha_.tobytes() != ctrl.sv_alpha_.tobytes() \
                        or not np.array_equal(chaos.sv_ids_,
                                              ctrl.sv_ids_) \
                        or chaos.b_ != ctrl.b_ \
                        or chaos.n_iter_ != ctrl.n_iter_:
                    failures.append(
                        f"recovered refit of {tid} is NOT bit-identical "
                        f"to the uninterrupted control "
                        f"({len(chaos.sv_ids_)} vs {len(ctrl.sv_ids_)} "
                        f"SVs, b {chaos.b_!r} vs {ctrl.b_!r}, n_iter "
                        f"{chaos.n_iter_} vs {ctrl.n_iter_})")

            # ---------------- phase 2: corrupt one swap's bytes
            append(data_h, N0 + N1, N0 + N1 + N2)
            plan2 = faults.FaultPlan([
                faults.FaultRule(point="registry.load", kind="corrupt",
                                 at_hit=1),
            ], seed=20260806)
            with faults.active(plan2):
                out = sup_h.tick()
            faults.deactivate()
            if out["status"] != TenantsStatus.PARTIAL:
                failures.append(
                    "the corrupted swap did not surface as a PARTIAL "
                    f"generation (got {out['status'].name})")
            stuck = [tid for tid in tids
                     if sup_h.state.tenants[tid].generation == 1]
            if len(stuck) != 1:
                failures.append(
                    f"expected exactly one tenant pinned on its "
                    f"previous generation, got {stuck}")
            else:
                s, _ = srv.predict_direct(stuck[0], Xq)
                if not np.array_equal(np.asarray(s), refNew[stuck[0]]):
                    failures.append(
                        f"{stuck[0]}'s failed swap did not keep its "
                        "previous generation serving bitwise")
                out = sup_h.tick()
                if out["status"] != TenantsStatus.REFRESHED \
                        or out["drifted"] != stuck:
                    failures.append(
                        "the corrupted tenant did not stay armed and "
                        f"recover solo (status {out['status'].name}, "
                        f"drifted {out['drifted']})")
                else:
                    want = np.asarray(BinarySVC.load(
                        os.path.join(hdir, "artifacts",
                                     stuck[0] + ".npz"),
                        device=device).decision_function(Xq))
                    s, _ = srv.predict_direct(stuck[0], Xq)
                    if not np.array_equal(np.asarray(s), want):
                        failures.append(
                            f"{stuck[0]}'s recovery swap does not "
                            "serve its refreshed artifact bitwise")

        # ---------------- gate (a): no tenant lost rows
        ds_h = open_dataset(data_h)
        if ds_h.manifest.to_json() != control_manifest:
            failures.append("chaos dataset manifest differs from the "
                            "uninterrupted control (rows lost, "
                            "duplicated, or mis-sharded)")
        Xh, Yh = ds_h.load_arrays()
        if not (np.array_equal(Xc, Xh) and np.array_equal(Yc, Yh)):
            failures.append("chaos dataset rows differ from control")
        else:
            for rc, rh in zip(recs_c, recs_h):
                if view_fingerprint(*tenant_labels(Yc, rc)) != \
                        view_fingerprint(*tenant_labels(Yh, rh)):
                    failures.append(
                        f"tenant {rc.tenant_id} view fingerprint "
                        "differs between arms")
                    break

    if failures:
        for f in failures:
            print(f"TENANT CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"tenant chaos smoke ok: {N_T} tenants, supervisor killed "
          f"mid-fleet-refresh ({kills} kills) resumed from a durable "
          "segment checkpoint to artifacts bit-identical to the "
          "uninterrupted control, 0 torn responses, every view "
          "fingerprint equal, corrupted swap pinned one tenant on its "
          "previous generation then recovered solo")
    return 0

def _router_chaos_smoke(device: str) -> int:
    import json
    import os
    import subprocess
    import threading
    import time
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    import tpusvm_torch
    from tpusvm_torch import faults
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import rings
    from tpusvm_torch.models import BinarySVC, load_any
    from tpusvm_torch.obs.registry import MetricsRegistry
    from tpusvm_torch.router import (Router, RouterConfig, make_router_http,
                                     placement_table, table_bytes)
    from tpusvm_torch.serve.http import revivable_ports, start_http_thread
    from tpusvm_torch.status import RouterStatus

    N_REPLICAS = 3
    N_CLIENTS = 4
    failures = []

    Xa, Ya = rings(n=240, seed=2)
    Xb, Yb = rings(n=240, seed=9)
    A = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=device).fit(Xa, Ya)
    Bm = BinarySVC(SVMConfig(C=10.0, gamma=5.0), device=device).fit(Xb, Yb)
    Xq, _ = rings(n=16, seed=3)
    rows = [np.asarray(Xq[i], float).tolist() for i in range(len(Xq))]

    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(tpusvm_torch.__file__))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        # the replicas reduce with this process's intra-op thread count,
        # so their scores are the oracle's bits
        env["OMP_NUM_THREADS"] = str(torch.get_num_threads())

    with tempfile.TemporaryDirectory() as td:
        pa = os.path.join(td, "v1.npz")
        pb = os.path.join(td, "v2.npz")
        A.save(pa)
        Bm.save(pb)
        # the bitwise oracles: each artifact's offline decision_function,
        # which every served score equals
        refA, refB = ([float(v) for v in np.asarray(
            load_any(p, device=device).decision_function(Xq))]
            for p in (pa, pb))
        if refA == refB:
            print("ROUTER CHAOS SMOKE FAILED: the two generations are not "
                  "distinguishable — the bitwise oracle is vacuous")
            return 1

        def state_path(i):
            return os.path.join(td, f"rep{i}", "serve_state.json")

        logs = []

        def spawn(i, port, first=True):
            """One REAL replica process on `port` (below the ephemeral
            range: serve/http.py revivable_ports; read back from its state
            file); a revive passes the recorded port back and restores the
            model set and the replica identity from --state."""
            os.makedirs(os.path.dirname(state_path(i)), exist_ok=True)
            log = open(os.path.join(td, f"rep{i}.log"), "ab")
            logs.append(log)
            cmd = [sys.executable, "-m", "tpusvm_torch", "serve",
                   "--host", "127.0.0.1", "--port", str(port),
                   "--state", state_path(i), "--max-batch", "8",
                   "--device", device]
            if first:
                cmd += ["--model", f"m={pa}"]
            return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env)

        def wait_ready(i, deadline_s=180.0):
            """The replica's bound address from its state file, then
            /healthz ok: (url, replica_id)."""
            t0 = time.monotonic()
            while time.monotonic() - t0 < deadline_s:
                if procs[i].poll() is not None:
                    break
                try:
                    with open(state_path(i)) as f:
                        st = json.load(f)
                    addr = st.get("address")
                    if addr and st.get("models"):
                        url = f"http://{addr}"
                        with urllib.request.urlopen(
                                url + "/healthz", timeout=2.0) as r:
                            payload = json.loads(r.read())
                        if payload.get("status") == "ok":
                            return url, st.get("replica_id")
                except (OSError, ValueError):
                    pass
                time.sleep(0.2)
            with open(os.path.join(td, f"rep{i}.log"), "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(f"replica {i} not serving within "
                               f"{deadline_s:g}s:\n{tail}")

        procs = [spawn(i, port) for i, port in
                 enumerate(revivable_ports(N_REPLICAS))]
        router = None
        stop = threading.Event()
        counts = [0] * N_CLIENTS
        kills = revives = 0
        plan = None
        try:
            ready = [wait_ready(i) for i in range(N_REPLICAS)]
            urls = [u for u, _ in ready]
            ids0 = dict(ready)

            # placement byte-reproducibility: two independent
            # constructions of the same (keys, replicas, k, seed)
            keys = ["m", "m-shadow", "m-canary"]
            if table_bytes(placement_table(keys, urls, k=2, seed=7)) \
                    != table_bytes(placement_table(list(keys), tuple(urls),
                                                   k=2, seed=7)):
                failures.append("placement tables for one seed are not "
                                "byte-identical")

            router = Router(RouterConfig(
                replicas=tuple(urls), replication=2, seed=7,
                poll_interval_s=0.2, down_after=2, forward_timeout_s=30.0),
                registry=MetricsRegistry(), log_fn=None)
            router.start()
            httpd = make_router_http(router, port=0)
            router.attach_http(httpd, start_http_thread(httpd))
            rhost, rport = httpd.server_address[:2]
            router_url = f"http://{rhost}:{rport}"

            # chaos INSIDE the fabric: two deterministic transient forwards
            # (each consumes one failover) and forward latency
            plan = faults.FaultPlan([
                faults.FaultRule(point="router.forward", kind="transient",
                                 at_hit=5),
                faults.FaultRule(point="router.forward", kind="transient",
                                 at_hit=23),
                faults.FaultRule(point="router.forward", kind="latency",
                                 p=0.2, delay_ms=1.0, max_hits=16),
            ], seed=20260806)

            bad = []
            bad_lock = threading.Lock()

            def client(t):
                i = t
                while not stop.is_set():
                    idx = i % len(rows)
                    body = json.dumps({"instances": [rows[idx]]}).encode()
                    req = urllib.request.Request(
                        router_url + "/v1/models/m:predict", data=body,
                        headers={"Content-Type": "application/json"},
                        method="POST")
                    try:
                        with urllib.request.urlopen(req, timeout=60.0) as r:
                            code, raw = r.status, r.read()
                    except urllib.error.HTTPError as e:
                        code, raw = e.code, e.read()
                    except Exception as e:  # noqa: BLE001 — a transport
                        # failure to the ROUTER itself is a lost response
                        with bad_lock:
                            bad.append(("transport",
                                        f"{type(e).__name__}: {e}"))
                        i += 1
                        continue
                    if code == 429:
                        time.sleep(0.1)  # backpressure: the same row again
                        continue
                    if code != 200:
                        with bad_lock:
                            bad.append(("code", code, raw[:160]))
                    else:
                        s = json.loads(raw)["scores"][0]
                        if isinstance(s, list):
                            s = s[0]
                        if s != refA[idx] and s != refB[idx]:
                            with bad_lock:
                                bad.append(("torn", idx, s))
                        counts[t] += 1
                    i += 1

            threads = [threading.Thread(target=client, args=(t,), daemon=True)
                       for t in range(N_CLIENTS)]
            with faults.active(plan):
                for t in threads:
                    t.start()
                time.sleep(1.0)
                # kill and revive two replicas, one at a time, under load
                for i in (0, 1):
                    procs[i].kill()  # a real SIGKILL: nothing flushed
                    procs[i].wait()
                    kills += 1
                    time.sleep(1.0)  # clients keep scoring via failover
                    with open(state_path(i)) as f:
                        st = json.load(f)
                    port = int(st["address"].rsplit(":", 1)[1])
                    procs[i] = spawn(i, port, first=False)
                    url, rid = wait_ready(i)
                    revives += 1
                    if url != urls[i]:
                        failures.append(f"replica {i} revived on {url}, not "
                                        f"its recorded address {urls[i]}")
                    if rid != ids0[urls[i]]:
                        failures.append(
                            f"replica {i} lost its identity across the "
                            f"revive ({ids0[urls[i]]} -> {rid})")
                # the poller re-admits the revived replicas
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and any(
                        s != "ok" for s in router.poller.states().values()):
                    time.sleep(0.1)
                # staggered rollout v1 -> v2 across the fleet, under load
                out = router.rollout("m", pb)
                if out["status"] != RouterStatus.OK.name:
                    failures.append(f"rollout did not complete: {out}")
                if out["failed"]:
                    failures.append(f"rollout swaps failed: {out['failed']}")
                if len(out["swapped"]) != N_REPLICAS:
                    failures.append(
                        f"rollout reached {len(out['swapped'])}/{N_REPLICAS} "
                        f"replicas (skipped {out['skipped']})")
                rep = out["report"]
                gens = set(rep["vector"].values())
                if rep["skew"] != 0 or rep["unknown"] or len(gens) != 1 \
                        or None in gens:
                    failures.append("final generation vector is not "
                                    f"uniform/skew-free: {rep}")
                time.sleep(0.5)  # post-rollout traffic on the new generation
                stop.set()
                for t in threads:
                    t.join(90.0)
            if any(t.is_alive() for t in threads):
                failures.append("a client thread did not finish")
            if bad:
                failures.append(f"lost/torn responses under chaos: "
                                f"{bad[:5]} ({len(bad)} total)")
            if min(counts) == 0:
                failures.append(f"a client thread scored nothing: {counts}")
            if plan.hits("router.forward") == 0:
                failures.append("no router.forward fault ever fired")
            h = router.health()
            if h["router"] != RouterStatus.OK.name:
                failures.append(f"router health did not recover: {h}")
        finally:
            stop.set()
            if router is not None:
                router.close()
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()

    if failures:
        for f in failures:
            print(f"ROUTER CHAOS SMOKE FAILED: {f}")
        return 1
    print(f"router chaos smoke ok: {N_REPLICAS} replica processes, "
          f"{N_CLIENTS} client threads ({sum(counts)} responses, 0 "
          f"lost/torn), {kills} SIGKILLs absorbed with identity-preserving "
          f"revives, staggered rollout skew-free to a uniform generation "
          f"vector, placement bytes reproducible, "
          f"{plan.hits('router.forward')} router.forward fault-point hits")
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
    if cmd == "autopilot-chaos-smoke":
        return _autopilot_chaos_smoke(_device(cmd, rest))
    if cmd == "tenant-chaos-smoke":
        return _tenant_chaos_smoke(_device(cmd, rest))
    if cmd == "router-chaos-smoke":
        return _router_chaos_smoke(_device(cmd, rest))
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
