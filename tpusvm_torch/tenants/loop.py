"""The multi-tenant supervisor: many closed loops, one tick.

The port of tpusvm/tenants/loop.py. The autopilot (autopilot/loop.py)
closes the loop for one model; this supervisor closes it for a fleet of
tenants over one shared corpus and pays once what one daemon a model
would pay N times: the dataset is opened once a tick, drift is evaluated
per tenant off the SAME manifest snapshot, and the drifted set is
refreshed through the coalescer (tenants/coalesce.py): power-of-two fleet
launches on the card with per-tenant warm seeds instead of N solo refits.

Per-tenant loop semantics survive the coalescing:

  * each tenant keeps its own drift state (rows_at_refresh, hysteresis
    counter, cooldown window) in its TenantRecord, and its detectors run
    with a per-tenant seed offset (crc32 of the tenant id), so jittered
    thresholds spread across the fleet instead of herding every tenant
    into one tick;
  * the per-tenant score-shift detector is off (a record carries no score
    baseline); growth, feature range and staleness drive the decision;
  * one refresh CircuitBreaker guards the whole refresh stage: a poisoned
    corpus fails every lane at once, and the breaker degrades the fleet
    to watch-only instead of hot-looping refits.

Crash safety: the store (tenants/store.py) persists the stage machine and
the exact in-flight plan (lane order, solo set, row count) BEFORE the
launch starts. A supervisor killed mid-refresh resumes with
stage="fitting", replays the persisted plan over the persisted row prefix
(later appends cannot change what the refit reads), and the fleet
checkpoint makes the resumed solve bit-identical. The checkpoints are
deleted only after the swapping-stage commit. Swaps roll out staggered
(`stagger_s`) through the server's registry, so a generation flip of
many tenants is a ramp; a tenant whose artifact failed keeps serving its
previous generation and stays drift-armed.

Fault points: ``tenants.tick`` (every tick's entry), ``tenants.store``
(every durable commit, the fleet checkpoints included). Its gate:
`python -m tpusvm_torch.faults tenant-chaos-smoke`.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

from tpusvm_torch import faults
from tpusvm_torch.autopilot.drift import DriftThresholds, evaluate
from tpusvm_torch.status import TenantsStatus
from tpusvm_torch.tenants.coalesce import CoalescePlan, refresh_drifted
from tpusvm_torch.tenants.store import (
    TenantRecord,
    TenantsState,
    load_store,
    save_store,
)


def _registry():
    from tpusvm_torch.obs.registry import default_registry

    return default_registry()


def _tenant_seed(base_seed: int, tenant_id: str) -> int:
    """Per-tenant detector seed: base + a crc32-derived offset, so
    jitter_frac de-synchronises thresholds ACROSS tenants while every
    individual tenant's decisions stay a pure replayable function of
    (its seed, its tick)."""
    return int(base_seed) + (zlib.crc32(tenant_id.encode()) & 0xFFFF)


@dataclasses.dataclass
class TenantsConfig:
    """The supervisor's knobs. `store_path` is the one durable file
    (registry + stage machine); `artifacts_dir` is where refreshed
    per-tenant models land (atomic replace, named <tenant_id>.npz —
    point a `serve --watch` directory at it for zero-coordination
    deploys)."""

    data_dir: str
    store_path: Optional[str] = None        # default: data_dir/tenants_store.json
    artifacts_dir: Optional[str] = None     # default: data_dir/tenant_models
    interval_s: float = 30.0
    thresholds: DriftThresholds = dataclasses.field(
        default_factory=DriftThresholds)
    hysteresis: int = 1
    cooldown_s: float = 0.0
    warm: bool = True
    checkpoint_every: int = 64
    min_fleet: int = 2
    stagger_s: float = 0.0                  # delay between tenant swaps
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 60.0
    seed: int = 0
    solver_opts: Optional[dict] = None
    # where the launches and solo refits run: the card unless "cpu"
    device: str = "cuda"

    def resolved(self) -> "TenantsConfig":
        if self.hysteresis < 1:
            raise ValueError(
                f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got "
                f"{self.checkpoint_every}")
        if self.min_fleet < 2:
            raise ValueError(
                f"min_fleet must be >= 2 (a fleet of one is a solo "
                f"refresh), got {self.min_fleet}")
        return dataclasses.replace(
            self,
            store_path=(self.store_path
                        or os.path.join(self.data_dir,
                                        "tenants_store.json")),
            artifacts_dir=(self.artifacts_dir
                           or os.path.join(self.data_dir,
                                           "tenant_models")),
        )


class TenantsSupervisor:
    """The fleet tick loop. Deploy targets, pick exactly one:

      server=    an in-process serve.Server — each tenant is hosted
                 under its tenant_id and swapped via Server.swap;
      swap_url=  a running `serve` frontend of either package (POST
                 /admin/swap per tenant);
      neither    artifact-drop mode — refreshed .npz files land in
                 artifacts_dir and a `serve --watch` loop picks them
                 up.

    `clock` and `sleep` are injectable so tests pin cooldown/stagger
    arithmetic; the clock domain must persist across resumes (the
    default wall clock does)."""

    def __init__(self, config: TenantsConfig, server=None,
                 swap_url: Optional[str] = None,
                 resume: bool = False,
                 clock=time.time,
                 sleep=time.sleep,
                 log_fn=print):
        self.cfg = config.resolved()
        self.server = server
        self.swap_url = swap_url
        self._clock = clock
        self._sleep = sleep
        self.log = log_fn or (lambda msg: None)
        self._io_retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                      op="tenants.tick")
        # the store write is atomic, hence idempotent, hence retryable:
        # an injected/real transient on the commit edge is absorbed here
        # (a kill still dies pre-rename with the previous store intact)
        self._store_retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                         op="tenants.store")
        self._scaler_cache: Dict[str, object] = {}
        os.makedirs(self.cfg.artifacts_dir, exist_ok=True)
        if resume and os.path.exists(self.cfg.store_path):
            self.state = load_store(self.cfg.store_path)
            if self.state.seed != self.cfg.seed:
                raise ValueError(
                    f"tenant store {self.cfg.store_path!r} was written "
                    f"with seed {self.state.seed}, this run passes "
                    f"{self.cfg.seed}; per-tenant decisions would not "
                    "replay — resume with the original seed"
                )
        else:
            self.state = TenantsState(seed=self.cfg.seed)
        self.breaker = faults.CircuitBreaker(
            threshold=self.cfg.breaker_threshold,
            cooldown_s=self.cfg.breaker_cooldown_s,
            name="tenants.refresh",
            clock=clock,
        )
        if self.state.breaker is not None:
            self.breaker.restore(self.state.breaker)
        # persist immediately: a supervisor killed before its first tick
        # must resume with the registry it was launched with, not
        # re-register against data that grew in between
        self._save()

    # ------------------------------------------------------------ registry
    def register(self, rec: TenantRecord) -> None:
        """Admit a tenant: validated, baselined at the current corpus
        state, durably committed. `rec.model_path` must name its
        deployed (donor) artifact — the approximate families are
        rejected here, at admission, because their refresh has no dual
        warm seed (serve/refresh.py)."""
        from tpusvm_torch.config import is_approx_family
        from tpusvm_torch.models import BinarySVC

        rec.validate()
        if rec.tenant_id in self.state.tenants:
            raise ValueError(
                f"tenant {rec.tenant_id!r} is already registered")
        base = BinarySVC.load(rec.model_path, device=self.cfg.device)
        if is_approx_family(base.config.kernel):
            raise ValueError(
                f"tenant {rec.tenant_id!r}: deployed artifact uses the "
                f"approximate {base.config.kernel!r} family — its "
                "refresh has no dual warm seed and refresh_fit rejects "
                "it; register an exact-family artifact"
            )
        if rec.last_refresh_t == 0.0:
            rec.last_refresh_t = float(self._clock())
        self.state.tenants[rec.tenant_id] = rec
        self._save()

    # ------------------------------------------------------------ helpers
    def _open_dataset(self):
        from tpusvm_torch.stream import open_dataset

        return self._io_retry(open_dataset, self.cfg.data_dir)

    def _fitted_range(self, model_path: str):
        cached = self._scaler_cache.get(model_path)
        if cached is not None:
            return cached
        from tpusvm_torch.models.serialization import load_model

        st, _ = load_model(model_path)
        rng = (None if "scaler_min" not in st
               else (st["scaler_min"], st["scaler_max"]))
        self._scaler_cache[model_path] = rng
        return rng

    def _save(self) -> None:
        self.state.breaker = self.breaker.snapshot()
        self._store_retry(save_store, self.cfg.store_path, self.state)

    # --------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One fleet step; returns {"status": TenantsStatus, "drifted":
        [...], "tick": int, ...}. Refresh failures come back as status
        codes (breaker-counted), never exceptions; SimulatedKill and
        tick-edge I/O propagate to run()'s retry-next-tick policy."""
        st = self.state
        st.tick += 1
        faults.point("tenants.tick", tick=st.tick,
                     tenants=len(st.tenants))
        reg = _registry()
        reg.counter("tenants.ticks").inc()
        dataset = self._open_dataset()
        now = float(self._clock())
        thresholds = self.cfg.thresholds
        if thresholds.score is not None:
            # tenant records carry no score baseline; the detector would
            # never see data — disable it structurally rather than let
            # it report a permanent 0
            thresholds = dataclasses.replace(thresholds, score=None)

        if st.stage != "idle":
            # a persisted in-flight launch outranks fresh drift
            # decisions: finish THAT launch first (bit-identically, via
            # its checkpoint), then the next tick re-evaluates
            if not self.breaker.allow():
                reg.counter("tenants.refreshes_suppressed",
                            reason="breaker").inc()
                self._save()
                return {"status": TenantsStatus.SUPPRESSED_BREAKER,
                        "tick": st.tick, "drifted": [],
                        "rows": dataset.n_rows,
                        "generation": st.generation}
            status = self._refresh(dataset, resume_pending=True)
            self._save()
            return {"status": status, "tick": st.tick,
                    "drifted": list(st.inflight["tenant_ids"])
                    if st.inflight else [],
                    "rows": dataset.n_rows, "generation": st.generation}

        drifted: List[str] = []
        armed = 0
        for tid in sorted(st.tenants):
            rec = st.tenants[tid]
            rng = self._fitted_range(rec.model_path) \
                if rec.model_path else None
            t = thresholds
            if rng is None and t.feature is not None:
                t = dataclasses.replace(t, feature=None)
            report = evaluate(
                manifest=dataset.manifest,
                fitted_min=rng[0] if rng else None,
                fitted_max=rng[1] if rng else None,
                rows_at_refresh=rec.rows_at_refresh,
                since_refresh_s=max(0.0, now - rec.last_refresh_t),
                score_baseline=None,
                score_current=None,
                thresholds=t,
                seed=_tenant_seed(st.seed, tid),
                tick=st.tick,
            )
            rec.consecutive_triggered = (
                rec.consecutive_triggered + 1 if report.decision else 0)
            if not report.decision:
                continue
            if rec.consecutive_triggered < self.cfg.hysteresis:
                armed += 1
            elif now < rec.last_refresh_t + self.cfg.cooldown_s \
                    and rec.refreshes > 0:
                reg.counter("tenants.refreshes_suppressed",
                            reason="cooldown").inc()
            else:
                drifted.append(tid)
        reg.gauge("tenants.drifted").set(float(len(drifted)))
        reg.gauge("tenants.breaker_open").set(
            0.0 if self.breaker.state == "closed" else 1.0)
        faults.emit("tenants.drift", tick=st.tick, drifted=drifted,
                    armed=armed, tenants=len(st.tenants))

        status = TenantsStatus.WATCHING
        if drifted:
            if not self.breaker.allow():
                status = TenantsStatus.SUPPRESSED_BREAKER
                reg.counter("tenants.refreshes_suppressed",
                            reason="breaker").inc()
            else:
                status = self._refresh(dataset, drifted=drifted)
        elif armed:
            status = TenantsStatus.TRIGGERED_HYSTERESIS
            reg.counter("tenants.refreshes_suppressed",
                        reason="hysteresis").inc()
        self._save()
        return {"status": status, "tick": st.tick, "drifted": drifted,
                "rows": dataset.n_rows, "generation": st.generation}

    # ------------------------------------------------------------ refresh
    def _refresh(self, dataset, drifted: Optional[List[str]] = None,
                 resume_pending: bool = False) -> TenantsStatus:
        st, cfg = self.state, self.cfg
        reg = _registry()
        try:
            if resume_pending:
                # finish the persisted launch: same plan, same row
                # prefix — later appends cannot change what the
                # resumed refit consumes
                plan = CoalescePlan.from_json(st.inflight["plan"])
                rows = int(st.inflight["stage_rows"])
            else:
                from tpusvm_torch.models import BinarySVC
                from tpusvm_torch.tenants.coalesce import coalesce_drifted

                donors = {tid: BinarySVC.load(
                    st.tenants[tid].model_path, device=cfg.device)
                    for tid in drifted}
                plan = coalesce_drifted(
                    [st.tenants[tid] for tid in drifted], donors,
                    min_fleet=cfg.min_fleet)
                rows = int(dataset.n_rows)
                st.stage = "fitting"
                st.inflight = {
                    "tenant_ids": sorted(drifted),
                    "plan": plan.to_json(),
                    "stage_rows": rows,
                }
                self._save()
            ids = list(st.inflight["tenant_ids"])
            if st.stage != "swapping":
                X, labels = dataset.load_arrays()
                X, labels = X[:rows], labels[:rows]
                outcomes = refresh_drifted(
                    X, labels, [st.tenants[tid] for tid in ids],
                    artifacts_dir=cfg.artifacts_dir,
                    checkpoint_every=cfg.checkpoint_every,
                    resume=True, warm=cfg.warm, plan=plan,
                    min_fleet=cfg.min_fleet,
                    solver_opts=cfg.solver_opts, log=self.log,
                    device=cfg.device,
                )
                st.inflight["outcomes"] = {
                    tid: {"out_path": o["out_path"],
                          "ok": "error" not in o,
                          "n_iter": int(o["n_iter"]),
                          "checkpoint": o.get("checkpoint"),
                          "error": o.get("error")}
                    for tid, o in outcomes.items()
                }
                st.stage = "swapping"
                self._save()
            # the swapping-stage commit above is the point after which
            # the fleet checkpoints are dead weight: every artifact
            # derived from them is durably on disk and named by the
            # store. Deleting EARLIER (at solve convergence) would open
            # a crash window where a kill forces a full re-fit.
            cks = {o.get("checkpoint")
                   for o in st.inflight.get("outcomes", {}).values()}
            for ck in cks:
                if ck and os.path.exists(ck):
                    os.remove(ck)
        except faults.SimulatedKill:
            raise
        except Exception as e:  # noqa: BLE001 — a failed stage is a
            # counted, breaker-fed outcome; previous generations keep
            # serving and the in-flight checkpoint resumes next tick
            self.breaker.record_failure()
            st.failures += 1
            reg.counter("tenants.refreshes_failed", kind="error").inc()
            self.log(f"tenants: refresh stage FAILED "
                     f"({type(e).__name__}: {e}); previous generations "
                     "keep serving")
            faults.emit("tenants.refresh_failed", tick=st.tick,
                        error=f"{type(e).__name__}: {e}")
            self._save()
            return TenantsStatus.REFRESH_FAILED

        # swap roll-out: staggered, per-tenant, failure-isolated
        landed, failed = [], []
        now = float(self._clock())
        outcomes = st.inflight.get("outcomes", {})
        first = True
        for tid in sorted(outcomes):
            o = outcomes[tid]
            rec = st.tenants[tid]
            if not o["ok"]:
                failed.append(tid)
                rec.failures += 1
                continue
            if not first and cfg.stagger_s > 0:
                self._sleep(cfg.stagger_s)
            first = False
            try:
                self._swap(tid, o["out_path"])
            except faults.SimulatedKill:
                raise
            except Exception as e:  # noqa: BLE001 — one tenant's swap
                # failure must not block its bucket-mates' roll-out
                failed.append(tid)
                rec.failures += 1
                self.log(f"tenants: swap of {tid} FAILED "
                         f"({type(e).__name__}: {e}); its previous "
                         "generation keeps serving")
                continue
            rec.model_path = o["out_path"]
            rec.generation += 1
            rec.refreshes += 1
            rec.rows_at_refresh = int(st.inflight["stage_rows"])
            rec.last_refresh_t = now
            rec.consecutive_triggered = 0   # failed tenants stay armed
            self._scaler_cache.pop(o["out_path"], None)
            landed.append(tid)

        st.stage = "idle"
        st.inflight = None
        st.generation += 1
        st.refreshes += len(landed)
        st.failures += len(failed)
        reg.counter("tenants.refreshes_landed").inc(len(landed))
        reg.counter("tenants.refreshes_failed",
                    kind="tenant").inc(len(failed))
        reg.gauge("tenants.generation").set(float(st.generation))
        self._save()
        if landed:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        self.log(f"tenants: generation {st.generation} — "
                 f"{len(landed)} refreshed, {len(failed)} failed")
        if not landed:
            return TenantsStatus.REFRESH_FAILED
        return TenantsStatus.PARTIAL if failed else \
            TenantsStatus.REFRESHED

    def _swap(self, tenant_id: str, out_path: str) -> None:
        if self.server is not None:
            self.server.swap(tenant_id, out_path)
        elif self.swap_url:
            from tpusvm_torch.serve.refresh import swap_via_http

            swap_via_http(self.swap_url, tenant_id,
                          os.path.abspath(out_path))
        # else: artifact-drop mode — the atomic save already published
        # the artifact for a `serve --watch` poller

    # ---------------------------------------------------------------- run
    def run(self, max_ticks: Optional[int] = None,
            stop: Optional[threading.Event] = None) -> dict:
        """Tick until stopped (or max_ticks). Unexpected tick errors are
        logged and retried next tick — at fleet scale the supervisor is
        the LAST component allowed to die quietly."""
        stop = stop or threading.Event()
        done = 0
        last = {}
        while not stop.is_set():
            try:
                last = self.tick()
                self.log(f"tenants tick {last['tick']}: "
                         f"{last['status'].name} "
                         f"({len(last['drifted'])} drifted, rows "
                         f"{last['rows']}, generation "
                         f"{last['generation']})")
            except (faults.SimulatedKill, KeyboardInterrupt):
                raise
            except Exception as e:  # noqa: BLE001 — keep supervising
                self.log(f"tenants: tick error "
                         f"{type(e).__name__}: {e}")
                last = {"status": TenantsStatus.REFRESH_FAILED,
                        "error": str(e)}
            done += 1
            if max_ticks is not None and done >= max_ticks:
                break
            stop.wait(self.cfg.interval_s)
        return {"ticks": done, "generation": self.state.generation,
                "refreshes": self.state.refreshes,
                "failures": self.state.failures,
                "tenants": len(self.state.tenants), "last": last}
