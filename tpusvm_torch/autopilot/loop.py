"""The autopilot supervisor: ingest-watch -> drift decision -> refresh.

The port of tpusvm/autopilot/loop.py. A tick loop watches the
(append-grown) dataset and the serving metrics, decides by the
deterministic drift detectors whether the deployed model went stale, and
drives the crash-safe refresh machinery (a warm-started checkpointed fit
on the card, an atomic save, a staged hot-swap) unattended, through every
failure on the way:

  * hysteresis and cooldown: a noisy detector must trigger on
    `hysteresis` consecutive ticks, and a refresh starts a cooldown
    window, so retrains cannot thrash;
  * a refresh CircuitBreaker: repeated refresh failures trip it and the
    supervisor degrades to watch-only (SUPPRESSED_BREAKER) instead of
    hot-looping a poisoned batch; the half-open probe retries after the
    cooldown;
  * a watchdog deadline: a too-slow fit is stopped at a checkpointed
    segment boundary (solver/checkpoint.py:WatchdogTimeout) and resumed
    from its own checkpoint on a later tick;
  * retry with backoff (faults/retry.py) on the dataset-open edge;
  * crash-safe state (autopilot/state.py): every decision input and the
    in-flight refresh stage persist atomically, so a resumed supervisor
    replays the same decisions and, through the solver checkpoint, a
    bit-identical refit. `python -m tpusvm_torch.faults
    autopilot-chaos-smoke` is its gate.

Generation k's refreshed artifact is generation k+1's warm-start donor
(serve/refresh.py: its duals seed the next refit). The refit runs on the
card unless the config asks for the CPU (AutopilotConfig.device).

Fault points: ``autopilot.tick`` (every tick's entry), ``autopilot.refresh``
(the fit/save/swap stage), ``autopilot.state`` (every state write). The
autopilot.* counters and gauges go to the process's default registry
(obs/registry.py); drift decisions go to the faults event sink as
``autopilot.drift`` events.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

from tpusvm_torch import faults
from tpusvm_torch.autopilot.drift import DriftThresholds, evaluate
from tpusvm_torch.autopilot.state import (AutopilotState, load_state,
                                          save_state)
from tpusvm_torch.status import AutopilotStatus


def _registry():
    from tpusvm_torch.obs.registry import default_registry

    return default_registry()


@dataclasses.dataclass
class AutopilotConfig:
    """The supervisor's knobs. Paths: `model_path` is the deployed
    artifact the FIRST refresh warm-starts from (successive refreshes
    chain from the last successfully swapped artifact); `out_path` is
    where refreshed artifacts land (atomic replace — point a
    `serve --watch` directory at it for zero-coordination deploys)."""

    data_dir: str
    model_path: str
    out_path: Optional[str] = None          # default: <model>.refresh.npz
    state_path: Optional[str] = None        # default: data_dir/autopilot_state.json
    name: Optional[str] = None              # hosted model name for swaps
    interval_s: float = 30.0
    thresholds: DriftThresholds = dataclasses.field(
        default_factory=DriftThresholds)
    hysteresis: int = 1
    cooldown_s: float = 0.0
    warm: bool = True
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 64
    deadline_s: Optional[float] = None      # watchdog (needs checkpoint)
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 60.0
    seed: int = 0
    # fleet observability for a process with no HTTP listener: when set,
    # every tick publishes this process's obs.fleet snapshot payload
    # here (staged + fsync_replace — never torn), and the fleet
    # collector picks it up as a file source
    metrics_snapshot_path: Optional[str] = None
    # where the refresh fit runs: the card unless "cpu"
    device: str = "cuda"

    def resolved(self) -> "AutopilotConfig":
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got "
                             f"{self.hysteresis}")
        if self.deadline_s is not None and self.checkpoint_path is None:
            raise ValueError(
                "deadline_s (the fit watchdog) needs checkpoint_path: "
                "the deadline stops the fit at a checkpointed segment "
                "boundary so a later tick can resume it"
            )
        out = self.out_path
        if out is None:
            stem = self.model_path
            if stem.endswith(".npz"):
                stem = stem[:-4]
            out = stem + ".refresh.npz"
        return dataclasses.replace(
            self,
            out_path=out,
            state_path=(self.state_path
                        or os.path.join(self.data_dir,
                                        "autopilot_state.json")),
            name=(self.name
                  or os.path.splitext(os.path.basename(out))[0]),
        )


class Autopilot:
    """The tick loop. Deploy targets, pick exactly one:

      server=    an in-process serve.Server (swaps via Server.swap);
      swap_url=  a running `serve` frontend of either package
                 (POST /admin/swap);
      neither    artifact-drop mode — the refreshed .npz lands at
                 out_path and a `serve --watch` loop picks it up.

    `clock` is injectable (tests pin cooldown/staleness/watchdog/breaker
    arithmetic with a fake clock); it must be the same clock domain
    across resumes for cooldowns to replay — the default wall clock is.
    """

    def __init__(self, config: AutopilotConfig, server=None,
                 swap_url: Optional[str] = None,
                 resume: bool = False,
                 clock=time.time,
                 log_fn=print):
        self.cfg = config.resolved()
        self.server = server
        self.swap_url = swap_url
        self._clock = clock
        self.log = log_fn or (lambda msg: None)
        self._io_retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                      op="autopilot.tick")
        self._scaler_cache = {}
        if resume and os.path.exists(self.cfg.state_path):
            self.state = load_state(self.cfg.state_path)
            if self.state.seed != self.cfg.seed:
                raise ValueError(
                    f"autopilot state {self.cfg.state_path!r} was "
                    f"written with seed {self.state.seed}, this run "
                    f"passes {self.cfg.seed}; decisions would not "
                    "replay — resume with the original seed"
                )
        else:
            ds = self._open_dataset()
            self.state = AutopilotState(
                seed=self.cfg.seed,
                rows_at_refresh=ds.n_rows,
                last_refresh_t=float(self._clock()),
                model_path=self.cfg.model_path,
                score_baseline=self._score_stats(),
            )
        self.breaker = faults.CircuitBreaker(
            threshold=self.cfg.breaker_threshold,
            cooldown_s=self.cfg.breaker_cooldown_s,
            name="autopilot.refresh",
            clock=clock,
        )
        if self.state.breaker is not None:
            self.breaker.restore(self.state.breaker)
        # persist the deployment-time baseline IMMEDIATELY: a supervisor
        # killed before its first tick must not let a resumed
        # incarnation re-baseline on data that grew in between (the
        # drift decision would silently never fire)
        self._save()

    # ------------------------------------------------------------ helpers
    def _open_dataset(self):
        from tpusvm_torch.stream import open_dataset

        return self._io_retry(open_dataset, self.cfg.data_dir)

    def _score_stats(self) -> Optional[dict]:
        if self.server is None or self.cfg.name is None:
            return None
        try:
            return self.server.score_stats(self.cfg.name)
        except KeyError:
            return None  # not hosted (yet): no score-shift signal

    def _fitted_range(self):
        """(min, max) the current donor artifact was scaled with, or
        None for an unscaled model (feature drift then has no fitted
        range to compare against)."""
        path = self.state.model_path
        cached = self._scaler_cache.get(path)
        if cached is not None:
            return cached
        from tpusvm_torch.models.serialization import load_model

        st, _ = load_model(path)
        rng = (None if "scaler_min" not in st
               else (st["scaler_min"], st["scaler_max"]))
        self._scaler_cache[path] = rng
        return rng

    def _save(self) -> None:
        self.state.breaker = self.breaker.snapshot()
        save_state(self.cfg.state_path, self.state)

    # --------------------------------------------------------------- tick
    def tick(self) -> dict:
        """One supervisor step; returns {"status": AutopilotStatus,
        "report": DriftReport, ...}. Refresh failures come back as
        status codes (breaker-counted), never exceptions; what CAN
        propagate is SimulatedKill and tick-edge I/O the run() loop's
        retry-next-tick policy owns (injected tick transients, an
        unreadable dataset)."""
        st = self.state
        st.tick += 1
        faults.point("autopilot.tick", tick=st.tick)
        reg = _registry()
        reg.counter("autopilot.ticks").inc()
        dataset = self._open_dataset()
        rng = self._fitted_range()
        thresholds = self.cfg.thresholds
        if rng is None and thresholds.feature is not None:
            thresholds = dataclasses.replace(thresholds, feature=None)
        now = float(self._clock())
        report = evaluate(
            manifest=dataset.manifest,
            fitted_min=rng[0] if rng else None,
            fitted_max=rng[1] if rng else None,
            rows_at_refresh=st.rows_at_refresh,
            since_refresh_s=max(0.0, now - st.last_refresh_t),
            score_baseline=st.score_baseline,
            score_current=self._score_stats(),
            thresholds=thresholds,
            seed=st.seed,
            tick=st.tick,
        )
        for d in report.detectors:
            reg.gauge("autopilot.drift_score", detector=d.name).set(d.score)
        reg.gauge("autopilot.data_staleness_rows").set(
            float(max(0, dataset.n_rows - st.rows_at_refresh)))
        reg.gauge("autopilot.breaker_open").set(
            0.0 if self.breaker.state == "closed" else 1.0)
        faults.emit("autopilot.drift", tick=st.tick,
                    decision=report.decision, reason=report.reason,
                    report=report.to_json())

        st.consecutive_triggered = (st.consecutive_triggered + 1
                                    if report.decision else 0)
        pending = st.stage != "idle"
        status = AutopilotStatus.WATCHING
        if pending or (report.decision
                       and st.consecutive_triggered >= self.cfg.hysteresis):
            if not pending and now < st.cooldown_until:
                status = AutopilotStatus.SUPPRESSED_COOLDOWN
                reg.counter("autopilot.refreshes_suppressed",
                            reason="cooldown").inc()
            elif not self.breaker.allow():
                status = AutopilotStatus.SUPPRESSED_BREAKER
                reg.counter("autopilot.refreshes_suppressed",
                            reason="breaker").inc()
            else:
                status = self._refresh(dataset)
        elif report.decision:
            status = AutopilotStatus.TRIGGERED_HYSTERESIS
            reg.counter("autopilot.refreshes_suppressed",
                        reason="hysteresis").inc()
        self._save()
        if self.cfg.metrics_snapshot_path is not None:
            self._drop_fleet_snapshot(status)
        return {"status": status, "report": report,
                "tick": st.tick, "rows": dataset.n_rows,
                "generation": st.generation}

    def _drop_fleet_snapshot(self, status: AutopilotStatus) -> None:
        """Publish the on-disk fleet payload (best-effort: telemetry
        must never fail a tick — a full disk loses one drop, not the
        supervisor)."""
        from tpusvm_torch.obs.fleet import (snapshot_payload,
                                            write_snapshot_file)

        try:
            write_snapshot_file(
                self.cfg.metrics_snapshot_path,
                snapshot_payload(
                    "autopilot", self.cfg.name, _registry().snapshot(),
                    status={"stage": self.state.stage,
                            "tick": self.state.tick,
                            "status": status.name,
                            "generation": self.state.generation}))
        except OSError as e:
            self.log(f"autopilot: fleet snapshot drop failed: {e}")

    # ------------------------------------------------------------ refresh
    def _refresh(self, dataset) -> AutopilotStatus:
        from tpusvm_torch.solver.checkpoint import WatchdogTimeout

        st, cfg = self.state, self.cfg
        reg = _registry()
        try:
            faults.point("autopilot.refresh", tick=st.tick)
            if st.stage != "swapping":
                # record the row count the refit consumes BEFORE fitting:
                # a kill between save and swap must not let later appends
                # inflate the provenance
                st.stage = "fitting"
                st.stage_rows = dataset.n_rows
                self._save()
                from tpusvm_torch.serve.refresh import refresh_fit

                X, Y = dataset.load_arrays()
                watchdog = None
                if cfg.deadline_s is not None:
                    deadline = float(self._clock()) + cfg.deadline_s
                    watchdog = lambda: float(self._clock()) >= deadline  # noqa: E731
                refresh_fit(
                    st.model_path, X, Y, out_path=cfg.out_path,
                    checkpoint_path=cfg.checkpoint_path,
                    checkpoint_every=cfg.checkpoint_every,
                    resume=cfg.checkpoint_path is not None,
                    warm=cfg.warm, watchdog=watchdog, device=cfg.device,
                )
                st.stage = "swapping"
                self._save()
            self._swap()
        except faults.SimulatedKill:
            raise
        except WatchdogTimeout as e:
            # deadline hit between solve segments: the checkpoint is
            # durable, stage stays "fitting", a later eligible tick
            # resumes the SAME fit bit-identically
            self.breaker.record_failure()
            st.failures += 1
            reg.counter("autopilot.refreshes_failed",
                        kind="timeout").inc()
            self.log(f"autopilot: refresh watchdog timeout ({e}); will "
                     "resume from its checkpoint")
            self._save()
            return AutopilotStatus.REFRESH_TIMEOUT
        except Exception as e:  # noqa: BLE001 — every refresh failure is
            # a counted, breaker-fed outcome, never a dead supervisor
            self.breaker.record_failure()
            st.failures += 1
            reg.counter("autopilot.refreshes_failed", kind="error").inc()
            self.log(f"autopilot: refresh FAILED ({type(e).__name__}: "
                     f"{e}); previous generation keeps serving")
            faults.emit("autopilot.refresh_failed", tick=st.tick,
                        error=f"{type(e).__name__}: {e}")
            self._save()
            return AutopilotStatus.REFRESH_FAILED
        self.breaker.record_success()
        now = float(self._clock())
        st.stage = "idle"
        st.refreshes += 1
        st.generation += 1
        st.rows_at_refresh = int(st.stage_rows)
        st.last_refresh_t = now
        st.cooldown_until = now + cfg.cooldown_s
        st.consecutive_triggered = 0
        st.model_path = cfg.out_path   # the refresh chain's new donor
        st.score_baseline = self._score_stats()
        self._scaler_cache.pop(cfg.out_path, None)
        reg.counter("autopilot.refreshes_triggered").inc()
        reg.gauge("autopilot.generation").set(float(st.generation))
        self._save()
        self.log(f"autopilot: refreshed -> generation {st.generation} "
                 f"({st.rows_at_refresh} rows)")
        return AutopilotStatus.REFRESHED

    def _swap(self) -> None:
        cfg = self.cfg
        if self.server is not None:
            self.server.swap(cfg.name, cfg.out_path)
        elif self.swap_url:
            from tpusvm_torch.serve.refresh import swap_via_http

            swap_via_http(self.swap_url, cfg.name,
                          os.path.abspath(cfg.out_path))
        # else: artifact-drop mode — the atomic save already published
        # the new artifact for a `serve --watch` poller

    # ---------------------------------------------------------------- run
    def run(self, max_ticks: Optional[int] = None,
            stop: Optional[threading.Event] = None) -> dict:
        """Tick until stopped (or max_ticks). Unexpected tick errors are
        logged and retried next tick — the supervisor is the component
        that must NOT die quietly."""
        stop = stop or threading.Event()
        done = 0
        last = {}
        while not stop.is_set():
            try:
                last = self.tick()
                self.log(f"autopilot tick {last['tick']}: "
                         f"{last['status'].name} "
                         f"(rows {last['rows']}, generation "
                         f"{last['generation']})")
            except (faults.SimulatedKill, KeyboardInterrupt):
                raise
            except Exception as e:  # noqa: BLE001 — keep supervising
                self.log(f"autopilot: tick error "
                         f"{type(e).__name__}: {e}")
                last = {"status": AutopilotStatus.REFRESH_FAILED,
                        "error": str(e)}
            done += 1
            if max_ticks is not None and done >= max_ticks:
                break
            stop.wait(self.cfg.interval_s)
        return {"ticks": done, "generation": self.state.generation,
                "refreshes": self.state.refreshes,
                "failures": self.state.failures, "last": last}
