"""Deterministic drift and staleness detectors over on-disk artifacts.

The port's copy of tpusvm/autopilot/drift.py (pure numpy, no device).
Every signal the autopilot's retrain decision reads is computed from facts
already durable on disk or in the metrics registry, with no sampling and
no clock read inside a detector, so the same inputs give the same
decision, and a resumed supervisor replays the killed one's decisions:

  feature_drift   the appended shards' merged min/max against the
                  DEPLOYED model's fitted scaler range (the manifest's
                  per-shard stats make "appended" = row_start >=
                  baseline_rows a pure manifest read). Score: the largest
                  per-feature range escape, relative to the fitted range.
  score_shift     the served-score positive rate of the traffic SINCE the
                  last refresh against the tallies recorded at swap time
                  (the serve.scores_pos/neg counters, Server.score_stats).
                  Score: |rate_now - rate_base|.
  row_growth      dataset rows against the rows at the last refresh.
                  Score: new_rows / rows_at_refresh.
  staleness       seconds since the last refresh (the clock value is an
                  INPUT, from the supervisor's injectable clock). Score:
                  seconds / threshold_s.

Each evaluation emits a schema-versioned DriftReport whose JSON is the
JAX package's, byte for byte, for the same (inputs, seed): thresholds get
a deterministic per-(seed, tick, detector) jitter drawn as the FaultPlan
draws (`default_rng(seed ^ crc32(tick:name))`), reproducible by seed.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, List, Optional

import numpy as np

DRIFT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class DetectorResult:
    """One detector's verdict. `score` is normalised so that
    triggered == (score >= threshold); threshold carries the applied
    (jittered) value, base_threshold the configured one."""

    name: str
    score: float
    threshold: float
    base_threshold: float
    triggered: bool
    detail: Dict[str, float]

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "score": float(self.score),
            "threshold": float(self.threshold),
            "base_threshold": float(self.base_threshold),
            "triggered": bool(self.triggered),
            "detail": {k: (float(v) if isinstance(v, (int, float,
                                                      np.floating,
                                                      np.integer))
                           else v)
                       for k, v in sorted(self.detail.items())},
        }


@dataclasses.dataclass
class DriftReport:
    """The per-tick decision record: schema-versioned, reproducible by
    seed (same inputs + seed => byte-identical JSON)."""

    seed: int
    tick: int
    detectors: List[DetectorResult]
    decision: bool
    reason: str
    schema_version: int = DRIFT_SCHEMA_VERSION

    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "seed": int(self.seed),
            "tick": int(self.tick),
            "decision": bool(self.decision),
            "reason": self.reason,
            "detectors": [d.to_json() for d in self.detectors],
        }

    def to_json_bytes(self) -> bytes:
        """Canonical bytes: sorted keys, minimal separators. Python's
        repr-based float serialisation is shortest-round-trip, so equal
        float64 inputs serialise to equal bytes."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode()


def _jitter(seed: int, tick: int, name: str, frac: float) -> float:
    """Deterministic threshold jitter in [-frac, +frac] — the FaultPlan
    rng-derivation discipline, so adding a detector never perturbs
    another's draw."""
    if frac <= 0.0:
        return 0.0
    rng = np.random.default_rng(
        (int(seed) ^ zlib.crc32(f"{tick}:{name}".encode())) & 0xFFFFFFFF
    )
    return float(rng.uniform(-frac, frac))


def _result(name: str, score: float, base_thr: float, seed: int,
            tick: int, jitter_frac: float,
            detail: Dict[str, float]) -> DetectorResult:
    thr = base_thr * (1.0 + _jitter(seed, tick, name, jitter_frac))
    return DetectorResult(
        name=name, score=float(score), threshold=float(thr),
        base_threshold=float(base_thr),
        triggered=bool(score >= thr), detail=detail,
    )


def feature_drift(manifest, fitted_min: np.ndarray,
                  fitted_max: np.ndarray, baseline_rows: int) -> dict:
    """Raw feature-range drift facts of the shards appended since
    `baseline_rows` vs the fitted [min, max] (the deployed scaler).

    Pure manifest arithmetic — no shard bytes are read. Returns
    {"score", "frac_escaped", "appended_rows"}; score is the largest
    per-feature escape relative to the fitted range (a degenerate fitted
    range compares absolutely)."""
    fitted_min = np.asarray(fitted_min, np.float64)
    fitted_max = np.asarray(fitted_max, np.float64)
    appended = [s for s in manifest.shards
                if s.row_start >= baseline_rows]
    if not appended:
        return {"score": 0.0, "frac_escaped": 0.0, "appended_rows": 0}
    from tpusvm_torch.stream.stats import merge_stats

    st = merge_stats([s.stats for s in appended])
    rng = fitted_max - fitted_min
    rng = np.where(rng > 0.0, rng, 1.0)
    below = np.maximum(0.0, (fitted_min - st.min_val) / rng)
    above = np.maximum(0.0, (st.max_val - fitted_max) / rng)
    esc = np.maximum(below, above)
    return {
        "score": float(esc.max()),
        "frac_escaped": float(np.mean(esc > 0.0)),
        "appended_rows": int(st.n_rows),
    }


def score_shift(baseline: Dict[str, int], current: Dict[str, int]) -> dict:
    """Positive-rate shift of served scores SINCE the baseline tallies.

    Both inputs are cumulative {pos, neg} counters (Server.score_stats);
    the detector differences them so only post-refresh traffic counts.
    Returns {"score", "window", "rate_now", "rate_base"}."""
    dp = max(0, int(current.get("pos", 0)) - int(baseline.get("pos", 0)))
    dn = max(0, int(current.get("neg", 0)) - int(baseline.get("neg", 0)))
    window = dp + dn
    bp = int(baseline.get("pos", 0))
    bn = int(baseline.get("neg", 0))
    base_total = bp + bn
    rate_base = (bp / base_total) if base_total else 0.5
    rate_now = (dp / window) if window else rate_base
    return {
        "score": abs(rate_now - rate_base),
        "window": window,
        "rate_now": rate_now,
        "rate_base": rate_base,
    }


@dataclasses.dataclass(frozen=True)
class DriftThresholds:
    """The decision surface (autopilot config slice). A None threshold
    disables its detector. jitter_frac spreads each threshold by a
    seeded ±fraction (0 = exact thresholds, the chaos-gate setting)."""

    feature: Optional[float] = 0.10
    growth: Optional[float] = 0.25
    score: Optional[float] = 0.20
    staleness_s: Optional[float] = None
    min_new_rows: int = 1
    min_score_window: int = 32
    jitter_frac: float = 0.0


def evaluate(*, manifest, fitted_min, fitted_max, rows_at_refresh: int,
             since_refresh_s: float,
             score_baseline: Optional[Dict[str, int]],
             score_current: Optional[Dict[str, int]],
             thresholds: DriftThresholds, seed: int,
             tick: int) -> DriftReport:
    """Run every enabled detector and fold them into one DriftReport.

    Decision rule: refresh when ANY detector triggers AND at least
    min_new_rows rows have been appended (a refresh on unchanged data
    would re-fit the identical problem — suppressed with its own
    reason, staleness excepted)."""
    t = thresholds
    dets: List[DetectorResult] = []
    new_rows = max(0, manifest.n_rows - rows_at_refresh)
    if t.feature is not None:
        fd = feature_drift(manifest, fitted_min, fitted_max,
                           rows_at_refresh)
        score = fd.pop("score")
        dets.append(_result("feature_drift", score, t.feature, seed,
                            tick, t.jitter_frac, fd))
    if t.growth is not None:
        growth = new_rows / max(1, rows_at_refresh)
        dets.append(_result(
            "row_growth", growth, t.growth, seed, tick, t.jitter_frac,
            {"new_rows": new_rows, "rows_at_refresh": rows_at_refresh},
        ))
    if t.score is not None and score_baseline is not None \
            and score_current is not None:
        ss = score_shift(score_baseline, score_current)
        score = ss.pop("score")
        if ss["window"] < t.min_score_window:
            # too little post-refresh traffic for the rate to mean
            # anything: report the facts, never trigger
            dets.append(DetectorResult(
                "score_shift", float(score), float("inf"),
                float(t.score), False,
                {**ss, "below_min_window": 1},
            ))
        else:
            dets.append(_result("score_shift", score, t.score, seed,
                                tick, t.jitter_frac, ss))
    if t.staleness_s is not None:
        dets.append(_result(
            "staleness", since_refresh_s / t.staleness_s, 1.0, seed,
            tick, t.jitter_frac,
            {"since_refresh_s": since_refresh_s,
             "threshold_s": t.staleness_s},
        ))
    fired = [d.name for d in dets if d.triggered]
    if not fired:
        decision, reason = False, "no detector triggered"
    elif new_rows < t.min_new_rows and fired != ["staleness"]:
        decision, reason = False, (
            f"suppressed: {new_rows} new rows < min_new_rows="
            f"{t.min_new_rows} (triggered: {', '.join(fired)})"
        )
    else:
        decision, reason = True, f"triggered: {', '.join(fired)}"
    return DriftReport(seed=int(seed), tick=int(tick), detectors=dets,
                       decision=decision, reason=reason)
