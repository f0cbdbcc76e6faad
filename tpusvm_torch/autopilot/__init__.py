"""tpusvm_torch.autopilot: the closed-loop online-learning supervisor.

The port of tpusvm/autopilot/. It ties the stream-side half (crash-safe
tail appends, stream/append.py) to the serving-side half (the
warm-started checkpointed refresh and the atomic hot-swap, serve/) with a
supervised tick loop:

  drift.py   deterministic drift and staleness detectors over on-disk
             artifacts; a schema-versioned DriftReport whose JSON is the
             JAX package's, byte for byte, for the same (inputs, seed)
  state.py   crash-safe autopilot_state.json (atomic, versioned,
             CRC-fingerprinted; the JAX package's bytes): decisions and
             the in-flight refresh stage replay across kills
  loop.py    the tick loop: ingest-watch -> drift decision -> refresh_fit
             on the card -> atomic save -> swap, with hysteresis,
             cooldown, a refresh CircuitBreaker and a checkpointed fit
             watchdog

Command line: `python -m tpusvm_torch autopilot`; its chaos gate:
`python -m tpusvm_torch.faults autopilot-chaos-smoke`.
"""

from tpusvm_torch.autopilot.drift import (
    DRIFT_SCHEMA_VERSION,
    DetectorResult,
    DriftReport,
    DriftThresholds,
    evaluate,
    feature_drift,
    score_shift,
)
from tpusvm_torch.autopilot.loop import Autopilot, AutopilotConfig
from tpusvm_torch.autopilot.state import (
    STATE_VERSION,
    AutopilotState,
    load_state,
    save_state,
)

__all__ = [
    "DRIFT_SCHEMA_VERSION",
    "STATE_VERSION",
    "Autopilot",
    "AutopilotConfig",
    "AutopilotState",
    "DetectorResult",
    "DriftReport",
    "DriftThresholds",
    "evaluate",
    "feature_drift",
    "load_state",
    "save_state",
    "score_shift",
]
