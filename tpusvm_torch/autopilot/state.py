"""Crash-safe supervisor state: `autopilot_state.json`.

The port's copy of tpusvm/autopilot/state.py: the same file, byte for
byte, for the same state, so a state written by either package loads in
the other. The autopilot's whole decision memory lives in one atomic,
format-versioned, CRC-fingerprinted JSON file. A resumed supervisor
restores it and replays to the same decisions (drift evaluation is a pure
function of dataset, state, seed and tick) and, through the persisted
refresh stage, finishes an interrupted refresh from its own checkpoint
instead of restarting it or swapping twice:

  stage "idle"      no refresh in flight;
  stage "fitting"   a refresh fit started (its solver checkpoint, if one
                    is configured, resumes bit for bit);
  stage "swapping"  the refreshed artifact is saved and complete (the save
                    is atomic); only the swap remains.

The CRC covers the canonical JSON payload, so a torn or hand-edited state
file is a named error, never a silently wrong replay. Fault point:
``autopilot.state`` fires before every write.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Optional

from tpusvm_torch import faults
from tpusvm_torch.utils.durable import fsync_replace

STATE_VERSION = 1

STAGES = ("idle", "fitting", "swapping")


@dataclasses.dataclass
class AutopilotState:
    """Everything a tick decision depends on (plus progress counters)."""

    seed: int
    tick: int = 0
    consecutive_triggered: int = 0
    rows_at_refresh: int = 0
    last_refresh_t: float = 0.0       # supervisor clock domain
    cooldown_until: float = 0.0       # supervisor clock domain
    generation: int = 0               # successful refreshes survived
    refreshes: int = 0
    failures: int = 0
    stage: str = "idle"
    stage_rows: int = 0               # rows the in-flight refit consumes
    model_path: str = ""              # current warm-start donor artifact
    score_baseline: Optional[Dict[str, int]] = None
    breaker: Optional[dict] = None    # faults.CircuitBreaker.snapshot()

    def to_json(self) -> dict:
        return {
            "state_version": STATE_VERSION,
            **{f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)},
        }


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def save_state(path: str, state: AutopilotState) -> None:
    """Atomic write (temp + os.replace) with a CRC32 fingerprint of the
    canonical payload — a kill mid-write leaves the previous state."""
    if state.stage not in STAGES:
        raise ValueError(f"unknown autopilot stage {state.stage!r}")
    payload = state.to_json()
    obj = {"crc32": zlib.crc32(_canonical(payload)) & 0xFFFFFFFF,
           **payload}
    faults.point("autopilot.state", path=path, stage=state.stage)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    fsync_replace(tmp, path)


def load_state(path: str) -> AutopilotState:
    """Version gate + CRC verification first; corruption and version
    skew are named errors, not wrong replays."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"autopilot state {path!r} is not valid JSON ({e}); "
                "delete it to start fresh"
            ) from e
    if "state_version" not in obj:
        raise ValueError(
            f"{path!r} is not an autopilot state (no state_version)"
        )
    v = obj["state_version"]
    if v != STATE_VERSION:
        raise ValueError(
            f"unsupported autopilot state version {v!r} in {path!r} "
            f"(this build reads version {STATE_VERSION})"
        )
    crc = obj.pop("crc32", None)
    want = zlib.crc32(_canonical(obj)) & 0xFFFFFFFF
    if crc != want:
        raise ValueError(
            f"autopilot state {path!r} fails its CRC fingerprint "
            f"(stored {crc!r}, computed {want}) — torn write or manual "
            "edit; delete it to start fresh"
        )
    obj.pop("state_version")
    fields = {f.name for f in dataclasses.fields(AutopilotState)}
    unknown = set(obj) - fields
    if unknown:
        raise ValueError(
            f"autopilot state {path!r} carries unknown fields "
            f"{sorted(unknown)} (written by a newer version?)"
        )
    st = AutopilotState(**obj)
    if st.stage not in STAGES:
        raise ValueError(
            f"autopilot state {path!r} names unknown stage {st.stage!r}"
        )
    return st
