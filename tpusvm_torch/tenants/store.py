"""Crash-safe tenant registry and the coalesced refresh's fleet checkpoint.

The port of tpusvm/tenants/store.py. One file holds the whole platform's
decision memory: every tenant's view spec, hyperparameters, deployed
artifact, drift counters and refresh provenance, plus the supervisor's
stage machine and the in-flight coalesced launch. It is the JAX package's
file, byte for byte, for the same state (format-versioned,
CRC-fingerprinted canonical JSON, an atomic temp + fsync_replace write
behind the ``tenants.store`` fault point), so a store written by either
package loads in the other; a torn or hand-edited store is a named error.

The second durable artifact is the coalesced refresh's fleet-segment
checkpoint: the port's batched carry (fleet/solve.py:FleetState, every
lane's alpha, f, counters, rescue count and seed flag, and the fleet's
own counters) written between fleet_smo_solve segments, so a supervisor
killed mid-refresh re-enters the SAME batched solve from the last segment
boundary, bit for bit per lane. It keeps the JAX file's version key and
fingerprint, but its carry is the port's own: the JAX package saves its
solver's _OuterState, and the two frameworks' trajectories differ in the
last bits (ROADMAP Queue 3), so a checkpoint written by the other package
is refused by name, never resumed. Both writes share the one fault point:
a kill rule on ``tenants.store`` dies where a real crash would, before
the rename.

Stage machine (persisted in the store, validated both ways):

  "idle"      no coalesced refresh in flight;
  "fitting"   a launch is in flight: `inflight` names the exact tenant
              set, row count and plan, so a resumed supervisor finishes
              THAT launch, not a re-planned one later appends could
              change;
  "swapping"  every in-flight artifact is saved (atomically); only the
              staggered swap roll-out remains.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Optional

import numpy as np

from tpusvm_torch import faults
from tpusvm_torch.utils.durable import fsync_replace

STORE_VERSION = 1

STAGES = ("idle", "fitting", "swapping")

FLEET_CKPT_VERSION = 1

# the carry a port fleet checkpoint holds; a file without it was written
# by the JAX package (its solver's _OuterState fields)
FLEET_CARRY = "tpusvm_torch.fleet.FleetState"
_COUNTERS = ("n_host_syncs", "host_wait_s", "n_rounds", "lane_rounds",
             "bucket_rounds")


@dataclasses.dataclass
class TenantRecord:
    """One tenant's slice of the platform: its view over the shared
    corpus, its hyperparameters, its deployed artifact and its drift
    state. `positive_label` defines the label-column view (Y = +1 on
    rows carrying it, -1 elsewhere); `row_mod`/`row_ofs` optionally
    restrict the tenant to the row subset ``idx % row_mod == row_ofs``
    (threaded through the fleet's per-problem valid mask — X itself is
    never copied per tenant)."""

    tenant_id: str
    positive_label: int
    C: float
    gamma: float
    row_mod: Optional[int] = None
    row_ofs: int = 0
    model_path: str = ""              # current warm-start donor artifact
    generation: int = 0
    rows_at_refresh: int = 0
    last_refresh_t: float = 0.0       # supervisor clock domain
    consecutive_triggered: int = 0
    refreshes: int = 0
    failures: int = 0

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def validate(self) -> None:
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if not (np.isfinite(self.C) and self.C > 0):
            raise ValueError(
                f"tenant {self.tenant_id!r}: C must be positive finite, "
                f"got {self.C!r}")
        if not (np.isfinite(self.gamma) and self.gamma > 0):
            raise ValueError(
                f"tenant {self.tenant_id!r}: gamma must be positive "
                f"finite, got {self.gamma!r}")
        if self.row_mod is not None:
            if self.row_mod < 1:
                raise ValueError(
                    f"tenant {self.tenant_id!r}: row_mod must be >= 1, "
                    f"got {self.row_mod}")
            if not (0 <= self.row_ofs < self.row_mod):
                raise ValueError(
                    f"tenant {self.tenant_id!r}: row_ofs {self.row_ofs} "
                    f"outside [0, row_mod={self.row_mod})")


@dataclasses.dataclass
class TenantsState:
    """The platform's whole decision memory: tenant records keyed by id
    plus the supervisor's stage machine and fleet-level counters."""

    seed: int
    tick: int = 0
    stage: str = "idle"
    # the in-flight coalesced refresh: {"tenant_ids": [...], "plan":
    # CoalescePlan.to_json(), "stage_rows": int, "outcomes": {...}} —
    # persisted BEFORE the launch starts so a resumed supervisor
    # finishes the same launch over the same row prefix
    inflight: Optional[dict] = None
    generation: int = 0               # completed coalesced refresh rounds
    refreshes: int = 0                # per-tenant refreshes landed, total
    failures: int = 0
    breaker: Optional[dict] = None    # faults.CircuitBreaker.snapshot()
    tenants: Dict[str, TenantRecord] = dataclasses.field(
        default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "store_version": STORE_VERSION,
            **{f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "tenants"},
            "tenants": {tid: rec.to_json()
                        for tid, rec in sorted(self.tenants.items())},
        }
        return out


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def save_store(path: str, state: TenantsState) -> None:
    """Atomic write (temp + fsync_replace) with a CRC32 fingerprint of
    the canonical payload — a kill mid-write leaves the previous
    store."""
    if state.stage not in STAGES:
        raise ValueError(f"unknown tenants stage {state.stage!r}")
    for rec in state.tenants.values():
        rec.validate()
    payload = state.to_json()
    obj = {"crc32": zlib.crc32(_canonical(payload)) & 0xFFFFFFFF,
           **payload}
    faults.point("tenants.store", path=path, stage=state.stage,
                 tenants=len(state.tenants))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
    fsync_replace(tmp, path)


def is_tenant_store(path: str) -> bool:
    """Cheap sniff for `info`: a JSON file carrying store_version and
    tenants."""
    if not os.path.isfile(path):
        return False
    try:
        with open(path) as f:
            head = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(head, dict) and "store_version" in head \
        and "tenants" in head


def load_store(path: str) -> TenantsState:
    """Version gate + CRC verification first; corruption and version
    skew are named errors, not wrong replays."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"tenant store {path!r} is not valid JSON ({e}); "
                "delete it to start fresh"
            ) from e
    if "store_version" not in obj:
        raise ValueError(
            f"{path!r} is not a tenant store (no store_version)"
        )
    v = obj["store_version"]
    if v != STORE_VERSION:
        raise ValueError(
            f"unsupported tenant store version {v!r} in {path!r} "
            f"(this build reads version {STORE_VERSION})"
        )
    crc = obj.pop("crc32", None)
    want = zlib.crc32(_canonical(obj)) & 0xFFFFFFFF
    if crc != want:
        raise ValueError(
            f"tenant store {path!r} fails its CRC fingerprint "
            f"(stored {crc!r}, computed {want}) — torn write or manual "
            "edit; delete it to start fresh"
        )
    obj.pop("store_version")
    raw_tenants = obj.pop("tenants", {})
    fields = {f.name for f in dataclasses.fields(TenantsState)} - {
        "tenants"}
    unknown = set(obj) - fields
    if unknown:
        raise ValueError(
            f"tenant store {path!r} carries unknown fields "
            f"{sorted(unknown)} (written by a newer version?)"
        )
    rec_fields = {f.name for f in dataclasses.fields(TenantRecord)}
    tenants = {}
    for tid, rec in raw_tenants.items():
        bad = set(rec) - rec_fields
        if bad:
            raise ValueError(
                f"tenant store {path!r}: tenant {tid!r} carries unknown "
                f"fields {sorted(bad)} (written by a newer version?)"
            )
        tenants[tid] = TenantRecord(**rec)
        tenants[tid].validate()
        if tenants[tid].tenant_id != tid:
            raise ValueError(
                f"tenant store {path!r}: key {tid!r} names record "
                f"{tenants[tid].tenant_id!r}"
            )
    st = TenantsState(tenants=tenants, **obj)
    if st.stage not in STAGES:
        raise ValueError(
            f"tenant store {path!r} names unknown stage {st.stage!r}"
        )
    if st.stage != "idle" and not st.inflight:
        raise ValueError(
            f"tenant store {path!r}: stage {st.stage!r} with no "
            "inflight launch record"
        )
    return st


# ------------------------------------------------- fleet checkpointing
def save_fleet_checkpoint(path: str, states, fingerprint: dict) -> None:
    """Atomically persist a fleet's batched carry and its fingerprint.

    `states` is the FleetState a fleet_smo_solve(return_state=True)
    returned: its lane tensors go to the host as numpy arrays, its
    per-lane lists as arrays, its counters as scalars; every value
    round-trips bit for bit (the resume argument). The fault point fires
    before the write, so a kill rule dies with the PREVIOUS checkpoint
    (or none) intact, as a real crash mid-refresh would."""
    from tpusvm_torch.device import to_numpy

    faults.point("tenants.store", path=path, stage="fleet_checkpoint")
    arrays = {name: to_numpy(getattr(states, name))
              for name in states._LANE_TENSORS}
    for name in states._LANE_LISTS:
        arrays[name] = np.asarray(getattr(states, name))
    for name in _COUNTERS:
        arrays[name] = np.asarray(getattr(states, name))
    tmp = path + ".tmp"
    np.savez(tmp, fleet_ckpt_version=FLEET_CKPT_VERSION,
             carry=FLEET_CARRY,
             fingerprint=json.dumps(fingerprint, sort_keys=True),
             **arrays)
    fsync_replace(tmp + ".npz", path)  # np.savez appends .npz


def load_fleet_checkpoint(path: str, fingerprint: dict):
    """Load a fleet carry as a FleetState on the host; refuse a file of
    the other package by name, and (with the differing fields named) any
    checkpoint that does not belong to this exact launch."""
    import torch

    from tpusvm_torch.fleet.solve import FleetState

    with np.load(path, allow_pickle=False) as z:
        if "fleet_ckpt_version" not in z.files:
            raise ValueError(
                f"{path!r} is not a fleet checkpoint "
                "(no fleet_ckpt_version)"
            )
        v = int(z["fleet_ckpt_version"])
        if v != FLEET_CKPT_VERSION:
            raise ValueError(
                f"unsupported fleet checkpoint version {v} (this build "
                f"reads version {FLEET_CKPT_VERSION})"
            )
        carry = str(z["carry"]) if "carry" in z.files else None
        if carry != FLEET_CARRY:
            raise ValueError(
                f"{path!r} is a fleet checkpoint written by the JAX "
                "package (tpusvm: its solver's _OuterState carry, not "
                f"{FLEET_CARRY}); the two packages' fleet trajectories "
                "differ in the last bits, so it cannot resume here bit for "
                "bit — delete it and the launch refits from its seeds"
            )
        saved = json.loads(str(z["fingerprint"]))
        want = json.loads(json.dumps(fingerprint, sort_keys=True))
        if saved != want:
            diff = sorted(
                k for k in set(saved) | set(want)
                if saved.get(k) != want.get(k)
            )
            raise ValueError(
                "fleet checkpoint does not belong to this launch "
                f"(differing fields: {diff}); it was written for "
                f"{ {k: saved.get(k) for k in diff} }, this launch has "
                f"{ {k: want.get(k) for k in diff} }"
            )
        kw = {name: torch.from_numpy(np.array(z[name]))
              for name in FleetState._LANE_TENSORS}
        kw.update({name: z[name].tolist()
                   for name in FleetState._LANE_LISTS})
        kw.update({name: z[name].item() for name in _COUNTERS})
        return FleetState(**kw)
