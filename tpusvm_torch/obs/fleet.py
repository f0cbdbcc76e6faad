"""Fleet payloads: the one-process export a serve replica answers
``GET /metrics.json`` with, and a process without an HTTP listener (the
autopilot) drops on disk.

The port's copy of the payload half of tpusvm/obs/fleet.py:
``{"v": 1, "role": ..., "instance": ..., "pid": ..., "status": {...},
"snapshot": <registry snapshot>}``, byte-compatible with the JAX
package's, so a collector of either package reads a port replica or a
port autopilot's file. The collector, its scrape loop and the
`fleet-metrics`/`top` renderers are ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from tpusvm_torch.obs.registry import SNAPSHOT_VERSION

FLEET_SCHEMA_VERSION = 1


def snapshot_payload(role: str, instance: str, snapshot: dict,
                     status: Optional[dict] = None,
                     pid: Optional[int] = None) -> dict:
    """The one-process export every fleet source speaks."""
    if snapshot.get("v") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported metrics snapshot version {snapshot.get('v')!r}")
    return {"v": FLEET_SCHEMA_VERSION, "role": role, "instance": instance,
            "pid": os.getpid() if pid is None else int(pid),
            "status": status or {}, "snapshot": snapshot}


def parse_payload(obj: Any) -> dict:
    """Validate a fleet payload read off the wire or disk; ValueError on
    junk or an unknown schema version."""
    if not isinstance(obj, dict) or obj.get("v") != FLEET_SCHEMA_VERSION:
        v = obj.get("v") if isinstance(obj, dict) else None
        raise ValueError(
            f"not a fleet snapshot payload (v={v!r}, this build reads "
            f"v{FLEET_SCHEMA_VERSION})")
    for k in ("role", "instance", "snapshot"):
        if k not in obj:
            raise ValueError(f"fleet payload missing {k!r}")
    return obj


def write_snapshot_file(path: str, payload: dict) -> None:
    """Publish a payload for a process with no HTTP listener (the
    autopilot): a staged write beside the target and fsync_replace, so a
    reader never sees a torn file and a crash mid-write leaves the
    previous drop."""
    from tpusvm_torch.utils.durable import fsync_replace

    parse_payload(payload)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, sort_keys=True))
        f.flush()
    fsync_replace(tmp, path)


def read_snapshot_file(path: str) -> dict:
    with open(path) as f:
        return parse_payload(json.load(f))
