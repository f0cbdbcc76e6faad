"""Fleet payloads: the one-process export a serve replica answers
``GET /metrics.json`` with.

The port's copy of the payload half of tpusvm/obs/fleet.py:
``{"v": 1, "role": ..., "instance": ..., "pid": ..., "status": {...},
"snapshot": <registry snapshot>}``, byte-compatible with the JAX
package's, so a collector of either package reads a port replica. The
collector, its scrape loop and the `fleet-metrics`/`top` renderers
are ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

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
