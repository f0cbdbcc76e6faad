"""Per-tenant (Y, valid) views over ONE shared sharded dataset.

The port's copy of tpusvm/tenants/views.py (pure numpy). The append-grown
corpus (stream/append.py) is the one shared X; a tenant owns no rows, it
owns a VIEW: a label-column mapping (its positive class against the rest)
and optionally a row subset. A view is a pure function of (raw labels,
TenantRecord), so a fleet launch builds per-tenant state as two cheap
arrays a tenant, a (n,) +-1 label vector and an optional (n,) valid mask,
while X is loaded, scaled and put on the card once for the whole bucket.

A row outside the tenant's subset is masked invalid, never given a zero
label on a live row (a live y=0 belongs to neither Keerthi index set and
would silently freeze; fleet/batch.py's packing refuses it).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from tpusvm_torch.tenants.store import TenantRecord

__all__ = ["tenant_labels", "view_fingerprint"]


def tenant_labels(labels: np.ndarray, rec: TenantRecord,
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Materialise one tenant's view: (Y ±1 int32, valid mask or None).

    Y is +1 on rows carrying the tenant's positive label, -1 elsewhere;
    the optional row-subset view (`row_mod`/`row_ofs`) comes back as a
    boolean valid mask (None = all rows live). Raises if the view is
    degenerate — a tenant whose live rows are all one class has no
    binary problem to solve, and silently training it would deadlock
    the working-set selection."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    Y = np.where(labels == rec.positive_label, 1, -1).astype(np.int32)
    valid = None
    if rec.row_mod is not None:
        valid = (np.arange(n) % rec.row_mod) == rec.row_ofs
    live = Y if valid is None else Y[valid]
    if live.size == 0 or (live == 1).all() or (live == -1).all():
        raise ValueError(
            f"tenant {rec.tenant_id!r}: degenerate view — its "
            f"{live.size} live rows carry "
            f"{'only' if live.size else 'no'} "
            f"{'positive' if live.size and (live == 1).all() else 'negative'} "
            f"labels (positive_label={rec.positive_label}, "
            f"row_mod={rec.row_mod}, row_ofs={rec.row_ofs})"
        )
    return Y, valid


def view_fingerprint(Y: np.ndarray,
                     valid: Optional[np.ndarray]) -> int:
    """CRC32 of a materialised view's bytes — the chaos gates' "no
    tenant lost rows" currency: a tenant's view over the recovered
    dataset must fingerprint identically to the uninterrupted
    control's."""
    crc = zlib.crc32(np.ascontiguousarray(Y).tobytes())
    if valid is not None:
        crc = zlib.crc32(np.ascontiguousarray(valid).tobytes(), crc)
    return crc & 0xFFFFFFFF
