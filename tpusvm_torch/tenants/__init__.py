"""tpusvm_torch.tenants: the multi-tenant platform tier.

The port of tpusvm/tenants/: many small tenant models over one shared
corpus, each with its own closed loop, refreshed together:

  store.py     the tenant registry (per-tenant view spec, (C, gamma),
               deployed artifact, drift state) in one crash-safe,
               versioned, CRC-fingerprinted file (the JAX package's
               bytes), and the coalesced refresh's fleet-segment
               checkpoint (the port's own carry)
  views.py     per-tenant (Y, valid) views over ONE shared append-grown
               sharded dataset: X is loaded and scaled once a tick, never
               per tenant
  coalesce.py  the refresh coalescer: the drifted set becomes
               power-of-two fleet_smo_solve launches on the card (the
               problem-axis #1 and #2) with per-tenant warm seeds,
               checkpointed at segment boundaries so a killed supervisor
               resumes the SAME solve bit for bit; odd tenants fall back
               to a solo refresh_fit; provision_tenants is the cold start
  loop.py      the supervisor: per-tenant drift off the autopilot
               detectors, hysteresis and a refresh breaker, a staggered
               swap roll-out through the server

Command line: `python -m tpusvm_torch tenants [--smoke]`. Its chaos gate:
`python -m tpusvm_torch.faults tenant-chaos-smoke` (a kill mid-refresh and
a corrupt tenant artifact under client load: no tenant loses rows, refits
from scratch, or serves a torn generation).
"""

from tpusvm_torch.tenants.coalesce import (
    CoalescePlan,
    checkpointed_fleet_refresh,
    coalesce_drifted,
    provision_tenants,
    refresh_drifted,
)
from tpusvm_torch.tenants.loop import TenantsConfig, TenantsSupervisor
from tpusvm_torch.tenants.store import (
    STORE_VERSION,
    TenantRecord,
    TenantsState,
    is_tenant_store,
    load_fleet_checkpoint,
    load_store,
    save_fleet_checkpoint,
    save_store,
)
from tpusvm_torch.tenants.views import tenant_labels, view_fingerprint

__all__ = [
    "STORE_VERSION",
    "TenantRecord",
    "TenantsState",
    "TenantsConfig",
    "TenantsSupervisor",
    "CoalescePlan",
    "checkpointed_fleet_refresh",
    "coalesce_drifted",
    "provision_tenants",
    "refresh_drifted",
    "is_tenant_store",
    "load_fleet_checkpoint",
    "load_store",
    "save_fleet_checkpoint",
    "save_store",
    "tenant_labels",
    "view_fingerprint",
]
