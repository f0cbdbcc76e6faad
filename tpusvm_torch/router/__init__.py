"""tpusvm_torch.router: the multi-replica serving fabric (routing tier).

The port of tpusvm/router/, with its names: a stdlib-HTTP front door over
N `python -m tpusvm_torch serve` replica processes, each scoring on the
card. It is host logic and launches no kernel itself.

  placement.py  rendezvous (HRW) hashing: model name -> replica set with a
                replication factor; stable under join/leave, placement
                tables byte-identical to the JAX package's per seed; the
                torn-free ReplicaSet membership view
  health.py     the /healthz poller feeding a per-replica state machine
                (ok / degraded / draining / down) with burn-aware
                admission
  rollout.py    generation-skew detection for staggered hot-swap
                rollouts: skew beyond the window holds the rollout
  proxy.py      the threaded HTTP front door (`router`): placed forward,
                failover on connection failure/503 under Retry, 429 kept
                with its Retry-After, the trace header minted under a
                router.forward span, /fleet/metrics over every replica

Chaos gate: `python -m tpusvm_torch.faults router-chaos-smoke`.
"""

from tpusvm_torch.router.health import (
    REPLICA_STATES,
    STATE_CODES,
    HealthPoller,
    ReplicaHealth,
)
from tpusvm_torch.router.placement import (
    ReplicaSet,
    hrw_score,
    place,
    placement_table,
    table_bytes,
)
from tpusvm_torch.router.proxy import Router, RouterConfig, make_router_http
from tpusvm_torch.router.rollout import (
    SkewReport,
    check_skew,
    generation_vector,
    skew_of,
    staggered_rollout,
)

__all__ = [
    "HealthPoller",
    "REPLICA_STATES",
    "ReplicaHealth",
    "ReplicaSet",
    "Router",
    "RouterConfig",
    "STATE_CODES",
    "SkewReport",
    "check_skew",
    "generation_vector",
    "hrw_score",
    "make_router_http",
    "place",
    "placement_table",
    "skew_of",
    "staggered_rollout",
    "table_bytes",
]
