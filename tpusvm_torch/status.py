"""Solver termination, shard integrity, tuning, serving, closed-loop and
routing status codes.

The port's own copies of the JAX package's ``Status``, ``StreamStatus``,
``TuneStatus``, ``ServeStatus``, ``AutopilotStatus``, ``RouterStatus`` and
``TenantsStatus`` enums, with the same integer values, so a status read
from one package compares equal to the other's.

  CONVERGED       b_low <= b_high + 2*tau
  NO_WORKING_SET  I_high or I_low is empty
  INFEASIBLE_UV   the pair's box [U, V] is empty (U > V + 1e-12)
  NONPOS_ETA      eta <= eps for the selected pair
  MAX_ITER        the update or outer-round budget ran out
  STALLED         the selected pair's update rounded to exactly zero
"""

import enum


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    NO_WORKING_SET = 2
    INFEASIBLE_UV = 3
    NONPOS_ETA = 4
    MAX_ITER = 5
    STALLED = 6


class StreamStatus(enum.IntEnum):
    """Per-shard integrity codes of a sharded dataset (stream/format.py:
    ShardedDataset.validate re-derives each shard's manifest claims from
    its bytes):

      OK                  the bytes match the manifest's claims
      MISSING_FILE        the shard file named by the manifest is absent
      CHECKSUM_MISMATCH   the content hash differs, or the bytes do not
                          parse as an npz
      ROW_COUNT_MISMATCH  the arrays disagree with the manifest's n_rows
                          or n_features
      STATS_MISMATCH      per-shard min/max or class counts do not
                          re-derive from the rows
      READ_FAILED         the shard could not be read within the reader's
                          retry budget (faults/retry.py)
    """

    OK = 0
    MISSING_FILE = 1
    CHECKSUM_MISMATCH = 2
    ROW_COUNT_MISMATCH = 3
    STATS_MISMATCH = 4
    READ_FAILED = 5


class TuneStatus(enum.IntEnum):
    """Per-grid-point outcome codes of the hyperparameter search
    (tune/search.py), the JAX package's values:

      EVALUATED  fit and scored on every fold at the FINAL rung (grid
                 schedule: all points; halving: the last survivors; the
                 winner is always one of these)
      PRUNED     successive halving dropped it after a smaller-rung
                 evaluation; its recorded metrics are from that rung
      SKIPPED    plateau early-stopping ended the sweep before this point
                 was ever fit; no metrics recorded
    """

    EVALUATED = 0
    PRUNED = 1
    SKIPPED = 2


class ServeStatus(enum.IntEnum):
    """Per-request outcome codes of the serving path (serve/): the
    frontend never raises for load-induced conditions, a request comes
    back with a code the caller and the metrics can branch on.

      OK          scored; the result carries scores and label
      TIMEOUT     missed its deadline (client wait or queue residency)
      QUEUE_FULL  fast-failed by backpressure; never entered the queue
      ERROR       the scoring path raised (bad input is refused before
                  the queue with ValueError instead: a caller bug)
      SHUTDOWN    the server closed while the request was in flight
      OVERLOADED  shed by the load-shedding threshold or the SLO
                  admission gate: "come back later", told apart from the
                  hard QUEUE_FULL bound
      UNAVAILABLE the model's circuit breaker is OPEN (consecutive scoring
                  failures tripped it); requests fail fast until a
                  half-open probe recovers the model (faults/breaker.py)
      DRAINING    the server is draining (Server.drain()): in-flight
                  requests complete, new ones are refused
      LOAD_FAILED a model artifact could not be loaded or staged
                  (missing, truncated or corrupted .npz, or transient
                  I/O past the retry budget), carried by
                  serve.ModelLoadError; a failed hot-swap stage rolls
                  back and the previous generation keeps serving
    """

    OK = 0
    TIMEOUT = 1
    QUEUE_FULL = 2
    ERROR = 3
    SHUTDOWN = 4
    OVERLOADED = 5
    UNAVAILABLE = 6
    DRAINING = 7
    LOAD_FAILED = 8


class AutopilotStatus(enum.IntEnum):
    """Per-tick outcome codes of the closed-loop supervisor (autopilot/):
    every tick ends in exactly one of these, so why the autopilot did or
    did not retrain is an explicit code.

      WATCHING             no detector triggered; nothing to do
      TRIGGERED_HYSTERESIS a detector triggered on fewer than `hysteresis`
                           consecutive ticks (a noisy detector cannot
                           thrash retrains)
      SUPPRESSED_COOLDOWN  triggered, but the post-refresh cooldown has
                           not elapsed
      SUPPRESSED_BREAKER   triggered, but the refresh circuit breaker is
                           OPEN (repeated refresh failures tripped it):
                           watch-only instead of hot-looping a poisoned
                           batch
      REFRESHED            refresh fit, save and swap all succeeded; the
                           new generation is live
      REFRESH_FAILED       the refresh stage raised (fit error, swap
                           rollback, injected fault); counted by the
                           breaker, retried on a later tick
      REFRESH_TIMEOUT      the watchdog deadline stopped the fit at a
                           checkpointed segment boundary; the next
                           eligible tick resumes it from its checkpoint
    """

    WATCHING = 0
    TRIGGERED_HYSTERESIS = 1
    SUPPRESSED_COOLDOWN = 2
    SUPPRESSED_BREAKER = 3
    REFRESHED = 4
    REFRESH_FAILED = 5
    REFRESH_TIMEOUT = 6


class RouterStatus(enum.IntEnum):
    """Fleet-level outcome codes of the routing tier (router/), reported
    on the router's /healthz and by its rollout driver:

      OK          replicas are admissible and rollouts are skew-free
      NO_REPLICA  placement produced no candidate at all: the replica set
                  is empty, or no member was ever polled healthy; nothing
                  was forwarded
      ALL_DOWN    candidates existed but every one was down, draining or
                  failed the forward
      SKEW_HOLD   a staggered rollout's generation vector spread beyond
                  the skew window; no further swap is issued until the
                  laggard is resolved (router/rollout.py)
    """

    OK = 0
    NO_REPLICA = 1
    ALL_DOWN = 2
    SKEW_HOLD = 3


class TenantsStatus(enum.IntEnum):
    """Per-tick outcome codes of the multi-tenant supervisor (tenants/):
    what one tick did with the currently drifted tenant set.

      WATCHING            no tenant's detectors triggered past its
                          hysteresis; nothing refreshed
      TRIGGERED_HYSTERESIS a tenant triggered, but none on `hysteresis`
                          consecutive ticks yet
      SUPPRESSED_BREAKER  drifted tenants exist but the fleet refresh
                          circuit breaker is OPEN; watch-only
      REFRESHED           the drifted set was coalesced into fleet
                          launches (and solo fallbacks), every artifact
                          saved and its swap rolled out
      PARTIAL             the launches finished but at least one tenant's
                          save or swap failed: its previous generation
                          keeps serving and it stays drift-armed
      REFRESH_FAILED      the refresh stage raised before any tenant
                          completed; breaker-counted, retried on a later
                          tick, where an in-flight fleet checkpoint
                          resumes bit for bit
    """

    WATCHING = 0
    TRIGGERED_HYSTERESIS = 1
    SUPPRESSED_BREAKER = 2
    REFRESHED = 3
    PARTIAL = 4
    REFRESH_FAILED = 5
