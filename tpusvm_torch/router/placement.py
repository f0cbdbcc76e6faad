"""Deterministic rendezvous (HRW) placement: model name -> replica set.

The port's copy of tpusvm/router/placement.py. Rendezvous ("highest
random weight") hashing gives the router consistent placement with no
coordination state: every (key, replica) pair gets a seeded 64-bit
score, and a key lives on its k highest-scoring replicas. So

  * a LEAVE re-maps only the keys whose placement included the leaver;
  * a JOIN steals each rank-slot with probability 1/(N+1), so roughly 1/N
    of keys move and nothing else does;
  * the score is blake2b over the same bytes the JAX package hashes, in
    the same order (the seed and the pair's names, no process salt), so
    `table_bytes` of the same (keys, replicas, k, seed) is byte-identical
    across processes and across the two packages.

ReplicaSet is the membership object the proxy reads on its hot path:
join/leave publish IMMUTABLE `_View` snapshots (version and replica tuple
built under the lock, installed with one reference store), so a
forwarding thread reads placement without the lock and never sees a
half-updated member list.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple


def hrw_score(key: str, replica: str, seed: int = 0) -> int:
    """Seeded 64-bit rendezvous weight of placing `key` on `replica`.

    blake2b keyed by the (seed, replica, key) triple: platform-stable
    bytes in, platform-stable integer out. The lengths are mixed in so
    ("ab","c") and ("a","bc") cannot collide."""
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{int(seed)}:{len(replica)}:{replica}:{key}".encode())
    return int.from_bytes(h.digest(), "big")


def place(key: str, replicas: Sequence[str], k: int = 1,
          seed: int = 0) -> Tuple[str, ...]:
    """The k highest-weight replicas for `key`, highest first.

    Deterministic total order: ties (astronomically unlikely) break on
    the replica name so the table stays byte-reproducible. Fewer than k
    replicas means everything hosts the key."""
    if k < 1:
        raise ValueError(f"replication factor must be >= 1, got {k}")
    ranked = sorted(replicas,
                    key=lambda r: (-hrw_score(key, r, seed), r))
    return tuple(ranked[:k])


def placement_table(keys: Iterable[str], replicas: Sequence[str],
                    k: int = 1, seed: int = 0) -> Dict[str, Tuple[str, ...]]:
    """Full key -> placed-replicas map (the auditable placement table)."""
    return {key: place(key, replicas, k=k, seed=seed) for key in keys}


def table_bytes(table: Dict[str, Tuple[str, ...]]) -> bytes:
    """Canonical byte serialization of a placement table.

    Sorted keys, no whitespace: two routers with the same (keys,
    replicas, k, seed) produce identical bytes, which router-chaos-smoke
    asserts."""
    return json.dumps({k: list(v) for k, v in table.items()},
                      sort_keys=True, separators=(",", ":")).encode()


class _View:
    """One immutable membership snapshot: the unit ReplicaSet publishes.

    A reader holds exactly one _View for the duration of a placement
    decision, so version and replicas always agree (the single-bundle
    discipline of serve's `_Generation`)."""

    __slots__ = ("version", "replicas")

    def __init__(self, version: int, replicas: Tuple[str, ...]):
        self.version = version
        self.replicas = replicas


class ReplicaSet:
    """Replica membership with lock-free torn-proof reads.

    join/leave build a fresh _View under the lock and install it with a
    single reference store; `view()` is one GIL-atomic read, so the
    forwarding hot path never takes the membership lock and never sees
    a half-updated member list. Placement parameters (replication
    factor, seed) are fixed at construction — they are part of the
    fleet's identity, not runtime state.

    `listener`, when set, is called with the NEW view under the lock
    BEFORE it is published, so a log appended by the listener is the
    true serialized flip order and any published view is already logged.
    """

    def __init__(self, replicas: Sequence[str] = (), k: int = 1,
                 seed: int = 0,
                 listener: Optional[Callable[["_View"], None]] = None):
        if k < 1:
            raise ValueError(f"replication factor must be >= 1, got {k}")
        self.k = int(k)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._listener = listener
        first = _View(1, tuple(sorted(dict.fromkeys(replicas))))
        if listener is not None:
            listener(first)
        self._view = first

    # -------------------------------------------------------------- reads
    def view(self) -> _View:
        """The current immutable membership snapshot (lock-free)."""
        return self._view

    def replicas(self) -> Tuple[str, ...]:
        return self._view.replicas

    @property
    def version(self) -> int:
        return self._view.version

    def placement(self, key: str) -> Tuple[str, ...]:
        """Placed replicas for `key` from ONE view (never torn)."""
        v = self._view
        if not v.replicas:
            return ()
        return place(key, v.replicas, k=self.k, seed=self.seed)

    def table(self, keys: Iterable[str]) -> Dict[str, Tuple[str, ...]]:
        v = self._view
        return placement_table(keys, v.replicas, k=self.k, seed=self.seed)

    # ------------------------------------------------------------- writes
    def _install(self, replicas: Tuple[str, ...]) -> _View:
        # caller holds self._lock
        nxt = _View(self._view.version + 1, replicas)
        if self._listener is not None:
            self._listener(nxt)  # logged BEFORE publication (see class doc)
        self._view = nxt
        return nxt

    def join(self, replica: str) -> bool:
        """Add a replica; False when already a member (no version tick)."""
        with self._lock:
            cur = self._view.replicas
            if replica in cur:
                return False
            self._install(tuple(sorted(cur + (replica,))))
            return True

    def leave(self, replica: str) -> bool:
        """Remove a replica; False when not a member (no version tick)."""
        with self._lock:
            cur = self._view.replicas
            if replica not in cur:
                return False
            self._install(tuple(r for r in cur if r != replica))
            return True
