"""Crash-safe appends: reopen a committed dataset and grow its tail.

The port's copy of tpusvm/stream/append.py, the stream-side half of the
closed loop: micro-batches arrive continuously and must land durably in
the dataset a refresh or the autopilot reads, exactly once under a kill
at any instant. `AppendWriter` (reached as `ShardWriter.open_append(dir)`)
reopens a committed dataset directory and appends blocks to it so that
the grown dataset is bit for bit a one-shot ingest of the concatenated
data (shard boundaries, per-shard stats, checksums, manifest JSON):

  * the manifest's existing shard table is adopted as it is, so the
    merged feature min/max is the exact merge of the old and the new
    stats (a rewriter that refit the range from the tail alone would
    lose the old rows' extremes);
  * a short trailing shard is adopted into the pending buffer and re-cut
    at rows_per_shard boundaries as a one-shot ingest would have cut it,
    which also keeps the global row order a strict prefix extension (the
    contract tune.warm.deployed_seed and stream.assign hold by name);
  * every session shard is staged under `<name>.npz.stage` and renamed
    into place only at commit, so the files a reader's manifest names are
    never touched mid-session.

Exactly once under a kill: the ingest journal (the same
`ingest.journal.json`, `journal_version` 2, mode "append", the JAX
package's layout) records after every durable flush the session shard
table (the durable high-water row) and a per-batch content CRC ledger. A
resumed session (`open_append(dir, resume=True)`) verifies every
journaled shard against its checksum, re-derives the high-water mark, and
the caller replays the same batch stream: rows at or below the mark are
skipped (their CRCs verified again; a divergent replay is an
`AppendError`), the batch across the mark is split, the rest appended.
A session started by either package resumes in the other with the same
bytes.

Fault points: ``stream.append`` fires at every journal write and at the
commit's two transitions; the staged shard bytes go through the
``ingest.write_shard`` point (corrupt rules apply there).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional

import numpy as np

from tpusvm_torch import faults
from tpusvm_torch.status import StreamStatus
from tpusvm_torch.stream.format import (
    DEFAULT_ROWS_PER_SHARD,
    MANIFEST_NAME,
    Manifest,
    ShardError,
    ShardInfo,
    ShardWriter,
    _UNREADABLE,
    shard_checksum,
)
from tpusvm_torch.utils.durable import fsync_replace

APPEND_JOURNAL_VERSION = 2


class AppendError(ValueError):
    """An append session cannot proceed safely (a divergent replay,
    changed settings, a dataset modified under the journal)."""


def batch_crc(X: np.ndarray, Y: np.ndarray) -> int:
    """Content CRC of one appended micro-batch (shape header and rows),
    over the canonical dtypes, so a replay from any source that converts
    the same way verifies the same way."""
    X = np.ascontiguousarray(X, np.float64)
    Y = np.ascontiguousarray(Y, np.int32)
    c = zlib.crc32(f"{X.shape[0]},{X.shape[1]}".encode())
    c = zlib.crc32(X.tobytes(), c)
    return zlib.crc32(Y.tobytes(), c) & 0xFFFFFFFF


class AppendWriter(ShardWriter):
    """ShardWriter over an existing committed dataset directory.

    One session, batches of any size:

        w = ShardWriter.open_append(dir)        # or resume=True
        for X, Y in micro_batches:              # replayed from the
            w.append(X, Y)                      #   session start on resume
        manifest = w.close()                    # atomic commit

    The module docstring states the crash-safety contract.
    """

    def __init__(self, out_dir: str,
                 rows_per_shard: Optional[int] = None,
                 resume: bool = False):
        manifest_path = os.path.join(out_dir, MANIFEST_NAME)
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"{out_dir!r} is not a committed sharded dataset (no "
                f"{MANIFEST_NAME}); append reopens an existing dataset — "
                "create one with `python -m tpusvm_torch ingest` first"
            )
        with open(manifest_path) as f:
            base = Manifest.from_json(json.load(f))
        rps = self._resolve_rows_per_shard(base, rows_per_shard)
        super().__init__(out_dir, rows_per_shard=rps, binary=base.binary,
                         positive_label=base.positive_label, resume=False)
        self._base_manifest = base
        self._n_features = base.n_features
        # a short trailing shard is adopted into the pending buffer: its
        # rows are re-cut with the new data as a one-shot ingest of the
        # concatenation would cut them
        tail = base.shards[-1]
        if tail.n_rows < rps:
            keep = base.shards[:-1]
            self._tail_info: Optional[ShardInfo] = tail
            self._tail_adopted = tail.n_rows
        else:
            keep = list(base.shards)
            self._tail_info = None
            self._tail_adopted = 0
        self._shards = list(keep)
        self._row_start = sum(s.n_rows for s in keep)
        self._session_start = len(keep)
        # the per-batch exactly-once ledger (seq -> record); _new_skip is
        # the durable high-water mark in new-row coordinates
        self._batches: Dict[int, dict] = {}
        self._batch_seq = 0
        self._rows_seen = 0
        self._new_skip = 0
        self._already_committed = False
        self._append_retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                          op="stream.append")
        if resume:
            self._resume_session()
        elif os.path.exists(self._journal_path()):
            raise AppendError(
                f"{out_dir!r} has an append journal from a crashed "
                "session; reopen with resume=True and replay the same "
                "batch stream (or delete the journal to abandon it)"
            )
        if self._tail_info is not None and not self._already_committed \
                and self._tail_covered < self._tail_adopted:
            self._adopt_tail_rows()

    # ----------------------------------------------------------- opening
    @staticmethod
    def _resolve_rows_per_shard(base: Manifest,
                                rows_per_shard: Optional[int]) -> int:
        sizes = [s.n_rows for s in base.shards]
        if rows_per_shard is None:
            if len(sizes) > 1:
                rows_per_shard = sizes[0]
            else:
                # one (possibly short) shard does not determine the
                # original cut; the library default matches a default
                # one-shot ingest
                rows_per_shard = max(DEFAULT_ROWS_PER_SHARD, sizes[0])
        bad = [i for i, n in enumerate(sizes[:-1]) if n != rows_per_shard]
        if bad or sizes[-1] > rows_per_shard:
            raise AppendError(
                f"rows_per_shard={rows_per_shard} does not match the "
                f"dataset's shard layout (shard sizes {sizes}); pass the "
                "value the dataset was ingested with"
            )
        return rows_per_shard

    def _adopt_tail_rows(self) -> None:
        info = self._tail_info
        path = os.path.join(self.out_dir, info.filename)
        try:
            with np.load(path, allow_pickle=False) as z:
                X, Y = z["X"], z["Y"]
        except _UNREADABLE as e:
            raise ShardError(info.filename, StreamStatus.MISSING_FILE,
                             f"tail shard unreadable on append: {e}") from e
        if shard_checksum(X, Y) != info.sha256:
            raise ShardError(info.filename, StreamStatus.CHECKSUM_MISMATCH,
                             "tail shard fails its checksum on append")
        skip = min(len(X), self._tail_covered)
        if skip < len(X):
            self._pending.append((X[skip:], Y[skip:]))
            self._pending_rows += len(X) - skip

    @property
    def _tail_covered(self) -> int:
        """Adopted tail rows already inside durable session shards."""
        flushed = sum(s.n_rows for s in self._shards[self._session_start:])
        return min(self._tail_adopted, flushed)

    # ----------------------------------------------------------- journal
    def _write_journal(self) -> None:
        """The v2 append journal (durable session shard table and the
        batch CRC ledger), written atomically after every flush under the
        shared I/O retry: a transient re-runs the whole write, a kill
        leaves the previous journal, and the shard it described, intact."""
        self._append_retry(self._write_journal_once)

    def _write_journal_once(self) -> None:
        faults.point("stream.append",
                     shards=len(self._shards) - self._session_start)
        obj = {
            "journal_version": APPEND_JOURNAL_VERSION,
            "mode": "append",
            "rows_per_shard": self.rows_per_shard,
            "binary": self.binary,
            "positive_label": self.positive_label,
            "n_features": self._n_features,
            "base_shards": self._session_start,
            "base_manifest_rows": self._base_manifest.n_rows,
            "tail_adopted": self._tail_adopted,
            "tail_filename": (self._tail_info.filename
                              if self._tail_info is not None else None),
            "shards": [s.to_json()
                       for s in self._shards[self._session_start:]],
            "batches": [self._batches[k] for k in sorted(self._batches)],
        }
        tmp = self._journal_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        fsync_replace(tmp, self._journal_path())

    def _load_append_journal(self) -> Optional[dict]:
        jp = self._journal_path()
        if not os.path.exists(jp):
            return None
        with open(jp) as f:
            obj = json.load(f)
        v = obj.get("journal_version")
        if v != APPEND_JOURNAL_VERSION or obj.get("mode") != "append":
            raise AppendError(
                f"{jp!r} is not an append-session journal "
                f"(journal_version {v!r}, mode {obj.get('mode')!r}); a "
                "v1 journal belongs to a crashed fresh ingest — resume "
                "it with `python -m tpusvm_torch ingest --resume` instead"
            )
        for key, have in (("rows_per_shard", self.rows_per_shard),
                          ("binary", self.binary),
                          ("positive_label", self.positive_label),
                          ("n_features", self._n_features)):
            if obj[key] != have:
                raise AppendError(
                    f"append journal was written with {key}={obj[key]!r}, "
                    f"this resume passes {have!r}; reopen with the "
                    "original settings"
                )
        return obj

    def _resume_session(self) -> None:
        obj = self._load_append_journal()
        if obj is None:
            return  # nothing to resume: a fresh session
        session = [ShardInfo.from_json(s) for s in obj["shards"]]
        if obj["base_shards"] != self._session_start \
                or obj["tail_adopted"] != self._tail_adopted:
            # the manifest on disk no longer matches the journal's view of
            # the base dataset: the session already committed (manifest
            # replaced, the journal's delete lost to the kill), or the
            # dataset was changed under the journal
            if self._is_committed_session(obj, session):
                self._finish_committed(obj, session)
                return
            raise AppendError(
                f"dataset {self.out_dir!r} changed under the append "
                f"journal (journal saw {obj['base_shards']} base shards / "
                f"{obj['base_manifest_rows']} rows, manifest now has "
                f"{len(self._base_manifest.shards)} shards / "
                f"{self._base_manifest.n_rows} rows)"
            )
        for info in session:
            self._verify_session_shard(info)
        self._shards.extend(session)
        self._row_start += sum(s.n_rows for s in session)
        flushed = sum(s.n_rows for s in session)
        self._new_skip = max(0, flushed - self._tail_adopted)
        self._batches = {int(b["seq"]): b for b in obj["batches"]}

    def _verify_session_shard(self, info: ShardInfo) -> None:
        """A journaled session shard must exist (staged, or final after a
        crashed commit) and match its checksum."""
        for suffix in (".stage", ""):
            path = os.path.join(self.out_dir, info.filename + suffix)
            if not os.path.exists(path):
                continue
            try:
                with np.load(path, allow_pickle=False) as z:
                    X, Y = z["X"], z["Y"]
            except _UNREADABLE as e:
                raise ShardError(
                    info.filename, StreamStatus.CHECKSUM_MISMATCH,
                    f"journaled append shard unreadable on resume: {e}"
                ) from e
            if shard_checksum(X, Y) != info.sha256:
                raise ShardError(info.filename,
                                 StreamStatus.CHECKSUM_MISMATCH,
                                 "journaled append shard fails its "
                                 "checksum on resume")
            return
        raise ShardError(info.filename, StreamStatus.MISSING_FILE,
                         "journaled append shard lost before resume")

    def _is_committed_session(self, obj: dict,
                              session: List[ShardInfo]) -> bool:
        """True when the current manifest already carries the journaled
        session: its rows are the journal's base rows, less the adopted
        tail (re-cut into the session shards), plus every session shard,
        and each session shard stands in the manifest under its journaled
        name and checksum."""
        m = self._base_manifest
        expected = (obj["base_manifest_rows"] - obj["tail_adopted"]
                    + sum(s.n_rows for s in session))
        by_name = {s.filename: s.sha256 for s in m.shards}
        return (bool(session) and m.n_rows == expected
                and all(by_name.get(s.filename) == s.sha256
                        for s in session))

    def _finish_committed(self, obj: dict,
                          session: List[ShardInfo]) -> None:
        """The manifest already carries the whole session (the kill landed
        between the manifest write and the journal delete): everything is
        durable, the replay skips every row, and close() deletes the
        journal again."""
        self._already_committed = True
        self._shards = list(self._base_manifest.shards)
        self._session_start = len(self._shards)
        self._row_start = self._base_manifest.n_rows
        self._tail_adopted = 0
        self._tail_info = None
        flushed = sum(s.n_rows for s in session)
        self._new_skip = max(0, flushed - int(obj["tail_adopted"]))
        self._batches = {int(b["seq"]): b for b in obj["batches"]}

    # ------------------------------------------------------------ append
    def _write_shard_atomic(self, filename: str, X: np.ndarray,
                            Y: np.ndarray) -> None:
        # session shards stage under <name>.stage: the files the committed
        # manifest names are never touched mid-session
        super()._write_shard_atomic(filename + ".stage", X, Y)

    def append(self, X: np.ndarray, Y: np.ndarray) -> None:
        """Append one micro-batch. A resumed session replays the same
        batch stream from the session start: durable rows are skipped
        (CRC-verified against the journal's ledger), the batch across the
        high-water mark is split, the rest appended."""
        X = np.ascontiguousarray(X, np.float64)
        Y = np.ascontiguousarray(Y, np.int32)
        if X.ndim != 2 or Y.ndim != 1 or len(X) != len(Y):
            raise ValueError(
                f"append expects (n, d) X and (n,) Y, got {X.shape} / "
                f"{Y.shape}"
            )
        if X.shape[1] != self._n_features:
            raise ValueError(
                f"append feature count {X.shape[1]} != dataset's "
                f"{self._n_features}"
            )
        seq = self._batch_seq
        rec = {"seq": seq, "row_start": self._rows_seen,
               "n_rows": int(len(X)), "crc32": batch_crc(X, Y)}
        old = self._batches.get(seq)
        if old is not None and old != rec:
            raise AppendError(
                f"replayed batch {seq} differs from the journaled append "
                f"(journal {old}, replay {rec}) — duplicate or divergent "
                "append rejected; replay the original session's batch "
                "stream in order"
            )
        self._batches[seq] = rec
        self._batch_seq += 1
        span_start = self._rows_seen
        self._rows_seen += len(X)
        skip = min(len(X), max(0, self._new_skip - span_start))
        super().append(X[skip:], Y[skip:])

    # ------------------------------------------------------------- close
    def close(self) -> Manifest:
        if self._closed:
            return self.manifest
        self._closed = True
        if self._pending_rows:
            self._flush_shard(self._pending_rows)
        session = self._shards[self._session_start:]
        jp = self._journal_path()
        if not session:
            # nothing appended and no tail adopted: the dataset is its
            # manifest already
            self.manifest = self._base_manifest
            if os.path.exists(jp):
                os.remove(jp)
            return self.manifest

        # the commit, under the shared I/O retry: every step is idempotent
        # (a stage already renamed is skipped, the manifest write replaces
        # like for like, the journal delete tolerates absence); a death in
        # here is recovered by the resume path
        def _commit():
            faults.point("stream.append", commit=True)
            for info in session:
                staged = os.path.join(self.out_dir,
                                      info.filename + ".stage")
                if os.path.exists(staged):
                    fsync_replace(staged,
                                  os.path.join(self.out_dir, info.filename))
            manifest = Manifest(
                n_rows=self._row_start,
                n_features=int(self._n_features),
                shards=self._shards,
                binary=self.binary,
                positive_label=self.positive_label,
            )
            tmp = os.path.join(self.out_dir, MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest.to_json(), f, indent=1)
                f.write("\n")
            fsync_replace(tmp, os.path.join(self.out_dir, MANIFEST_NAME))
            # the manifest is durable and the journal not yet removed: a
            # kill here is the resume path's already-committed case
            faults.point("stream.append", committed=True)
            if os.path.exists(jp):
                os.remove(jp)
            return manifest

        self.manifest = self._append_retry(_commit)
        return self.manifest


def append_blocks(out_dir: str,
                  blocks,
                  rows_per_shard: Optional[int] = None,
                  resume: bool = False) -> Manifest:
    """Append an (X, Y)-block iterator to a committed dataset (the append
    core, as `ingest_blocks` is ingest's). On resume the source must
    replay the same blocks in the same order."""
    w = AppendWriter(out_dir, rows_per_shard=rows_per_shard, resume=resume)
    for X, Y in blocks:
        w.append(X, Y)
    return w.close()
