"""Versioned sharded on-disk dataset format, the JAX package's.

The port's copy of tpusvm/stream/format.py. A dataset is a directory of
packed .npz shards plus one JSON manifest:

    dataset/
      manifest.json        format version, global shape, per-shard metadata
      shard-00000.npz      arrays "X" (n_i, d) float64, "Y" (n_i,) int32
      shard-00001.npz      ...

The manifest records per shard: filename, row count, global row offset
(global row order is the concatenation of shards in manifest order),
feature min/max, class counts (stream/stats.py) and a content checksum
(sha256 over a shape/dtype header and the array bytes, independent of the
npz container). The same keys in the same order, the same JSON layout
(`json.dump(..., indent=1)` and a newline) and the same checksums as the
JAX package: a dataset written by either package opens, validates and
reads in the other.

Writing goes through ShardWriter, which buffers appended blocks and cuts
shards of exactly rows_per_shard rows (the last one short), so ingest
holds one shard at most. Every shard write is atomic, retried under
faults.DEFAULT_IO_POLICY behind the ``ingest.write_shard`` fault point,
and journaled (``stream.journal``), so a killed ingest resumes from its
last durable shard. `ingest_csv` streams a CSV through
data.read_csv_blocks; `ingest_arrays` shards an in-memory array;
`ShardWriter.open_append` grows a committed dataset (stream/append.py).

A manifest without format_version, or with an unknown one, is refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import zipfile
import zlib
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from tpusvm_torch import faults
from tpusvm_torch.data.csv_reader import read_csv_blocks
from tpusvm_torch.status import StreamStatus
from tpusvm_torch.stream.stats import (
    ShardStats,
    compute_stats,
    merge_stats,
    scaler_from_stats,
)
from tpusvm_torch.utils.durable import fsync_replace

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
JOURNAL_NAME = "ingest.journal.json"
JOURNAL_VERSION = 1
DEFAULT_ROWS_PER_SHARD = 65536

# np.load failure modes on damaged bytes: BadZipFile/zlib.error escape the
# (OSError, ValueError, KeyError) net, and a truncated or bit-flipped npz
# must surface as a ShardError, not a raw traceback from the prefetch thread
_UNREADABLE = (OSError, ValueError, KeyError, EOFError,
               zipfile.BadZipFile, zlib.error)


class ShardError(ValueError):
    """A shard failed to load or verify; names the shard and carries the
    StreamStatus so callers branch on codes, not string matching.

    A ValueError subclass, as in the JAX package, so callers that catch
    ValueError keep working while gaining .filename/.status."""

    def __init__(self, filename: str, status: StreamStatus,
                 detail: str = ""):
        self.filename = filename
        self.status = StreamStatus(status)
        msg = f"shard {filename}: {self.status.name}"
        if detail:
            msg += f" ({detail})"
        msg += " — re-ingest or restore the file"
        super().__init__(msg)


def shard_checksum(X: np.ndarray, Y: np.ndarray) -> str:
    """sha256 over shape/dtype header + row bytes (container-independent)."""
    h = hashlib.sha256()
    h.update(f"{X.shape[0]},{X.shape[1]},{X.dtype},{Y.dtype}".encode())
    h.update(np.ascontiguousarray(X).tobytes())
    h.update(np.ascontiguousarray(Y).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class ShardInfo:
    """One shard's manifest entry."""

    filename: str
    row_start: int
    stats: ShardStats
    sha256: str

    @property
    def n_rows(self) -> int:
        return self.stats.n_rows

    def to_json(self) -> dict:
        return {
            "filename": self.filename,
            "row_start": int(self.row_start),
            "sha256": self.sha256,
            **self.stats.to_json(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ShardInfo":
        return cls(
            filename=str(obj["filename"]),
            row_start=int(obj["row_start"]),
            stats=ShardStats.from_json(obj),
            sha256=str(obj["sha256"]),
        )


@dataclasses.dataclass
class Manifest:
    """The dataset-level metadata: shape, label convention, shard table."""

    n_rows: int
    n_features: int
    shards: List[ShardInfo]
    binary: bool = True
    positive_label: Optional[int] = None  # set when binary ingest remapped

    def global_stats(self) -> ShardStats:
        return merge_stats([s.stats for s in self.shards])

    def to_json(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "n_rows": int(self.n_rows),
            "n_features": int(self.n_features),
            "binary": bool(self.binary),
            "positive_label": self.positive_label,
            "shards": [s.to_json() for s in self.shards],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Manifest":
        if "format_version" not in obj:
            raise ValueError(
                "not a tpusvm sharded-dataset manifest (no format_version)"
            )
        v = obj["format_version"]
        if v != FORMAT_VERSION:
            raise ValueError(
                f"unsupported manifest format_version {v!r} (this build "
                f"reads version {FORMAT_VERSION}); re-ingest the dataset"
            )
        m = cls(
            n_rows=int(obj["n_rows"]),
            n_features=int(obj["n_features"]),
            shards=[ShardInfo.from_json(s) for s in obj["shards"]],
            binary=bool(obj["binary"]),
            positive_label=(None if obj.get("positive_label") is None
                            else int(obj["positive_label"])),
        )
        # internal consistency: offsets/counts must tile [0, n_rows)
        off = 0
        for s in m.shards:
            if s.row_start != off:
                raise ValueError(
                    f"manifest corrupt: shard {s.filename} row_start "
                    f"{s.row_start} != running offset {off}"
                )
            off += s.n_rows
        if off != m.n_rows:
            raise ValueError(
                f"manifest corrupt: shard rows sum to {off}, "
                f"n_rows says {m.n_rows}"
            )
        return m


def is_dataset_dir(path: str) -> bool:
    """True when `path` is a directory holding a sharded-dataset manifest
    (how the CLI tells a shards dir from a CSV file)."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, MANIFEST_NAME)
    )


class ShardWriter:
    """Streaming writer: append (X, Y) blocks of any size, get fixed-size
    shards + a manifest out. Peak memory = one shard's rows.

    Usage:
        with ShardWriter(out_dir, rows_per_shard=65536) as w:
            for X, Y in blocks:
                w.append(X, Y)
        manifest = w.manifest

    The manifest is written (atomically, temp-file + rename) on close; a
    crash mid-ingest leaves no manifest, so the directory is never
    mistaken for a complete dataset. Every SHARD write is atomic too
    (bytes staged to a temp file, os.replace), retried under the shared
    I/O retry policy (faults/retry.py), and journaled: after each
    durable shard the journal (ingest.journal.json) records the shard
    table so far, so a killed ingest resumes from the last durable shard
    (resume=True) instead of leaving an unrecoverable directory. The
    journal is deleted when close() commits the manifest.
    """

    def __init__(self, out_dir: str,
                 rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
                 binary: bool = True,
                 positive_label: Optional[int] = None,
                 resume: bool = False):
        if rows_per_shard < 1:
            raise ValueError(
                f"rows_per_shard must be >= 1, got {rows_per_shard}"
            )
        self.out_dir = out_dir
        self.rows_per_shard = rows_per_shard
        self.binary = binary
        self.positive_label = positive_label
        self.manifest: Optional[Manifest] = None
        self._shards: List[ShardInfo] = []
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending_rows = 0
        self._row_start = 0
        self._n_features: Optional[int] = None
        self._closed = False
        self._retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                   op="ingest.write_shard")
        self._journal_retry = faults.Retry(faults.DEFAULT_IO_POLICY,
                                           op="stream.journal")
        os.makedirs(out_dir, exist_ok=True)
        if resume:
            self._load_journal()

    @classmethod
    def open_append(cls, out_dir: str,
                    rows_per_shard: Optional[int] = None,
                    resume: bool = False):
        """Reopen a committed dataset directory and append to its tail.

        Returns a stream.append.AppendWriter: the grown dataset is bit for
        bit a one-shot ingest of the concatenated data (shard layout,
        stats, manifest), with exactly-once crash safety journaled per
        batch (stream/append.py)."""
        from tpusvm_torch.stream.append import AppendWriter

        return AppendWriter(out_dir, rows_per_shard=rows_per_shard,
                            resume=resume)

    # ------------------------------------------------------- crash safety
    @property
    def rows_durable(self) -> int:
        """Rows already safely on disk (resume=True): the caller skips
        this many input rows before appending."""
        return self._row_start

    def _journal_path(self) -> str:
        return os.path.join(self.out_dir, JOURNAL_NAME)

    def _write_journal(self) -> None:
        """Atomically record the durable shard table (one rewrite per
        shard — O(shards^2) JSON total, noise next to the shard bytes),
        under the shared I/O retry: transients re-run the whole write,
        kills at the ``stream.journal`` point leave the previous journal
        (and the shard it described) intact for resume."""
        self._journal_retry(self._write_journal_once)

    def _write_journal_once(self) -> None:
        faults.point("stream.journal", shards=len(self._shards))
        obj = {
            "journal_version": JOURNAL_VERSION,
            "rows_per_shard": self.rows_per_shard,
            "binary": self.binary,
            "positive_label": self.positive_label,
            "n_features": self._n_features,
            "shards": [s.to_json() for s in self._shards],
        }
        tmp = self._journal_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        fsync_replace(tmp, self._journal_path())

    def _load_journal(self) -> None:
        """Adopt a crashed ingest's durable prefix (resume=True).

        Every journaled shard is re-verified against its checksum before
        being trusted — a shard the journal lists but the disk lost (or
        corrupted) makes resume an error, not a silent hole. No journal
        = nothing to resume, start fresh (mirrors cascade --resume)."""
        jp = self._journal_path()
        if not os.path.exists(jp):
            return
        with open(jp) as f:
            obj = json.load(f)
        if obj.get("journal_version") != JOURNAL_VERSION:
            raise ValueError(
                f"unsupported ingest journal version "
                f"{obj.get('journal_version')!r} in {jp!r}"
                + (" — this is an APPEND-session journal; resume it "
                   "with ShardWriter.open_append(dir, resume=True)"
                   if obj.get("mode") == "append" else "")
            )
        for key, have in (("rows_per_shard", self.rows_per_shard),
                          ("binary", self.binary),
                          ("positive_label", self.positive_label)):
            if obj[key] != have:
                raise ValueError(
                    f"ingest journal was written with {key}={obj[key]!r}, "
                    f"this resume passes {have!r}; re-run with the "
                    "original settings or delete the directory"
                )
        shards = [ShardInfo.from_json(s) for s in obj["shards"]]
        for info in shards:
            path = os.path.join(self.out_dir, info.filename)
            try:
                with np.load(path, allow_pickle=False) as z:
                    X, Y = z["X"], z["Y"]
            except _UNREADABLE as e:
                raise ShardError(
                    info.filename, StreamStatus.CHECKSUM_MISMATCH,
                    f"journaled shard unreadable on resume: {e}"
                ) from e
            if shard_checksum(X, Y) != info.sha256:
                raise ShardError(info.filename,
                                 StreamStatus.CHECKSUM_MISMATCH,
                                 "journaled shard fails its checksum "
                                 "on resume")
        self._shards = shards
        self._row_start = sum(s.n_rows for s in shards)
        self._n_features = (None if obj["n_features"] is None
                            else int(obj["n_features"]))

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()

    def append(self, X: np.ndarray, Y: np.ndarray) -> None:
        X = np.ascontiguousarray(X, np.float64)
        Y = np.ascontiguousarray(Y, np.int32)
        if X.ndim != 2 or Y.ndim != 1 or len(X) != len(Y):
            raise ValueError(
                f"append expects (n, d) X and (n,) Y, got {X.shape} / {Y.shape}"
            )
        if self._n_features is None:
            self._n_features = X.shape[1]
        elif X.shape[1] != self._n_features:
            raise ValueError(
                f"feature count changed mid-ingest: {X.shape[1]} vs "
                f"{self._n_features}"
            )
        if len(X) == 0:
            return
        self._pending.append((X, Y))
        self._pending_rows += len(X)
        while self._pending_rows >= self.rows_per_shard:
            self._flush_shard(self.rows_per_shard)

    def _take(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pop exactly n rows off the pending buffers."""
        xs, ys, taken = [], [], 0
        while taken < n:
            X, Y = self._pending[0]
            need = n - taken
            if len(X) <= need:
                xs.append(X)
                ys.append(Y)
                taken += len(X)
                self._pending.pop(0)
            else:
                xs.append(X[:need])
                ys.append(Y[:need])
                self._pending[0] = (X[need:], Y[need:])
                taken = n
        self._pending_rows -= n
        if len(xs) == 1:
            return xs[0], ys[0]
        return np.concatenate(xs), np.concatenate(ys)

    def _write_shard_atomic(self, filename: str, X: np.ndarray,
                            Y: np.ndarray) -> None:
        """Stage the npz bytes, then temp-file + os.replace — the same
        discipline as the manifest, so a crash never leaves a truncated
        shard-*.npz behind a committed manifest. The injection point
        sits inside the retried body: transient write faults re-run the
        whole write, corrupt rules mangle the staged bytes (caught later
        by the checksum), kills die pre-rename leaving no partial file."""
        buf = io.BytesIO()
        np.savez(buf, X=X, Y=Y)
        payload = faults.point("ingest.write_shard", payload=buf.getvalue(),
                               shard=filename)
        path = os.path.join(self.out_dir, filename)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        fsync_replace(tmp, path)

    def _flush_shard(self, n: int) -> None:
        X, Y = self._take(n)
        idx = len(self._shards)
        filename = f"shard-{idx:05d}.npz"
        self._retry(self._write_shard_atomic, filename, X, Y)
        self._shards.append(ShardInfo(
            filename=filename,
            row_start=self._row_start,
            stats=compute_stats(X, Y),
            sha256=shard_checksum(X, Y),
        ))
        self._row_start += n
        self._write_journal()

    def close(self) -> Manifest:
        if self._closed:
            return self.manifest
        self._closed = True
        if self._pending_rows:
            self._flush_shard(self._pending_rows)
        if not self._shards:
            raise ValueError(
                "ShardWriter: no rows appended — refusing to write an "
                "empty dataset (there is no honest manifest for it)"
            )
        self.manifest = Manifest(
            n_rows=self._row_start,
            n_features=int(self._n_features),
            shards=self._shards,
            binary=self.binary,
            positive_label=self.positive_label,
        )
        # commit transition 1: journal durable, manifest about to land —
        # a kill here resumes by adopting every journaled shard and
        # idempotently rewriting this manifest
        faults.point("stream.journal", commit=True)
        tmp = os.path.join(self.out_dir, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.manifest.to_json(), f, indent=1)
            f.write("\n")
        fsync_replace(tmp, os.path.join(self.out_dir, MANIFEST_NAME))
        # commit transition 2: manifest durable, journal not yet gone —
        # a kill here is the already-committed case (resume re-closes)
        faults.point("stream.journal", committed=True)
        # the manifest supersedes the journal: a committed dataset is no
        # longer a resumable crash site
        jp = self._journal_path()
        if os.path.exists(jp):
            os.remove(jp)
        return self.manifest


def ingest_blocks(out_dir: str,
                  blocks: Iterable[Tuple[np.ndarray, np.ndarray]],
                  rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
                  binary: bool = True,
                  positive_label: Optional[int] = None,
                  resume: bool = False) -> Manifest:
    """Shard any (X, Y)-block iterator (the generic ingest core).

    resume=True adopts a crashed ingest's journal: rows already durable
    in verified shards are skipped off the front of the block stream
    (the SOURCE must be replayed identically — same CSV, same order),
    so the finished dataset is bit-identical to an uninterrupted ingest.
    """
    with ShardWriter(out_dir, rows_per_shard, binary=binary,
                     positive_label=positive_label, resume=resume) as w:
        skip = w.rows_durable
        for X, Y in blocks:
            if skip:
                if len(X) <= skip:
                    skip -= len(X)
                    continue
                X, Y = X[skip:], Y[skip:]
                skip = 0
            w.append(X, Y)
    return w.manifest


def ingest_arrays(out_dir: str, X: np.ndarray, Y: np.ndarray,
                  rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
                  binary: Optional[bool] = None,
                  positive_label: Optional[int] = None,
                  resume: bool = False) -> Manifest:
    """Shard an in-memory array pair (synthetic generators, tests).

    binary defaults to whether Y only carries {+1, -1}."""
    Y = np.asarray(Y)
    if binary is None:
        binary = bool(set(np.unique(Y).tolist()) <= {1, -1})
    return ingest_blocks(out_dir, [(np.asarray(X), Y)], rows_per_shard,
                         binary=binary, positive_label=positive_label,
                         resume=resume)


def ingest_csv(out_dir: str, csv_path: str,
               rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
               n_limit: Optional[int] = None,
               binary: bool = True,
               positive_label: int = 1,
               block_rows: int = 8192,
               resume: bool = False) -> Manifest:
    """Stream a labelled CSV into shards with reference reader semantics
    (header skipped, short rows dropped, n_limit cap, one-vs-rest label
    mapping with a parameterised positive class). Peak memory is
    max(block_rows, rows_per_shard) rows — the CSV is never whole in RAM.
    resume=True continues a killed ingest of the SAME CSV from its
    journal (ingest_blocks).
    """
    return ingest_blocks(
        out_dir,
        read_csv_blocks(csv_path, block_rows=min(block_rows, rows_per_shard),
                        n_limit=n_limit, binary=binary,
                        positive_label=positive_label),
        rows_per_shard,
        binary=binary,
        positive_label=positive_label if binary else None,
        resume=resume,
    )


class ShardedDataset:
    """Read-side handle on an ingested dataset directory.

    Loading granularity is one shard; `load_labels` reads ONLY the Y
    member of each npz (np.load on an npz is lazy per member), so a
    labels-only pass — stratified assignment, fold splitting — costs 4
    bytes/row of IO, not the full feature bytes.
    """

    def __init__(self, path: str, manifest: Manifest):
        self.path = path
        self.manifest = manifest

    @property
    def n_rows(self) -> int:
        return self.manifest.n_rows

    @property
    def n_features(self) -> int:
        return self.manifest.n_features

    @property
    def n_shards(self) -> int:
        return len(self.manifest.shards)

    def shard_path(self, i: int) -> str:
        return os.path.join(self.path, self.manifest.shards[i].filename)

    def load_shard(self, i: int, verify: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """One shard's (X, Y); verify=True re-checksums the content.

        Every failure mode is a ShardError NAMING the shard and carrying
        a StreamStatus — a bit-flipped npz no longer surfaces as a raw
        zlib/zipfile traceback from the prefetch thread: MISSING_FILE
        for an absent file, CHECKSUM_MISMATCH for unreadable bytes, and
        (verify=True) whichever integrity code the manifest check finds.
        """
        info = self.manifest.shards[i]
        faults.point("stream.read_shard", shard=info.filename)
        try:
            with np.load(self.shard_path(i), allow_pickle=False) as z:
                X, Y = z["X"], z["Y"]
        except FileNotFoundError as e:
            raise ShardError(info.filename, StreamStatus.MISSING_FILE,
                             str(e)) from e
        except _UNREADABLE as e:
            raise ShardError(info.filename, StreamStatus.CHECKSUM_MISMATCH,
                             f"unreadable shard bytes: "
                             f"{type(e).__name__}: {e}") from e
        if verify:
            status = self._check_shard(i, X, Y)
            if status != StreamStatus.OK:
                raise ShardError(info.filename, status)
        return X, Y

    def load_labels(self) -> np.ndarray:
        """All labels in global row order (Y-only pass; X never read)."""
        ys = []
        for i in range(self.n_shards):
            with np.load(self.shard_path(i), allow_pickle=False) as z:
                ys.append(z["Y"])
        return np.concatenate(ys)

    def load_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The whole dataset, concatenated — MATERIALISES n_rows x
        n_features in memory; the escape hatch for consumers that need a
        flat array (single-chip fit), not the streaming path."""
        xs, ys = [], []
        for i in range(self.n_shards):
            X, Y = self.load_shard(i)
            xs.append(X)
            ys.append(Y)
        return np.concatenate(xs), np.concatenate(ys)

    def iter_shards(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(self.n_shards):
            yield self.load_shard(i)

    def stats(self) -> ShardStats:
        return self.manifest.global_stats()

    def scaler(self):
        """MinMaxScaler fitted from manifest stats — bit-identical to a
        fit on the concatenated array (stream.stats.scaler_from_stats)."""
        return scaler_from_stats(self.stats())

    # -------------------------------------------------------- validation
    def _check_shard(self, i: int, X: np.ndarray,
                     Y: np.ndarray) -> StreamStatus:
        info = self.manifest.shards[i]
        if (len(X) != info.n_rows or len(Y) != info.n_rows
                or X.shape[1] != self.n_features):
            return StreamStatus.ROW_COUNT_MISMATCH
        if shard_checksum(X, Y) != info.sha256:
            return StreamStatus.CHECKSUM_MISMATCH
        s = compute_stats(X, Y)
        if (not np.array_equal(s.min_val, info.stats.min_val)
                or not np.array_equal(s.max_val, info.stats.max_val)
                or s.class_counts != info.stats.class_counts):
            return StreamStatus.STATS_MISMATCH
        return StreamStatus.OK

    def validate(self) -> List[StreamStatus]:
        """Re-derive every shard's manifest claims from its bytes; one
        StreamStatus per shard (all OK == the dataset is exactly what the
        manifest says it is). Loads one shard at a time."""
        out = []
        for i in range(self.n_shards):
            if not os.path.exists(self.shard_path(i)):
                out.append(StreamStatus.MISSING_FILE)
                continue
            try:
                with np.load(self.shard_path(i), allow_pickle=False) as z:
                    X, Y = z["X"], z["Y"]
            except _UNREADABLE:
                # includes BadZipFile/zlib.error: damaged container bytes
                # are an integrity failure, not a crash
                out.append(StreamStatus.CHECKSUM_MISMATCH)
                continue
            out.append(self._check_shard(i, X, Y))
        return out


def open_dataset(path: str) -> ShardedDataset:
    """Open an ingested dataset directory (reads + validates the manifest's
    internal consistency; shard bytes are checked by validate())."""
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"{path!r} is not a sharded dataset (no {MANIFEST_NAME}; "
            "create one with `python -m tpusvm_torch ingest`)"
        )
    with open(manifest_path) as f:
        manifest = Manifest.from_json(json.load(f))
    return ShardedDataset(path, manifest)
