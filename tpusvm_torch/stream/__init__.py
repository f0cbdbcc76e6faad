"""The out-of-core data tier: sharded on-disk datasets, the JAX package's
format, read and written by the port.

  format.py   versioned layout: packed .npz shards + a JSON manifest
              (per-shard row counts, feature min/max, class counts,
              content checksums); ShardWriter / ingest_* producers,
              ShardedDataset, StreamStatus validation
  stats.py    mergeable per-shard statistics: a MinMaxScaler fitted from
              the manifest with the bits of a whole-array fit
  reader.py   ShardReader: background prefetch with a hard
              prefetch_depth + 1 residency bound, deterministic order,
              on-the-fly scaling and a transform hook (mapping on the card)
  assign.py   global row -> cascade-leaf assignment from the manifest;
              the cascade's Partition filled shard by shard; row gathers
  infer.py    predict_stream / evaluate_stream over prefetched batches
  append.py   crash-safe tail appends: ShardWriter.open_append reopens a
              committed dataset and grows it bit for bit as a one-shot
              ingest of the concatenation would, exactly once under a
              kill (a per-batch CRC ledger in the journal)

Command line: `python -m tpusvm_torch ingest` writes a dataset;
`train --data`, `predict --data` and `info DIR` consume one.
"""

from tpusvm_torch.stream.append import AppendError, AppendWriter, append_blocks
from tpusvm_torch.stream.assign import (
    RowAssignment,
    assign_rows,
    gather_rows,
    partition_from_dataset,
)
from tpusvm_torch.stream.format import (
    FORMAT_VERSION,
    Manifest,
    ShardError,
    ShardInfo,
    ShardWriter,
    ShardedDataset,
    ingest_arrays,
    ingest_blocks,
    ingest_csv,
    is_dataset_dir,
    open_dataset,
    shard_checksum,
)
from tpusvm_torch.stream.infer import evaluate_stream, predict_stream
from tpusvm_torch.stream.reader import ShardReader
from tpusvm_torch.stream.stats import (
    ShardStats,
    compute_stats,
    merge_stats,
    scaler_from_stats,
)

__all__ = [
    "AppendError",
    "AppendWriter",
    "FORMAT_VERSION",
    "Manifest",
    "RowAssignment",
    "ShardError",
    "ShardInfo",
    "ShardReader",
    "ShardStats",
    "ShardWriter",
    "ShardedDataset",
    "append_blocks",
    "assign_rows",
    "compute_stats",
    "evaluate_stream",
    "gather_rows",
    "ingest_arrays",
    "ingest_blocks",
    "ingest_csv",
    "is_dataset_dir",
    "merge_stats",
    "open_dataset",
    "partition_from_dataset",
    "predict_stream",
    "scaler_from_stats",
    "shard_checksum",
]
