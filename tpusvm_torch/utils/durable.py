"""The one sanctioned spelling of a flushed atomic commit.

The port's copy of the JAX package's tpusvm/utils/durable.py.
``os.replace`` alone makes a write atomic with respect to readers (they
see old bytes or new bytes, never a torn file) but not with respect to
power loss: a filesystem may commit the rename before the staged file's
data reaches the disk, so a crash can leave the final name pointing at a
hollow file. Solver checkpoints promise kill-safety, which needs

    flush stream -> fsync(staged fd) -> os.replace(staged, final)

and `fsync_replace` is that sequence. The parent directory is not
fsynced: a vanished rename replays, a committed name with torn bytes
would not.
"""

from __future__ import annotations

import os


def fsync_replace(tmp_path: str, final_path: str) -> None:
    """Atomically commit `tmp_path` over `final_path`, durably.

    The staged file's bytes are fsynced before the rename, so the commit
    never outruns its data. Callers write, flush and close the staged file
    first; this reopens it read-only to fsync it."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    # tpusvm: durable-by=callers stage the temp beside its target; the helper's opaque params carry no directory to compare
    os.replace(tmp_path, final_path)
