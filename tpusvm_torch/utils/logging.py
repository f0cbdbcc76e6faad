"""Structured run logging.

The port's copy of tpusvm/utils/logging.py. The reference's logging is
bare prints guarded by `if (rank==0)` (per-round headers `=== Round k ===`,
merged SV counts, convergence messages, b to 15 places), captured to text
files by the batch system. RunLogger keeps those human-readable lines for
parity checking and adds machine-readable JSONL event records for tooling
(`train --jsonl PATH`).

primary=False silences both: rank processes other than 0 print nothing.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, IO, Optional


class RunLogger:
    """Human-readable log lines + optional JSONL event stream.

    >>> log = RunLogger()
    >>> log.info("n = %d, n_features = %d", 100, 4)
    n = 100, n_features = 4
    >>> log.event("round", round=1, sv_count=10)   # silent without jsonl_path
    """

    def __init__(
        self,
        stream: Optional[IO[str]] = None,
        jsonl_path: Optional[str] = None,
        primary: bool = True,
    ) -> None:
        # None = "current sys.stdout", resolved per call so stream
        # redirection (pytest capsys, contextlib.redirect_stdout) works
        self.stream = stream
        self.primary = primary
        self._jsonl: Optional[IO[str]] = (
            open(jsonl_path, "a") if (jsonl_path and primary) else None
        )

    def info(self, fmt: str, *args: Any) -> None:
        if self.primary:
            out = self.stream if self.stream is not None else sys.stdout
            print(fmt % args if args else fmt, file=out, flush=True)

    def round_header(self, rnd: int) -> None:
        """The reference's per-round banner (mpi_svm_main2.cpp:441)."""
        self.info("=== Round %d ===", rnd)

    def event(self, kind: str, **fields: Any) -> None:
        """Append one structured JSONL record (timestamped)."""
        if self._jsonl is None:
            return
        rec = {"ts": time.time(), "event": kind, **fields}
        self._jsonl.write(json.dumps(rec, default=_jsonable) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _jsonable(x: Any) -> Any:
    import numpy as np

    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    raise TypeError(f"not JSON-serialisable: {type(x)}")
