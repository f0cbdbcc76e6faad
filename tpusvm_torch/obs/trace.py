"""Schema-versioned JSONL span/event tracing and the PhaseTimer adapter.

The port's copy of tpusvm/obs/trace.py. One trace file per run, one JSON
object per line, with the JAX package's record keys, so a trace written
by either package reads in the other:

  {"v": 1, "kind": "meta",  "t0": ..., "wall": ..., "argv": [...]}
  {"v": 1, "kind": "span",  "id": 3, "parent": 1, "name": "serve.request",
   "t0": ..., "t1": ..., "dur_s": ..., "attrs": {...}}
  {"v": 1, "kind": "event", "id": 7, "parent": 3, "name": "fault.injected",
   "ts": ..., "attrs": {...}}
  {"v": 1, "kind": "end",   "t1": ..., "total_s": ...}

Spans nest per thread (each thread keeps its own open-span stack, so the
router's and a replica's handler threads parent correctly without
cross-thread races); a span line is written when the span CLOSES, so the
file is append-only and a killed process still holds every completed
span (at most its last line torn). Timestamps come from an injectable
monotonic clock: tests pass a counter and get a bit-stable file.

Cross-process propagation: a Tracer constructed with `role=` mints a
compact TraceContext (`Tracer.ctx()`) naming (trace_id, innermost open
span id, role, pid). The context travels as the ``X-Tpusvm-Trace`` HTTP
header (router -> serve replica: router/proxy.py, serve/http.py), and the
receiving span carries it in its attrs, so a span of one file resolves to
its parent span in the other. Tracers without a role write exactly the
meta record the JAX package's anonymous tracers write.

`read_trace` is the version-gated parser; obs/report.py renders these
files (`python -m tpusvm_torch report TRACE...`), several at once merged
onto one wall clock.

PhaseTimer is a thin span adapter: the accumulate-by-name surface and the
reference's `<phase> time: ... s` / `elapsed time:` lines, with every
phase entry also written as a span when a tracer is attached.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

# the single render path of the timing block (PhaseTimer.report, report)
from tpusvm_torch.obs.report import render_phase_lines  # noqa: F401

TRACE_SCHEMA_VERSION = 1

# HTTP header carrying a serialized TraceContext (router -> replica).
TRACE_HEADER = "X-Tpusvm-Trace"

# Version prefix of the header wire format; bump on incompatible change.
_CTX_WIRE_VERSION = "1"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Compact cross-process trace context.

    Names the span a remote process should parent its own spans under:
    the originating run's trace_id, the id of the span open at mint time
    (None when minted outside any span), and the origin's role/pid so a
    reader can find the originating trace file.
    """

    trace_id: str
    span_id: Optional[int]
    role: str
    pid: int

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "role": self.role, "pid": self.pid}

    @classmethod
    def from_dict(cls, d: Any) -> Optional["TraceContext"]:
        """Parse a ctx dict; None on anything malformed (a peer speaking
        another dialect degrades to 'no context', never to a crash)."""
        if not isinstance(d, dict):
            return None
        trace_id, role, pid = d.get("trace_id"), d.get("role"), d.get("pid")
        span_id = d.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(role, str):
            return None
        if not isinstance(pid, int) or isinstance(pid, bool):
            return None
        if span_id is not None and (
                not isinstance(span_id, int) or isinstance(span_id, bool)):
            return None
        return cls(trace_id=trace_id, span_id=span_id, role=role, pid=pid)

    def to_header(self) -> str:
        """Serialize for the X-Tpusvm-Trace header:
        ``1;<trace_id>;<span_id|->;<role>;<pid>``."""
        sid = "-" if self.span_id is None else str(self.span_id)
        return ";".join([_CTX_WIRE_VERSION, self.trace_id, sid,
                         self.role, str(self.pid)])

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Parse a header value; None on absent/junk/unknown version."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split(";")
        if len(parts) != 5 or parts[0] != _CTX_WIRE_VERSION:
            return None
        _, trace_id, sid, role, pid = parts
        if not trace_id or not role:
            return None
        try:
            span_id = None if sid == "-" else int(sid)
            return cls(trace_id=trace_id, span_id=span_id, role=role,
                       pid=int(pid))
        except ValueError:
            return None


def _jsonable(x: Any) -> Any:
    import numpy as np

    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    raise TypeError(f"not JSON-serialisable: {type(x)}")


class Tracer:
    """Append-only JSONL trace writer with nested spans; thread-safe.

    Args:
      path: output file (opened for append; the meta record delimits
        each run).
      clock: monotonic float clock, injectable for deterministic tests
        (default time.perf_counter).
      wall: wall clock for the meta record only (default time.time).
      max_bytes: size cap; past it the file becomes `path.1` (replacing
        an older backup, whose records are counted in the default
        registry's obs.trace_dropped_records) and a fresh file starts
        with a continuation meta record carrying the original t0/wall.
      role: fleet role ("router", "serve", ...): the meta record gains
        role/pid/trace_id and `ctx()` becomes mintable.
      ctx: the propagated TraceContext this process was spawned with,
        recorded in the meta; implies the origin's trace_id.
      trace_id: explicit correlation id (default a fresh random one when
        role or ctx is set).
    """

    def __init__(self, path: str, clock=None, wall=None,
                 argv: Optional[List[str]] = None,
                 max_bytes: Optional[int] = None,
                 role: Optional[str] = None,
                 ctx: Optional[TraceContext] = None,
                 trace_id: Optional[str] = None):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if role is not None and ";" in role:
            raise ValueError(f"role must not contain ';': {role!r}")
        self._clock = clock or time.perf_counter
        self._wall = wall or time.time
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self._f = open(path, "a")
        self.path = path
        self.role = role
        self.pid = os.getpid()
        if trace_id is None and (role is not None or ctx is not None):
            trace_id = (ctx.trace_id if ctx is not None
                        else uuid.uuid4().hex[:16])
        self.trace_id = trace_id
        self.parent_ctx = ctx
        self.max_bytes = max_bytes
        self._size = self._f.tell()
        self.rotations = 0
        self._closed = False
        self._meta = {"v": TRACE_SCHEMA_VERSION, "kind": "meta",
                      "t0": self._clock(), "wall": self._wall()}
        self._t0 = self._meta["t0"]
        if argv is not None:
            self._meta["argv"] = list(argv)
        # cross-process identity keys are opt-in: a role-less, ctx-less
        # tracer writes the meta record anonymous tracers always wrote
        if self.trace_id is not None:
            self._meta["trace_id"] = self.trace_id
        if role is not None:
            self._meta["role"] = role
            self._meta["pid"] = self.pid
        if ctx is not None:
            self._meta["ctx"] = ctx.to_dict()
        self._write(self._meta)

    # ------------------------------------------------------------ plumbing
    def _rotate_locked(self) -> None:
        from tpusvm_torch.obs.registry import default_registry

        backup = self.path + ".1"
        dropped = 0
        if os.path.exists(backup):
            with open(backup) as f:
                dropped = sum(1 for line in f if line.strip())
        self._f.close()
        # rotation renames bytes already written: either name stays
        # readable, and read_trace refuses a torn tail
        os.replace(self.path, backup)
        self._f = open(self.path, "a")
        self._size = 0
        self.rotations += 1
        reg = default_registry()
        reg.counter("obs.trace_rotations").inc()
        if dropped:
            reg.counter("obs.trace_dropped_records").inc(dropped)
        cont = dict(self._meta, rotated=self.rotations)
        line = json.dumps(cont, default=_jsonable)
        self._f.write(line + "\n")
        self._size += len(line) + 1

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            if self._closed:
                return
            if (self.max_bytes is not None and self._size > 0
                    and self._size + len(line) + 1 > self.max_bytes):
                self._rotate_locked()
            self._f.write(line + "\n")
            self._size += len(line) + 1
            self._f.flush()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    # ------------------------------------------------------------- surface
    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        """Nested timed region; the record is written when it closes."""
        sid = self._new_id()
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            stack.pop()
            self._write({
                "v": TRACE_SCHEMA_VERSION, "kind": "span", "id": sid,
                "parent": parent, "name": name, "t0": t0, "t1": t1,
                "dur_s": t1 - t0, "attrs": attrs,
            })

    def add_span(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Write a span the caller timed itself on this tracer's clock
        (t0, t1), parented to the innermost open span: a loop that tiles
        its work with perf_counter marks (BinarySVC.fit's host phases)
        records its pieces without a context manager each."""
        stack = self._stack()
        self._write({
            "v": TRACE_SCHEMA_VERSION, "kind": "span", "id": self._new_id(),
            "parent": stack[-1] if stack else None, "name": name,
            "t0": t0, "t1": t1, "dur_s": t1 - t0, "attrs": attrs,
        })

    def event(self, name: str, **attrs: Any) -> None:
        """Point-in-time record, parented to the innermost open span."""
        stack = self._stack()
        self._write({
            "v": TRACE_SCHEMA_VERSION, "kind": "event",
            "id": self._new_id(),
            "parent": stack[-1] if stack else None,
            "name": name, "ts": self._clock(), "attrs": attrs,
        })

    def ctx(self) -> TraceContext:
        """Mint a TraceContext naming the calling thread's innermost open
        span (None outside any span) as the remote parent. Needs a role:
        an anonymous tracer has no fleet identity to propagate."""
        if self.role is None:
            raise ValueError(
                "Tracer.ctx() needs a role= at construction; an anonymous "
                "tracer has no cross-process identity to propagate")
        stack = self._stack()
        return TraceContext(trace_id=self.trace_id,
                            span_id=stack[-1] if stack else None,
                            role=self.role, pid=self.pid)

    def metrics_snapshot(self, snapshot: dict) -> None:
        """Embed a registry snapshot (obs/registry.py) as an event."""
        self.event("metrics.snapshot", snapshot=snapshot)

    def close(self) -> None:
        if self._closed:
            return
        t1 = self._clock()
        self._write({"v": TRACE_SCHEMA_VERSION, "kind": "end", "t1": t1,
                     "total_s": t1 - self._t0})
        with self._lock:
            self._closed = True
            self._f.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def trace_file_set(path: str) -> List[str]:
    """The rotated-set members of a trace, oldest first: `path.K` for
    descending K, then `path`."""
    d, base = os.path.split(path)
    pat = re.compile(re.escape(base) + r"\.(\d+)$")
    ks = sorted(
        (int(m.group(1)) for f in os.listdir(d or ".")
         if (m := pat.match(f))),
        reverse=True,
    )
    return [f"{path}.{k}" for k in ks] + [path]


def read_trace(path: str) -> List[dict]:
    """Parse a trace file (its rotated set, in order); ValueError on a
    schema mismatch or a torn line. Blank lines are skipped; a
    crash-truncated last line is reported, not skipped."""
    records: List[dict] = []
    for member in trace_file_set(path):
        records.extend(_read_one_trace(member))
    return records


def _read_one_trace(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{i}: not a JSON record ({e}); the trace "
                    "file is corrupt or truncated"
                ) from None
            v = rec.get("v")
            if v != TRACE_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i}: trace schema version {v!r} is not "
                    f"supported (this build reads v{TRACE_SCHEMA_VERSION})"
                )
            records.append(rec)
    return records


class PhaseTimer:
    """Accumulating named phase timer (span adapter).

    >>> t = PhaseTimer()
    >>> with t.phase("train"):
    ...     pass
    >>> t["train"] >= 0
    True

    Phases accumulate across repeated entries; `report()` lists them in
    first-entry order and ends with the total. With a tracer attached,
    every phase entry is also written as a span (attrs: phase=True).
    Device work is asynchronous: close a phase only after its result is
    on the host, or it under-reports.
    """

    def __init__(self, tracer: Optional[Tracer] = None) -> None:
        self._acc: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self.tracer = tracer

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        span = (self.tracer.span(name, phase=True) if self.tracer
                else contextlib.nullcontext())
        start = time.perf_counter()
        try:
            with span:
                yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def add(self, name: str, seconds: float) -> None:
        """Accumulate an externally measured duration."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def __getitem__(self, name: str) -> float:
        return self._acc[name]

    def __contains__(self, name: str) -> bool:
        return name in self._acc

    @property
    def total(self) -> float:
        """Wall-clock since construction (the reference's 'elapsed')."""
        return time.perf_counter() - self._t0

    def asdict(self) -> Dict[str, float]:
        d = dict(self._acc)
        d["total"] = self.total
        return d

    def report(self) -> str:
        return render_phase_lines(self._acc, self.total)
