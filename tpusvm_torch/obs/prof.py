"""The compile observatory: build and capture accounting for the port.

The port's counterpart of tpusvm/obs/prof.py. torch has no jit cache, so
there is no `profiled_jit` wrapper: the records are written where the port
builds or captures a program,

  * each (model, bucket) CUDA graph capture of serve (serve/buckets.py):
    lower_s is the eager warm-up run, compile_s the capture;
  * the pair solver's chunk graph (solver/smo.py): lower_s is the eager
    first chunk, compile_s the capture;
  * each nvcc build of a kernel library (ops/cuda/_build.py): compile_s is
    that library's nvcc seconds.

Each record has the JAX package's shape (`costs.compile_record`), lands in
the metrics registry as the same gauges and counter (prof.compiles,
prof.lower_s, prof.compile_s) and, while the observatory is on, in the
event sink as one `prof.compile` event, which `report`'s compile table
renders. Off (the default), a build site pays one attribute read; on or
off, no result changes: the observatory only reads clocks around work the
port does anyway.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, Optional

from tpusvm_torch.obs import costs
from tpusvm_torch.obs.registry import MetricsRegistry, default_registry


def _write_gauges(reg: MetricsRegistry, rec: dict) -> None:
    name = rec["executable"]
    reg.counter("prof.compiles", executable=name).inc()
    reg.gauge("prof.lower_s", executable=name).set_max(rec["lower_s"])
    reg.gauge("prof.compile_s", executable=name).set_max(rec["compile_s"])
    for key in ("flops", "bytes_accessed", "arith_intensity", "temp_bytes"):
        v = rec.get(key)
        if v is not None:
            reg.gauge(f"prof.{key}", executable=name).set_max(v)


class CompileObservatory:
    """Where compile records go while profiling is on."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 event_sink: Optional[Callable[..., None]] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.event_sink = event_sink
        self._lock = threading.Lock()
        self.records: list = []  # compile records, in record order

    def record(self, rec: dict, registry: Optional[MetricsRegistry] = None
               ) -> None:
        """Keep `rec`, write its gauges into `registry` (default: the
        observatory's) and send it to the event sink."""
        with self._lock:
            self.records.append(rec)
        _write_gauges(self.registry if registry is None else registry, rec)
        if self.event_sink is not None:
            self.event_sink("prof.compile", **rec)


# ------------------------------------------------------------ module state
_active: Optional[CompileObservatory] = None
_lock = threading.Lock()


def enable_profiling(registry: Optional[MetricsRegistry] = None,
                     event_sink: Optional[Callable[..., None]] = None,
                     ) -> CompileObservatory:
    """Turn the observatory on process-wide and return it (a second enable
    replaces the first: the last caller wins)."""
    global _active
    with _lock:
        _active = CompileObservatory(registry=registry,
                                     event_sink=event_sink)
        return _active


def disable_profiling() -> None:
    global _active
    with _lock:
        _active = None


def profiling_enabled() -> bool:
    return _active is not None


def current() -> Optional[CompileObservatory]:
    return _active


@contextlib.contextmanager
def profiling(registry: Optional[MetricsRegistry] = None,
              event_sink: Optional[Callable[..., None]] = None,
              ) -> Iterator[CompileObservatory]:
    """Scoped enable and disable (the test surface)."""
    obs = enable_profiling(registry=registry, event_sink=event_sink)
    try:
        yield obs
    finally:
        disable_profiling()


def record_compile(name: str, lower_s: float, compile_s: float,
                   compiled=None,
                   registry: Optional[MetricsRegistry] = None,
                   **extra: Any) -> dict:
    """Report one build or capture into the observatory.

    Always writes the gauges into `registry` (default: the observatory's
    when on, else the process default; a host-side write, so serve's
    capture accounting exists unprofiled); the `prof.compile` event fires
    only while the observatory is on."""
    rec = costs.compile_record(name, lower_s, compile_s, compiled, **extra)
    obs = _active
    if obs is not None:
        obs.record(rec, registry=registry)
    else:
        _write_gauges(default_registry() if registry is None else registry,
                      rec)
    return rec
