"""Host spans recorded by the harness around its calls into the
program, and by the program where it takes a tracer
(`BinarySVC.fit(tracer=)` calls `add_span(name, t0, t1)` with
perf_counter seconds). Kept in memory; read once the window has
closed. Only a traced run records them (`enabled`): the end-to-end
metrics are measured with tracing off."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans = []  # (name, t0, t1), perf_counter seconds

    def add_span(self, name: str, t0: float, t1: float, **_) -> None:
        self.spans.append((name, t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)
