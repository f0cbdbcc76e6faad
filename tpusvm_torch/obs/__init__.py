"""Observability: the blocked solver's convergence ring (convergence.py)
and the metrics registry the fault points and the stream reader count in
(registry.py)."""

from tpusvm_torch.obs.convergence import (ConvergenceTelemetry,
                                          format_gap_table, materialize)
from tpusvm_torch.obs.registry import (MetricsRegistry, default_registry,
                                       merge_snapshots, reset_default_registry)

__all__ = ["ConvergenceTelemetry", "MetricsRegistry", "default_registry",
           "format_gap_table", "materialize", "merge_snapshots",
           "reset_default_registry"]
