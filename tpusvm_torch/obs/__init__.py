"""Observability: the blocked solver's convergence ring (convergence.py),
the metrics registry the fault points, the stream reader, serving and the
router count in (registry.py), the JSONL span tracer with its
cross-process trace context (trace.py), the fleet view that merges every
process's registry snapshot (fleet.py: `fleet-metrics`, `top`), the
renderers of trace files (report.py: `report`), the compile observatory's
records of CUDA graph captures and nvcc builds (prof.py, costs.py) and the
regression gate over benchmark JSONL artifacts (benchdiff.py:
`benchdiff`)."""

from tpusvm_torch.obs.convergence import (ConvergenceTelemetry,
                                          format_gap_table, materialize,
                                          to_trace_events)
from tpusvm_torch.obs.fleet import (FleetCollector, format_top, merge_fleet,
                                    render_fleet_text, snapshot_payload,
                                    top_rows)
from tpusvm_torch.obs.registry import (MetricsRegistry, default_registry,
                                       merge_snapshots, render_snapshot_text,
                                       reset_default_registry)
from tpusvm_torch.obs.trace import (TRACE_HEADER, PhaseTimer, TraceContext,
                                    Tracer, read_trace)

__all__ = ["ConvergenceTelemetry", "FleetCollector", "MetricsRegistry",
           "PhaseTimer", "TRACE_HEADER", "TraceContext", "Tracer",
           "default_registry", "format_gap_table", "format_top",
           "materialize", "merge_fleet", "merge_snapshots", "read_trace",
           "render_fleet_text", "render_snapshot_text",
           "reset_default_registry", "snapshot_payload", "to_trace_events",
           "top_rows"]
