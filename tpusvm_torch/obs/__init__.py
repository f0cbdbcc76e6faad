"""Observability: the blocked solver's convergence ring (convergence.py)."""

from tpusvm_torch.obs.convergence import (ConvergenceTelemetry,
                                          format_gap_table, materialize)

__all__ = ["ConvergenceTelemetry", "format_gap_table", "materialize"]
