"""tpusvm_torch.fleet: B SVM problems over one X in one lockstep solve.

  fleet_smo_solve: the batched solve (X shared; (B,)-axis y, C, gamma)
  fleet_train:     pack -> solve (optionally compacting) -> per-problem
                   SMOResults
  pack_problems / FleetBatch / bucket_for / fleet_opt_errors: packing
  unpack_results / lane_result / fleet_convergence_summary: unpacking
"""

from tpusvm_torch.fleet.batch import (FleetBatch, bucket_for,
                                      fleet_opt_errors, pack_problems)
from tpusvm_torch.fleet.results import (fleet_convergence_summary,
                                        lane_result, unpack_results)
from tpusvm_torch.fleet.solve import FleetState, fleet_smo_solve, fleet_train

__all__ = [
    "FleetBatch",
    "FleetState",
    "bucket_for",
    "fleet_opt_errors",
    "pack_problems",
    "fleet_convergence_summary",
    "lane_result",
    "unpack_results",
    "fleet_smo_solve",
    "fleet_train",
]
