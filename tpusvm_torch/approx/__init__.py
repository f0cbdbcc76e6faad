"""The approximate-kernel families: explicit feature maps and the
streaming primal solver.

Random Fourier features and Nystrom landmark maps (features.py) send the
rbf kernel into an explicit feature space where every kernel touchpoint
is the linear family's matmul; the streaming mini-batch primal solver
(primal.py) consumes shards mapped on the card straight off the reader's
prefetch hook. Kernel families "rff"/"nystrom" route here through the
model layer, and kernels/dispatch.py sends them through the linear path.
"""

from tpusvm_torch.approx.features import (
    FeatureMap,
    apply_map,
    approx_decision_function,
    build_map,
    kernel_approx_error,
    map_from_state,
    nystrom_landmark_indices,
    nystrom_weights,
    rff_omega,
)
from tpusvm_torch.approx.primal import (
    PrimalResult,
    primal_batch_step,
    streaming_primal_fit,
)

__all__ = [
    "FeatureMap",
    "PrimalResult",
    "apply_map",
    "approx_decision_function",
    "build_map",
    "kernel_approx_error",
    "map_from_state",
    "nystrom_landmark_indices",
    "nystrom_weights",
    "primal_batch_step",
    "rff_omega",
    "streaming_primal_fit",
]
