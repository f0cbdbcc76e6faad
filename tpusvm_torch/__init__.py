"""tpusvm_torch — the PyTorch/CUDA port of tpusvm for one NVIDIA H100.

Slice 1: train and score a binary RBF C-SVC with the blocked SMO solver,
with hand-written CUDA kernels for the fused f-update and the inner SMO
subproblem (built from tpusvm_torch/csrc at first use). Imports torch and
numpy only; the CUDA kernels are compiled on first call, never on import.
"""

__version__ = "0.1.0"
