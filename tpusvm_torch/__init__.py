"""tpusvm_torch — the PyTorch/CUDA port of tpusvm for one NVIDIA H100.

Train and score SVMs on the card: binary C-SVC with the blocked or the
pair SMO solver over the rbf, linear, poly and sigmoid kernels,
one-vs-rest, epsilon-SVR and Platt calibration, from CSV files or seeded
synthetic data, with refine, active-set shrinking, a K-row cache and
crash-safe checkpoints on the blocked solver, the tree and star cascade
(tpusvm_torch.parallel: in one process or one rank process per leaf over
torch.distributed), the one-vs-rest class axis over cards or rank
processes, hyperparameter search (tpusvm_torch.tune), and hand-written CUDA
kernels (tpusvm_torch/csrc) for the f-update, the inner subproblem and
the pair solver's K rows. Imports torch and numpy only; the CUDA kernels
are compiled on first call, never on import.
"""

__version__ = "0.1.0"
