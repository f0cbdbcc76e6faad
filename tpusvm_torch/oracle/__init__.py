"""The serial NumPy SMO oracle (the port's copy of tpusvm/oracle)."""

from tpusvm_torch.oracle.smo import (OracleResult, get_sv_indices, kernel_row,
                                     predict, smo_train, svr_train)

__all__ = ["OracleResult", "smo_train", "svr_train", "get_sv_indices",
           "kernel_row", "predict"]
