"""Data: the CSV reader, the min-max scaler and the seeded synthetic
generators."""

from tpusvm_torch.data.csv_reader import (read_csv, read_csv_blocks,
                                          read_csv_regression, write_csv)
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (blobs, mnist_like,
                                         mnist_like_multiclass, rings,
                                         svr_sine)

__all__ = ["MinMaxScaler", "blobs", "mnist_like", "mnist_like_multiclass",
           "read_csv", "read_csv_blocks", "read_csv_regression", "rings",
           "svr_sine", "write_csv"]
