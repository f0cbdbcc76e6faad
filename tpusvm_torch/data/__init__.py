"""Data: the min-max scaler and the seeded synthetic generators."""

from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (blobs, mnist_like,
                                         mnist_like_multiclass, rings,
                                         svr_sine)

__all__ = ["MinMaxScaler", "blobs", "mnist_like", "mnist_like_multiclass",
           "rings", "svr_sine"]
