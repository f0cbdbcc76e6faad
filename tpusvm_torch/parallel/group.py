"""A rank's place in a torch.distributed process group, and the cascade's
exchanges between ranks.

The counterpart of tpusvm/parallel/mesh.py. The reference runs one MPI
rank per process (`mpirun -np P`, code/mpi_svm3.sh); here each rank is a
process in a torch.distributed group, and the collectives the rounds need
move fixed-shape SVBuffers between them:

  - broadcast of rank 0's model (the JAX all_gather(...)[0]);
  - all_gather of the per-rank diagnostics and of the star's leaf SV sets;
  - the tree's pairwise send/recv (the JAX lax.ppermute with
    perm = [(r, r - step) for r % 2step == step]);
  - all_gather of the resume fingerprints (the JAX process_allgather).

The backend is gloo, over CPU copies of the buffers: the ranks of one
machine may share one card, and gloo is what runs without one. Bits cross
unchanged (bool masks travel as uint8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from tpusvm_torch.parallel.svbuffer import SVBuffer


def init_group(address: str, world_size: int, rank: int,
               timeout_s: float = 600.0):
    """Join the gloo process group at `address` ("host:port") as `rank` of
    `world_size` and return it. A failure raises; nothing falls back to a
    one-process run."""
    import datetime

    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{address}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` solves on: `cuda` becomes cuda:{rank %
    device_count} (the ranks of one machine share its cards), an explicit
    index or the CPU stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but no CUDA device is "
                "available; pass device='cpu' (command line: --device cpu) "
                "to run on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t's bits on the CPU, for sending (may share t's storage)."""
    t = t.detach().to("cpu")
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _blank(t: torch.Tensor) -> torch.Tensor:
    """A fresh CPU tensor to receive t's wire form into."""
    dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
    return torch.empty(t.shape, dtype=dtype)


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.dtype).to(like.device)


@dataclass
class Exchange:
    """The rounds' collectives over one process group."""

    group: object

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def broadcast_buffer(self, buf: SVBuffer, src: int = 0) -> SVBuffer:
        """Rank src's buffer on every rank (each passes one of the same
        shapes and dtypes; the result lives on the caller's device)."""
        out = []
        for t in buf:
            w = _wire(t) if self.rank == src else _blank(t)
            dist.broadcast(w, src, group=self.group)
            out.append(_unwire(w, t))
        return SVBuffer(*out)

    def gather_buffers(self, buf: SVBuffer) -> List[SVBuffer]:
        """Every rank's buffer, in rank order, on every rank."""
        fields = []
        for t in buf:
            w = _wire(t)
            parts = [_blank(t) for _ in range(self.size)]
            dist.all_gather(parts, w, group=self.group)
            fields.append([_unwire(p, t) for p in parts])
        return [SVBuffer(*f) for f in zip(*fields)]

    def send_buffer(self, buf: SVBuffer, dst: int) -> None:
        for t in buf:
            dist.send(_wire(t), dst, group=self.group)

    def recv_buffer(self, like: SVBuffer, src: int) -> SVBuffer:
        """The buffer rank src sends, shaped and placed like `like`."""
        out = []
        for t in like:
            w = _blank(t)
            dist.recv(w, src, group=self.group)
            out.append(_unwire(w, t))
        return SVBuffer(*out)

    def gather_rows(self, row: np.ndarray) -> np.ndarray:
        """(size, *row.shape) stack of every rank's int64 row."""
        w = torch.as_tensor(np.asarray(row, np.int64))
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.stack(parts).numpy()

    def broadcast_values(self, values, src: int = 0) -> np.ndarray:
        """Rank src's float64 values on every rank (floats and counts
        below 2**53 cross exactly)."""
        w = torch.tensor(np.asarray(values, np.float64))
        dist.broadcast(w, src, group=self.group)
        return w.numpy()
