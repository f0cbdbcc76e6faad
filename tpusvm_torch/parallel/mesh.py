"""Device meshes: a list of torch devices along one named axis.

The port of tpusvm/parallel/mesh.py. A JAX `Mesh` places one shard on
each of its devices and XLA partitions a program over them; torch has no
such object, so here a mesh is the ordered list of devices its members
run on, and the callers (OneVsRestSVC's class axis, the row-split
scoring of decision_function) run one member per entry.

A mesh may repeat a device: `Mesh(["cuda:0"] * 3)` has three members on
one card, which run one after another. That is how a one-card machine,
and the CPU tests (`["cpu"] * 3`), run the split path with its padding
and its partition of the work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

CASCADE_AXIS = "cascade"


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along the named axes (one axis for every
    caller here: require_1d_mesh)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CASCADE_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """{axis: size}, as a JAX mesh's shape reads for one axis."""
        return {self.axis_names[0]: self.size}

    def __len__(self) -> int:
        return self.size


def as_mesh(mesh, axis: str = CASCADE_AXIS) -> Mesh:
    """A Mesh as given, or one over a sequence of devices (torch.device or
    names such as "cuda:0")."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(tuple(torch.device(d) for d in mesh), (axis,))


def require_1d_mesh(mesh: Mesh, what: str) -> None:
    """Raise unless mesh has exactly one axis: callers split along axis 0
    by the mesh's size, which only a 1-D mesh defines."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"{what} requires a 1-D mesh; got axes {mesh.axis_names}")


def make_mesh(n_shards: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = CASCADE_AXIS) -> Mesh:
    """1-D mesh over the first n_shards devices (default: all). devices
    defaults to every visible card; there is no CPU default (pass
    devices=["cpu"] to run on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() over the visible cards, but no CUDA device is "
                "available; pass devices=['cpu'] (command line: --device "
                "cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shards is not None:
        if n_shards > len(devices):
            raise ValueError(
                f"requested {n_shards} shards but only {len(devices)} devices")
        devices = devices[:n_shards]
    return Mesh(tuple(devices), (axis,))


def split_rows(mesh, X) -> List[torch.Tensor]:
    """X's rows in len(mesh) contiguous chunks, chunk i on mesh device i
    (the counterpart of shard_rows_padded: torch needs no even split, so
    nothing is padded; the chunk sizes differ by at most one row and a
    chunk may be empty). X: a numpy array or a tensor."""
    mesh = as_mesh(mesh)
    require_1d_mesh(mesh, "split_rows")
    X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X)
    n, k = X.shape[0], mesh.size
    bounds = [i * n // k for i in range(k + 1)]
    return [X[a:b].to(dev) for a, b, dev in
            zip(bounds[:-1], bounds[1:], mesh.devices)]
