"""The cascade SVM: padded SV buffers, the round engines (one process, or
one process per rank over torch.distributed) and round checkpoints; the
1-D device meshes the class axis and row-split scoring run over."""

from tpusvm_torch.parallel.cascade import CascadeResult, cascade_fit
from tpusvm_torch.parallel.group import Exchange, init_group, rank_device
from tpusvm_torch.parallel.mesh import (CASCADE_AXIS, Mesh, make_mesh,
                                        split_rows)
from tpusvm_torch.parallel.svbuffer import (
    SVBuffer,
    compact,
    dedup_first,
    empty,
    extract_svs,
    from_arrays,
    merge_dedup,
)

__all__ = [
    "CascadeResult",
    "cascade_fit",
    "Exchange",
    "init_group",
    "rank_device",
    "CASCADE_AXIS",
    "Mesh",
    "make_mesh",
    "split_rows",
    "SVBuffer",
    "compact",
    "dedup_first",
    "empty",
    "extract_svs",
    "from_arrays",
    "merge_dedup",
]
