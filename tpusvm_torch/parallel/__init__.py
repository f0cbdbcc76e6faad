"""The cascade SVM: padded SV buffers, the round engines (one process, or
one process per rank over torch.distributed) and round checkpoints."""

from tpusvm_torch.parallel.cascade import CascadeResult, cascade_fit
from tpusvm_torch.parallel.group import Exchange, init_group, rank_device
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
    "SVBuffer",
    "compact",
    "dedup_first",
    "empty",
    "extract_svs",
    "from_arrays",
    "merge_dedup",
]
