"""Fixed-capacity padded support-vector buffers, masked dedup and compaction.

The port of tpusvm/parallel/svbuffer.py. The reference's cascade passes
dynamically-sized SV sets between ranks (mpi_svm_main3.cpp:692-716) and
dedups them with an unordered_set of global IDs (:628-655). Here an SV
set is a capacity-padded buffer with a validity mask, so every exchange
between ranks has a fixed shape, and the hash-set dedup is a stable sort
by id: the first occurrence of each id survives, which is the
reference's sequential insert-if-new order (earlier positions win).

All functions are plain tensor code on the buffers' device; the results
equal the JAX functions' bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# the sort key of invalid rows: they sort after every valid id
_BIG = 2**31 - 1


class SVBuffer(NamedTuple):
    """A padded SV set on one device. Rows with valid=False are padding.

    X:     (cap, d)   features
    Y:     (cap,) int32 labels in {+1, -1}; 0 in padding
    alpha: (cap,)     dual variables; 0 in padding
    ids:   (cap,) int32 global sample IDs; -1 in padding
    valid: (cap,) bool
    """

    X: torch.Tensor
    Y: torch.Tensor
    alpha: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.Y.shape[0]

    def count(self) -> int:
        return int(self.valid.sum())


def empty(cap: int, d: int, dtype=torch.float32, device="cpu") -> SVBuffer:
    return SVBuffer(
        X=torch.zeros((cap, d), dtype=dtype, device=device),
        Y=torch.zeros((cap,), dtype=torch.int32, device=device),
        alpha=torch.zeros((cap,), dtype=dtype, device=device),
        ids=torch.full((cap,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
    )


def from_arrays(X, Y, alpha, ids, valid) -> SVBuffer:
    X = torch.as_tensor(X)
    dev = X.device
    return SVBuffer(
        X=X,
        Y=torch.as_tensor(Y, device=dev).to(torch.int32),
        alpha=torch.as_tensor(alpha, device=dev).to(X.dtype),
        ids=torch.as_tensor(ids, device=dev).to(torch.int32),
        valid=torch.as_tensor(valid, device=dev).to(torch.bool),
    )


def compact(buf: SVBuffer, cap_out: int) -> Tuple[SVBuffer, int]:
    """Pack valid rows to the front (stable order) into a cap_out buffer.

    Returns (packed buffer, valid count). Valid rows whose slot is at or
    beyond cap_out are dropped, and the count is taken before that, so a
    caller detects overflow as count > cap_out.
    """
    d = buf.X.shape[1]
    count = buf.count()
    # destination slot of each row; invalid and overflowing rows are dropped
    pos = torch.cumsum(buf.valid.to(torch.int32), 0) - 1
    keep = buf.valid & (pos < cap_out)
    dest = pos[keep].long()
    out = empty(cap_out, d, buf.X.dtype, buf.X.device)
    for o, t in zip(out, buf):
        o[dest] = t[keep].to(o.dtype)
    return out, count


def dedup_first(buf: SVBuffer) -> SVBuffer:
    """Invalidate duplicate ids, keeping the FIRST valid occurrence.

    The reference's unordered_set insert-if-new loop
    (mpi_svm_main3.cpp:644-655) as a sort: order the rows by (id,
    position) — a stable sort by id, invalid rows keyed past every id —,
    keep the rows whose id differs from the previous sorted row's, and
    scatter the keep-mask back to the original positions.
    """
    cap = buf.ids.shape[0]
    big = torch.tensor(_BIG, dtype=torch.int32, device=buf.ids.device)
    key = torch.where(buf.valid, buf.ids, big)
    sorted_key, sorted_pos = torch.sort(key, stable=True)
    first = torch.ones(cap, dtype=torch.bool, device=key.device)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    keep_sorted = first & (sorted_key != big)
    keep = torch.zeros(cap, dtype=torch.bool, device=key.device)
    keep[sorted_pos] = keep_sorted
    return buf._replace(valid=buf.valid & keep)


def merge_dedup(primary: SVBuffer, secondary: SVBuffer,
                cap_out: int) -> Tuple[SVBuffer, int]:
    """Union of two SV sets with the cascade's alpha rules.

    Primary rows keep their alpha (warm start); secondary rows get alpha =
    0 (zeroed before the dedup) and are dropped when their id already
    appears in primary or earlier in secondary. This is the reference's
    union builder:
      - tree:  primary = received SVs (warm), secondary = own set, alpha=0
               (mpi_svm_main3.cpp:628-655)
      - star:  primary = rank 0's own SVs (warm), secondary = the workers'
               SVs, alpha reset to 0 (mpi_svm_main2.cpp:596-604)
      - round start: primary = the broadcast global SVs (warm), secondary
               = the local partition (mpi_svm_main2.cpp:481-502)

    Returns (merged buffer of capacity cap_out, pre-truncation count);
    count > cap_out means rows were dropped.
    """
    cat = SVBuffer(
        X=torch.cat([primary.X, secondary.X]),
        Y=torch.cat([primary.Y, secondary.Y]),
        alpha=torch.cat([primary.alpha, torch.zeros_like(secondary.alpha)]),
        ids=torch.cat([primary.ids, secondary.ids]),
        valid=torch.cat([primary.valid, secondary.valid]),
    )
    return compact(dedup_first(cat), cap_out)


def extract_svs(train: SVBuffer, alpha: torch.Tensor, sv_tol: float,
                cap_out: int) -> Tuple[SVBuffer, int]:
    """Keep the rows with alpha > sv_tol (get_SV_indices, main3.cpp:297-304).

    alpha is stored in X's dtype, as the JAX function stores it: with f32
    features and f64 accumulators the warm-start alpha between rounds is
    f32. Returns (SV buffer of capacity cap_out, pre-truncation SV count).
    """
    alpha = alpha.to(train.X.device)
    is_sv = train.valid & (alpha > sv_tol)
    buf = SVBuffer(X=train.X, Y=train.Y, alpha=alpha.to(train.X.dtype),
                   ids=train.ids, valid=is_sv)
    return compact(buf, cap_out)
