"""Length-prefixed framed messages over stdlib sockets.

The port's copy of tpusvm/pod/protocol.py (numpy and the stdlib only). The
pod tier's wire format — the reference's MPI_Send/MPI_Recv pairs
(mpi_svm_main3.cpp tags 10-24) become one framed request/reply shape:

    [4-byte BE frame length] [4-byte BE meta length] [meta JSON] [npz]

The npz section is a standard uncompressed ``np.savez`` archive of the
message's arrays (empty when a message carries none), so dtypes and
shapes round-trip exactly: an SV buffer shipped through a frame comes
back bit-identical, which is what keeps the pod cascade's dedup-by-ID
merges and its ID-set convergence test byte-equal to the in-process
cascade. Meta is a small JSON object (op names, counts, scalars), encoded
with sorted keys, so a frame is the JAX package's byte for byte for the
same meta and arrays (the zip entries carry the current second, as
``np.savez`` writes them in both).

Framing is explicit-length on purpose: a worker SIGKILLed mid-write
leaves a SHORT frame, which the reader surfaces as ConnectionError
(peer death), never as a truncated-but-parsed message. A frame's meta may
carry a trace context under ``ctx`` (attach_ctx/extract_ctx): a TRAIN
frame names the coordinator's open pod.round span, under which the
worker's span re-parents in the merged report.
"""

from __future__ import annotations

import io
import json
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np

#: refuse absurd frames (corrupt length prefix) before allocating
MAX_FRAME_BYTES = 1 << 31


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError (peer died)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def send_msg(sock: socket.socket, meta: dict,
             arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Send one framed message: meta JSON + optional npz array section."""
    mb = json.dumps(meta, sort_keys=True).encode()
    if arrays:
        bio = io.BytesIO()
        np.savez(bio, **arrays)
        ab = bio.getvalue()
    else:
        ab = b""
    frame = struct.pack(">I", len(mb)) + mb + ab
    sock.sendall(struct.pack(">I", len(frame)) + frame)


def attach_ctx(meta: dict, ctx) -> dict:
    """Return a copy of meta carrying a TraceContext under ``ctx``.

    No-op passthrough when ctx is None, so call sites don't branch."""
    if ctx is None:
        return meta
    out = dict(meta)
    out["ctx"] = ctx.to_dict()
    return out


def extract_ctx(meta: dict):
    """The TraceContext carried in a frame's meta, or None (absent key,
    pre-ctx peer, or malformed payload — never an exception)."""
    from tpusvm_torch.obs.trace import TraceContext

    return TraceContext.from_dict(meta.get("ctx"))


def recv_msg(sock: socket.socket
             ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Receive one framed message -> (meta, arrays)."""
    (total,) = struct.unpack(">I", _recv_exact(sock, 4))
    if total < 4 or total > MAX_FRAME_BYTES:
        raise ConnectionError(f"bad frame length {total}")
    frame = _recv_exact(sock, total)
    (mlen,) = struct.unpack(">I", frame[:4])
    if mlen > total - 4:
        raise ConnectionError(
            f"bad meta length {mlen} in {total}-byte frame"
        )
    meta = json.loads(frame[4:4 + mlen].decode())
    blob = frame[4 + mlen:]
    arrays: Dict[str, np.ndarray] = {}
    if blob:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    return meta, arrays
