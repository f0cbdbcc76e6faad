"""Durable pod round-state checkpoint (fault point ``pod.merge``).

The port of tpusvm/pod/state.py. The cascade's inter-round state — the
global SV buffer, the previous round's ID set, b — staged to a ``.tmp``
sibling and committed by ``fsync_replace`` (flush THEN rename), so a kill
at any instant leaves either the previous complete checkpoint or the new
one, never a torn file. The keys and dtypes are the JAX package's, so a
file written by either package loads in the other.

The stored config (n_leaves, topology) is checked on resume: a
checkpoint written under a different partitioning or merge topology is
refused with a config error instead of silently walking a different
cascade.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusvm_torch import faults
from tpusvm_torch.parallel.svbuffer import SVBuffer
from tpusvm_torch.utils.durable import fsync_replace

POD_CKPT_VERSION = 1


def save_pod_round_state(path: str, global_sv: SVBuffer, prev_ids,
                         rnd: int, b: float, n_leaves: int,
                         topology: str) -> None:
    """Atomically commit one round's inter-round state."""
    faults.point("pod.merge", path=path, round=rnd)
    # the JAX package's staging name (np.savez appends .npz to path.tmp)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        ckpt_version=POD_CKPT_VERSION,
        round=rnd,
        b=b,
        prev_ids=np.asarray(sorted(prev_ids), np.int32),
        n_leaves=n_leaves,
        topology=topology,
        sv_X=global_sv.X.cpu().numpy(),
        sv_Y=global_sv.Y.cpu().numpy(),
        sv_alpha=global_sv.alpha.cpu().numpy(),
        sv_ids=global_sv.ids.cpu().numpy(),
        sv_valid=global_sv.valid.cpu().numpy(),
    )
    fsync_replace(tmp, path)


def check_pod_round_state_config(path: str, n_leaves: int,
                                 topology: str) -> None:
    """Refuse a checkpoint written under a different pod config."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["n_leaves"]) != n_leaves:
            raise ValueError(
                f"pod checkpoint config mismatch: it was written for "
                f"n_leaves={int(z['n_leaves'])}, this run partitions "
                f"into {n_leaves}; resume with the original leaf count "
                "or start fresh without resume"
            )
        if str(z["topology"]) != topology:
            raise ValueError(
                f"pod checkpoint config mismatch: it was written for "
                f"topology={str(z['topology'])!r}, this run uses "
                f"{topology!r}; resume with the original topology or "
                "start fresh without resume"
            )


def load_pod_round_state(path: str, dtype=torch.float32, device="cpu"):
    """(global_sv: SVBuffer on `device`, prev_ids: set, next_round: int, b).

    alpha keeps its stored dtype: in mixed-precision runs it is float64
    between rounds, and truncating it would make the resumed trajectory
    leave the uninterrupted one."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["ckpt_version"]) != POD_CKPT_VERSION:
            raise ValueError(
                f"unsupported pod checkpoint version "
                f"{int(z['ckpt_version'])}"
            )
        buf = SVBuffer(
            X=torch.as_tensor(z["sv_X"]).to(device=device, dtype=dtype),
            Y=torch.as_tensor(z["sv_Y"]).to(device),
            alpha=torch.as_tensor(z["sv_alpha"]).to(device),
            ids=torch.as_tensor(z["sv_ids"]).to(device),
            valid=torch.as_tensor(z["sv_valid"]).to(device),
        )
        return (
            buf,
            set(z["prev_ids"].tolist()),
            int(z["round"]) + 1,
            float(z["b"]),
        )
