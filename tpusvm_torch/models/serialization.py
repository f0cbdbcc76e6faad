"""Model persistence: the JAX package's v4 `.npz` artifact, both ways.

A binary exact-RBF state: sv_X, sv_Y, sv_alpha, sv_ids, b, scale,
scaler_min/scaler_max (when scaled), the training-provenance fields
train_precision/shrink_every/shrink_stable, and the hyperparameters as
config_<field> entries, with format_version = 4. The same keys and dtypes
are written and read, so a model saved by either package loads and scores
in the other. Writes are atomic (temp file + os.replace).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import numpy as np

from tpusvm_torch.config import SVMConfig

FORMAT_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)

# state keys of artifacts this slice cannot score
_LATER_SLICE_KEYS = {
    "classes": "one-vs-rest models",
    "task": "epsilon-SVR models",
    "map_n_features_in": "approximate-kernel models",
}


def _norm(path: str) -> str:
    # np.savez appends ".npz" to suffix-less paths
    return path if path.endswith(".npz") else path + ".npz"


def save_model(path: str, state: Dict[str, Any], config: SVMConfig) -> None:
    out = _norm(path)
    tmp = out + ".tmp.npz"
    np.savez_compressed(
        tmp,
        format_version=FORMAT_VERSION,
        **state,
        **{f"config_{k}": v for k, v in dataclasses.asdict(config).items()},
    )
    os.replace(tmp, out)


def load_model(path: str) -> Tuple[Dict[str, np.ndarray], SVMConfig]:
    """(state dict, SVMConfig) of a binary exact-RBF artifact.

    Config fields this port does not carry (degree, coef0, ...) are
    ignored; an unknown version, or an artifact of a kind this slice does
    not score, fails here with a specific error.
    """
    with np.load(_norm(path), allow_pickle=False) as z:
        if "format_version" not in z.files:
            raise ValueError(
                f"{_norm(path)!r} has no format_version field — not a "
                "tpusvm model artifact"
            )
        version = int(z["format_version"])
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported model format version {version} in "
                f"{_norm(path)!r}: this build reads versions "
                f"{list(SUPPORTED_VERSIONS)}"
            )
        fields = {f.name: f.type for f in dataclasses.fields(SVMConfig)}
        cfg = {}
        state = {}
        for key in z.files:
            if key == "format_version":
                continue
            if key.startswith("config_"):
                name = key[len("config_"):]
                if name in fields:
                    val = z[key].item()
                    ftype = fields[name]
                    cfg[name] = (int(val) if ftype == "int" else
                                 float(val) if ftype == "float" else str(val))
            else:
                state[key] = z[key]
    for key, what in _LATER_SLICE_KEYS.items():
        if key in state:
            raise NotImplementedError(
                f"{_norm(path)!r} holds one of the {what}; this slice of "
                "the port scores binary exact-RBF classifiers only"
            )
    return state, SVMConfig(**cfg)
