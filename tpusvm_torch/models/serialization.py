"""Model persistence: the JAX package's `.npz` artifact (v1-v4), both ways.

One `.npz` holds everything scoring needs, with format_version = 4:
  - binary classifiers: sv_X, sv_Y, sv_alpha, sv_ids, b, scale,
    scaler_min/scaler_max (when scaled), platt_a/platt_b (when
    calibrated), and the provenance fields train_precision, shrink_every
    and shrink_stable;
  - one-vs-rest classifiers: classes, sv_X (the union of the heads'
    SVs), coef (K, n_sv), b (K,), sv_ids, scale and the scaler;
  - epsilon-SVR: task = "svr", sv_X, sv_coef (signed), sv_ids, b, scale
    and the scaler;
  - the hyperparameters as config_<field> entries (kernel, degree, coef0
    and epsilon since v2).
The same keys and dtypes are written and read, so a model saved by either
package loads and scores in the other. Writes are atomic (temp file +
os.replace). Artifacts of the approximate families (map_* keys) are
refused: their feature maps are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import numpy as np

from tpusvm_torch.config import APPROX_FAMILIES, KERNEL_FAMILIES, SVMConfig

FORMAT_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)

# state keys of artifacts this port cannot score yet
_LATER_SLICE_KEYS = {
    "map_n_features_in": "approximate-kernel models",
}


def _norm(path: str) -> str:
    # np.savez appends ".npz" to suffix-less paths
    return path if path.endswith(".npz") else path + ".npz"


def model_task(path: str) -> str:
    """Artifact kind: "ovr" (carries `classes`), "svr" (a `task` marker)
    or "svc" (everything else, every v1 file included)."""
    with np.load(_norm(path), allow_pickle=False) as z:
        if "classes" in z.files:
            return "ovr"
        if "task" in z.files:
            return str(z["task"].item())
    return "svc"


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
    """(state dict, SVMConfig) of an artifact of any kind the port scores.

    Config fields this port does not carry (rff_dim, map_seed, ...) are
    ignored, and fields a v1 file predates take their defaults (the RBF
    family). An unknown version or kernel family, or an approximate-kernel
    artifact, fails here with a specific error.
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
    family = cfg.get("kernel", "rbf")
    if family not in KERNEL_FAMILIES:
        raise ValueError(
            f"{_norm(path)!r} names kernel family {family!r}, which this "
            f"build does not implement (supported: {list(KERNEL_FAMILIES)})"
        )
    for key, what in _LATER_SLICE_KEYS.items():
        if key in state or family in APPROX_FAMILIES:
            raise NotImplementedError(
                f"{_norm(path)!r} holds one of the {what}; their feature "
                "maps are not ported yet (ROADMAP Queue 1 item 10)"
            )
    return state, SVMConfig(**cfg)
