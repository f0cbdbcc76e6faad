"""Restart robustness: the bucket-signature manifest and the serialized
registry state.

  * **serve_state.json** (`save_serve_state` / `load_serve_state`): every
    hosted model's source path and current generation, the bound HTTP
    address and the replica id, written atomically after each successful
    load or swap. The bytes are the JAX package's (tpusvm/serve/cache.py:
    `sort_keys`, `indent=1`, the same keys and `format_version`), so a
    state file written by either package restores in the other.
    `serve --state serve_state.json` restores the full model set on
    restart, generations continuing where they left off.

  * **a bucket-signature manifest** (`tpusvm_cache_manifest.json` inside
    the cache dir): which (model config, bucket) programs this deployment
    has built, with the torch and CUDA versions and the card that built
    them.

The JAX package's persistent XLA compilation cache has no counterpart
here: a CUDA graph is a capture of launches into device memory of this
process and cannot be written to disk. What persists is the manifest. So
in the port `--cache-dir DIR` (or TPUSVM_CACHE_DIR) names the manifest's
directory, each warm-up records its bucket signatures there, and
`--assert-cached` fails the run unless every bucket signature it built was
already in DIR's manifest when the run started: the restart gate says "this
replica serves exactly the programs an earlier run of this deployment
built", not "nothing was built" (every run captures its graphs, about a
millisecond a bucket).

The manifest and state reads sit behind the ``cache.read`` injection
point with the shared retry policy: a transiently unreadable manifest is
retried, a corrupt one is counted and treated as absent (the manifest is
provenance; refusing to serve over it would turn it into an availability
hazard), and a SimulatedKill dies exactly like a real one.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

CACHE_MANIFEST_NAME = "tpusvm_cache_manifest.json"
CACHE_MANIFEST_VERSION = 1
SERVE_STATE_VERSION = 1


# ------------------------------------------------- bucket-signature manifest
def bucket_signature(entry, bucket: int, block: int) -> str:
    """Stable provenance key of one (model config, bucket) program: the
    scorer kind and kernel statics, the operand shapes (bucket, features,
    SV count) and the dtype, in the JAX package's layout. The versions and
    the card are recorded manifest-wide, not per key."""
    cfg = entry.config
    parts = [
        entry.kind, cfg.kernel, f"deg{cfg.degree}", f"b{bucket}",
        f"blk{block}", f"d{entry.n_features}", f"sv{entry.n_sv}",
        str(entry.dtype).replace("torch.", ""),
    ]
    if entry.fmap is not None:
        parts.append(f"map{entry.fmap.dim}")
    return ":".join(parts)


def _versions() -> dict:
    import torch

    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": card}


def read_cache_manifest(cache_dir: str) -> dict:
    """The signature manifest in `cache_dir` ({} signatures when absent).

    Behind the retried ``cache.read`` fault point. A corrupt manifest is
    counted (`serve.cache_manifest_invalid`) and treated as absent."""
    from tpusvm_torch import faults
    from tpusvm_torch.obs.registry import default_registry

    path = os.path.join(cache_dir, CACHE_MANIFEST_NAME)

    def _read():
        faults.point("cache.read", path=path)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    retry = faults.Retry(faults.DEFAULT_IO_POLICY, op="cache.read")
    raw = retry(_read)
    empty = {"format_version": CACHE_MANIFEST_VERSION,
             "versions": _versions(), "signatures": {}}
    if raw is None:
        return empty
    try:
        obj = json.loads(raw)
        if obj.get("format_version") != CACHE_MANIFEST_VERSION:
            raise ValueError(
                f"manifest format_version {obj.get('format_version')!r}"
            )
        if not isinstance(obj.get("signatures"), dict):
            raise ValueError("manifest has no signatures dict")
    except ValueError:
        default_registry().counter("serve.cache_manifest_invalid").inc()
        return empty
    return obj


def record_signatures(cache_dir: str, signatures) -> dict:
    """Merge `signatures` (bucket_signature strings) into the manifest and
    write it atomically; returns the merged manifest."""
    from tpusvm_torch import faults

    os.makedirs(cache_dir, exist_ok=True)
    manifest = read_cache_manifest(cache_dir)
    for sig in signatures:
        manifest["signatures"].setdefault(sig, _versions())
    manifest["versions"] = _versions()
    path = os.path.join(cache_dir, CACHE_MANIFEST_NAME)
    faults.point("serve.state_write", path=path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, sort_keys=True, indent=1)
    os.replace(tmp, path)
    return manifest


# ----------------------------------------------------------- serve state
def save_serve_state(path: str, models: Dict[str, dict],
                     cache_dir: Optional[str] = None,
                     address: Optional[str] = None,
                     replica_id: Optional[str] = None) -> None:
    """Atomically persist the registry manifest.

    `models` maps name -> {"path": source .npz, "generation": int}; only
    path-backed entries can be restored (in-process add_model entries are
    recorded with path=None so the restore names what it cannot bring
    back). `address` records the ACTUAL bound HTTP host:port (`serve
    --port 0` picks it at bind time) and `replica_id` the replica's
    identity; readers tolerate both being absent."""
    from tpusvm_torch import faults

    state = {
        "format_version": SERVE_STATE_VERSION,
        "cache_dir": cache_dir,
        "models": models,
    }
    if address is not None:
        state["address"] = address
    if replica_id is not None:
        state["replica_id"] = replica_id
    faults.point("serve.state_write", path=path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, sort_keys=True, indent=1)
    os.replace(tmp, path)


def load_serve_state(path: str) -> dict:
    """Read and validate a serve_state.json (cache.read fault point +
    retries). Raises ValueError naming the path for anything that parses
    but is not a serve state; a missing file raises FileNotFoundError (the
    caller decides whether that means a fresh start)."""
    from tpusvm_torch import faults

    def _read():
        faults.point("cache.read", path=path)
        with open(path) as f:
            return f.read()

    retry = faults.Retry(faults.DEFAULT_IO_POLICY, op="cache.read")
    raw = retry(_read)
    try:
        obj = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"serve state {path!r} is not valid JSON: {e}")
    if not isinstance(obj, dict) or "format_version" not in obj:
        raise ValueError(
            f"{path!r} is not a tpusvm serve state (no format_version)"
        )
    v = obj["format_version"]
    if v != SERVE_STATE_VERSION:
        raise ValueError(
            f"unsupported serve state format_version {v!r} (this build "
            f"reads version {SERVE_STATE_VERSION})"
        )
    if not isinstance(obj.get("models"), dict):
        raise ValueError(f"serve state {path!r} has no models dict")
    return obj
