"""Flatten a build's cost and memory accounting into plain floats.

The port's copy of tpusvm/obs/costs.py. The compile observatory
(obs/prof.py) writes one `compile_record` per CUDA graph capture and per
nvcc build, in the JAX package's record shape, so `report`'s compile table
renders either package's records unchanged. A `compiled` object may offer
`cost_analysis()` (FLOPs, "bytes accessed") and `memory_analysis()`; the
port's builds offer neither, so their records read cost_available false,
never zeros a dashboard would read as "free".

The derived figure is ARITHMETIC INTENSITY (FLOPs per byte accessed), the
roofline x-axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# cost_analysis keys, the JAX package's spelling (spaces included)
_FLOPS_KEY = "flops"
_BYTES_KEY = "bytes accessed"


def _as_entries(raw: Any):
    """cost_analysis() may return a dict or a list of dicts (one per
    computation); normalise to a list of dicts."""
    if raw is None:
        return []
    if isinstance(raw, dict):
        return [raw]
    if isinstance(raw, (list, tuple)):
        return [e for e in raw if isinstance(e, dict)]
    return []


def cost_summary(compiled) -> Dict[str, Any]:
    """{"available", "flops", "bytes_accessed"} for one executable.

    available=False (values None) when the backend provides no cost
    model — the caller must SAY so (`cost_analysis: unavailable`), never
    silently report zeros a dashboard would read as "free"."""
    try:
        entries = _as_entries(compiled.cost_analysis())
    except Exception:  # noqa: BLE001 — any backend refusal means "absent"
        entries = []
    flops = bytes_accessed = None
    for e in entries:
        if _FLOPS_KEY in e:
            flops = (flops or 0.0) + float(e[_FLOPS_KEY])
        if _BYTES_KEY in e:
            bytes_accessed = (bytes_accessed or 0.0) + float(e[_BYTES_KEY])
    return {
        "available": flops is not None or bytes_accessed is not None,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
    }


def memory_summary(compiled) -> Dict[str, Any]:
    """{"available", "arg_bytes", "out_bytes", "temp_bytes",
    "code_bytes"} from memory_analysis(), where the backend provides it."""
    try:
        mem = compiled.memory_analysis()
    except Exception:  # noqa: BLE001
        mem = None
    if mem is None:
        return {"available": False, "arg_bytes": None, "out_bytes": None,
                "temp_bytes": None, "code_bytes": None}

    def _get(*names):
        for n in names:
            v = getattr(mem, n, None)
            if v is not None:
                return float(v)
        return None

    return {
        "available": True,
        "arg_bytes": _get("argument_size_in_bytes"),
        "out_bytes": _get("output_size_in_bytes"),
        "temp_bytes": _get("temp_size_in_bytes"),
        "code_bytes": _get("generated_code_size_in_bytes"),
    }


def arithmetic_intensity(flops: Optional[float],
                         bytes_accessed: Optional[float]) -> Optional[float]:
    """FLOPs per byte accessed (the roofline x-coordinate), or None when
    either side is unknown or the byte count is zero."""
    if flops is None or not bytes_accessed:
        return None
    return flops / bytes_accessed


def compile_record(name: str, lower_s: float, compile_s: float,
                   compiled=None, **extra: Any) -> Dict[str, Any]:
    """One flat JSON-able record describing a compile: timings + cost +
    memory + arithmetic intensity. The shared shape written to trace
    events (`prof.compile`) and rendered by the report's compile table."""
    rec: Dict[str, Any] = {
        "executable": name,
        "lower_s": float(lower_s),
        "compile_s": float(compile_s),
    }
    cost = (cost_summary(compiled) if compiled is not None
            else {"available": False, "flops": None, "bytes_accessed": None})
    rec["cost_available"] = cost["available"]
    rec["flops"] = cost["flops"]
    rec["bytes_accessed"] = cost["bytes_accessed"]
    rec["arith_intensity"] = arithmetic_intensity(cost["flops"],
                                                  cost["bytes_accessed"])
    mem = (memory_summary(compiled) if compiled is not None
           else {"available": False})
    if mem["available"]:
        rec["arg_bytes"] = mem["arg_bytes"]
        rec["out_bytes"] = mem["out_bytes"]
        rec["temp_bytes"] = mem["temp_bytes"]
    rec.update(extra)
    return rec
