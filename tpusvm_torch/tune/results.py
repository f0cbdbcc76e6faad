"""Versioned persistence for tune runs.

The port's copy of the JAX package's tpusvm/tune/results.py (stdlib
only): the same kind, format version, fields and JSON layout, so a
results file written by either package loads in the other and
format_table prints the same text for it.

Model artifacts are .npz with a format_version gate
(models/serialization.py); tune results follow the same philosophy in
JSON — the artifact is a TABLE (per-point metrics) plus a verdict (the
winner), both human-greppable, and it must fail loudly and specifically
when a future tpusvm reads an old file or vice versa. `tpusvm info` knows
how to pretty-print these.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List

# v2: the kernel-family search axis — results gain a `kernels` list, rows
# and the winner carry kernel/degree/coef0 (tpusvm.kernels). Old v1 files
# fail the version gate with the standard "different tpusvm" message.
_FORMAT_VERSION = 2
_KIND = "tpusvm-tune-result"


@dataclasses.dataclass
class TuneResult:
    """Everything a tune run decided and measured.

    points: one dict per grid point, in solve (snake) order:
      C, gamma, status (TuneStatus name), rung (last rung the point was
      fit at; -1 if never fit), n_subset (training rows per fold at that
      rung), cv_accuracy (mean over folds; None if never fit),
      fold_accuracy (per-fold list), sv_count (mean over folds),
      n_updates (total SMO alpha updates across folds), wall_s,
      warm_seeded (how many of the fold fits started from a donor seed).
    winner: {C, gamma, cv_accuracy} — the argmax of cv_accuracy at the
      final rung, ties broken by solve order (first wins), so reruns and
      cold/warm A/Bs agree deterministically.
    """

    schedule: str
    grid: Dict[str, List[float]]
    folds: int
    seed: int
    n: int
    d: int
    warm_start: bool
    kernels: List[Dict[str, Any]]
    points: List[Dict[str, Any]]
    winner: Dict[str, Any]
    total_updates: int
    wall_s: float
    # batched fleet dispatch (tpusvm.fleet) — defaulted so results
    # written before the fleet existed still load
    fleet: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format_version": _FORMAT_VERSION,
            "kind": _KIND,
            **dataclasses.asdict(self),
        }


def save_tune_result(path: str, result: TuneResult) -> None:
    """Atomic write (temp + os.replace): a deploy/warm-start reader
    racing a re-tune sees the old complete result or the new one,
    never a torn half-written JSON."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(result.to_dict(), fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)


def load_tune_result(path: str) -> TuneResult:
    """Version gate first, same contract as model loading: a missing
    kind/version means "not a tpusvm tune result", an unknown version means
    "written by a different tpusvm" — neither may surface as a KeyError
    from whichever field is read first."""
    with open(path) as fh:
        raw = json.load(fh)
    if not isinstance(raw, dict) or raw.get("kind") != _KIND:
        raise ValueError(
            f"{path!r} is not a tpusvm tune-results file (missing "
            f"kind={_KIND!r})"
        )
    if "format_version" not in raw:
        raise ValueError(
            f"{path!r} has no format_version field — written before "
            "format versioning; re-run the tune"
        )
    version = int(raw["format_version"])
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported tune-results format version {version} in "
            f"{path!r}: this build reads version {_FORMAT_VERSION}"
        )
    fields = {f.name for f in dataclasses.fields(TuneResult)}
    required = {
        f.name for f in dataclasses.fields(TuneResult)
        if f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    }
    missing = required - set(raw)
    if missing:
        raise ValueError(
            f"{path!r} is missing tune-result fields {sorted(missing)}"
        )
    return TuneResult(**{k: raw[k] for k in fields if k in raw})


def format_table(result: TuneResult) -> str:
    """Human-readable run summary: header, winner, per-point table.

    Shared by `tpusvm tune` (after a run) and `tpusvm info <results.json>`
    (re-reading a committed artifact), so both always agree on what a run
    looked like.
    """
    g = result.grid
    families = "+".join(k["kernel"] for k in result.kernels)
    lines = [
        f"tune: schedule={result.schedule} grid="
        f"{len(g['C_values'])}x{len(g['gamma_values'])} "
        f"kernels={families} "
        f"folds={result.folds} seed={result.seed} "
        f"n={result.n} d={result.d} "
        f"warm_start={'on' if result.warm_start else 'off'}",
        f"winner: kernel={result.winner.get('kernel', 'rbf')} "
        f"C={result.winner['C']:g} "
        f"gamma={result.winner['gamma']:g} "
        f"cv_accuracy={result.winner['cv_accuracy']:.6f}",
        f"total SMO updates: {result.total_updates}   "
        f"wall: {result.wall_s:.2f}s",
        f"{'kernel':>7} {'C':>10} {'gamma':>12} {'status':>10} {'rung':>4} "
        f"{'cv_acc':>8} {'sv':>7} {'updates':>8} {'warm':>4} "
        f"{'wall_s':>7}",
    ]
    for r in result.points:
        acc = "-" if r["cv_accuracy"] is None else f"{r['cv_accuracy']:.4f}"
        sv = "-" if r["sv_count"] is None else f"{r['sv_count']:.1f}"
        lines.append(
            f"{r.get('kernel', 'rbf'):>7} "
            f"{r['C']:>10g} {r['gamma']:>12g} {r['status']:>10} "
            f"{r['rung']:>4} {acc:>8} {sv:>7} {r['n_updates']:>8} "
            f"{r['warm_seeded']:>4} {r['wall_s']:>7.2f}"
        )
    return "\n".join(lines)


def is_tune_result(path: str) -> bool:
    """Cheap sniff (no validation): is this file a tune-results JSON?
    Used by `tpusvm info` to dispatch between artifact kinds."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(4096)
        return _KIND.encode() in head
    except OSError:
        return False
