"""Finds a cell's parts by the names BENCHMARK.json gives them: one file
each, so that a later change adds a configuration, a traffic mix, a
metric or an entry as a new file and edits none.

  configs/<config>.json   the configuration as it is run
  traffic/<mix>.json      a traffic mix: which entry, with its parameters
  limits/<cell>.json      the limit of each number the check compares
  entries/<entry>.py      the work a traffic mix drives (set-up, unit)
  metrics/<metric>.py     one metric's reader

`search` lists further directories laid out the same way, looked in
before this package's own.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Iterable, Optional

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
SUFFIX = {"configs": ".json", "traffic": ".json", "limits": ".json",
          "entries": ".py", "metrics": ".py"}


def find(kind: str, name: str, search: Iterable = ()) -> Path:
    """The file of `name` under `kind`: the first of search's directories
    that holds it, else this package's."""
    for root in (*map(Path, search), ROOT):
        path = root / kind / f"{name}{SUFFIX[kind]}"
        if path.is_file():
            return path
    raise LookupError(f"no {kind[:-1] if kind != 'traffic' else kind} "
                      f"named {name!r} ({kind}/{name}{SUFFIX[kind]})")


def load_json(kind: str, name: str, search: Iterable = ()) -> dict:
    return json.loads(find(kind, name, search).read_text())


def load_module(kind: str, name: str, search: Iterable = ()):
    """The module of `name` under `kind`, imported from its file."""
    path = find(kind, name, search)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(path: Optional[Path] = None) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LookupError(f"no workload named {name!r} in BENCHMARK.json")
