"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the imports, the port's kernel libraries (built under the
checkout's build/tpusvm_torch on its first run, loaded after), the
data from the seed, the cell's entry set up and one warm-up unit of
work at the cell's own shapes. The window: units back to back until
`--seconds` have passed, ending at a unit's end. With --trace 1 the
window runs under torch.profiler and the run reports the cell's
per-layer metrics instead of its end-to-end ones. Then the device's
peak memory is read, the program's state freed, and what the window
produced is judged by the reference (reference/check.py). The last line
of standard output is the result, one JSON object; the numbers the
check compared, each beside its limit, end standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

from perfbench.core import devtrace, registry
from perfbench.core.generate import make_data
from perfbench.core.spans import Spans

# top-level module names that must not be loaded: the JAX package the
# port came from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusvm")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a metric's reader reads: the cell, the window's units (their
    counters and host phases), the spans, the device trace (or None),
    and the shapes."""

    def __init__(self, cell, cfg, traffic, units, spans, trace, window_s,
                 setup_s, power):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.units, self.spans, self.trace = units, spans, trace
        self.window_s, self.setup_s, self.power = window_s, setup_s, power
        self.n_units = len(units)
        self.n = int(cfg["data"]["n_train"])
        self.d = int(cfg["data"]["d"])
        q = int(cfg["solver"]["opts"]["q"])
        self.q = min(q, self.n if self.n % 2 == 0 else self.n - 1)

    def note(self, msg: str) -> None:
        log(msg)


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_for(bench: dict, cell: str, trace: int) -> list:
    """The BENCHMARK.json metric entries this run reports: the cell's
    end-to-end metrics untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def log_means(records: list, spans: Spans) -> None:
    """The window's host phases (the program's and the harness's spans)
    and counters, mean a unit, on standard error."""
    n = len(records)
    phases, counts = {}, {}
    for r in records:
        for k, v in r["phases"].items():
            phases[k] = phases.get(k, 0.0) + v / n
        for k, v in r["counters"].items():
            counts[k] = counts.get(k, 0.0) + (v or 0) / n
    for name, a, b in spans.spans:
        if not name.startswith("fit."):
            phases[name] = phases.get(name, 0.0) + (b - a) / n
    if phases:
        log("host phases, mean a unit: " + ", ".join(
            f"{k} {v:.6f}" for k, v in phases.items()))
    log("counters, mean a unit: " + ", ".join(
        f"{k} {v:.6g}" for k, v in counts.items()))


def breakdown(trace, spans) -> dict:
    """The device operations that took most time, and the idle time of
    the device by the host span it fell in (the innermost span holding
    the gap's middle; "harness" outside every span)."""
    secs, _ = devtrace.by_kernel(trace)
    ops = sorted(secs.items(), key=lambda kv: -kv[1])[:10]
    idle = {}
    gaps = devtrace.idle_gaps(trace)
    ordered = sorted(spans.spans, key=lambda s: s[2] - s[1])
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = next((n for n, a, b in ordered if a <= mid <= b), "harness")
        idle[name] = idle.get(name, 0.0) + (e - s)
        named.append((name, e - s))
    for name, g in named[:5]:
        log(f"idle gap: {g:.6f} s in {name}")
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def main(argv=None, *, t_start=None, device=None, search=(),
         bench=None) -> int:
    """Run one cell once; returns the exit code. device=None looks for
    the chips the cell asks for and refuses to run without them; a test
    passes device="cpu" to drive the rest of a run on the CPU, and
    `search` and `bench` to run parts of its own."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = bench or registry.benchmark()
    w = registry.cell(bench, args.workload)
    cfg = registry.load_json("configs", w["config"], search)
    traffic = registry.load_json("traffic", w["traffic"], search)
    limits = registry.load_json("limits", w["name"], search)
    entry = registry.load_module("entries", traffic["entry"], search)
    wanted = [(m, registry.load_module("metrics", m["name"], search))
              for m in metrics_for(bench, w["name"], args.trace)]

    t = time.perf_counter()
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(w["chips"]):
            log(f"{w['name']} needs {w['chips']} CUDA device(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, device_count {have}")
            return 2
        device = "cuda"
    cuda = device == "cuda"
    import tpusvm_torch  # noqa: F401  the system under test

    split = {"import_s": time.perf_counter() - t}
    t = time.perf_counter()
    built = {}
    if cuda:
        from tpusvm_torch.ops.cuda import _build

        built = _build.build_all(entry.LIBRARIES)
        for name in entry.LIBRARIES:
            _build.load(name)
    split["libraries_s"] = time.perf_counter() - t
    t = time.perf_counter()
    data = make_data(cfg, args.seed)
    data["seed"] = args.seed
    split["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = entry.setup(cfg, traffic, data, device)
    entry.unit(state, Spans(enabled=False))
    if cuda:
        torch.cuda.synchronize()
    split["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f", total {setup_s:.3f} s; nvcc builds "
        + (", ".join(f"{k} {v:.1f} s" for k, v in built.items() if v)
           or "none"))

    spans = Spans(enabled=bool(args.trace))
    prof = None
    if args.trace and cuda:
        prof, anchor = devtrace.start()
    records, unit_s = [], []
    t0 = t1 = time.perf_counter()
    while t1 - t0 < args.seconds:
        rec = entry.unit(state, spans)
        if cuda:
            torch.cuda.synchronize()
        records.append(rec)
        t, t1 = t1, time.perf_counter()
        unit_s.append(t1 - t)
    window_s = t1 - t0
    trace = None
    if prof is not None:
        t = time.perf_counter()
        trace = devtrace.stop(prof, anchor, t0, t1)
        log(f"trace: {len(trace.ops)} device operations read in "
            f"{time.perf_counter() - t:.3f} s")
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"window: {len(records)} units in {window_s:.6f} s; unit seconds "
        f"min {min(unit_s):.6f}, median {float(np.median(unit_s)):.6f}, "
        f"max {max(unit_s):.6f}")

    log_means(records, spans)

    # the program's state goes before the reference runs
    units = [{"counters": r["counters"], "phases": r["phases"]}
             for r in records]
    answers = [entry.answers(cfg, traffic, data, r) for r in records]
    del records, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from perfbench.reference.check import compare

    t = time.perf_counter()
    numbers = compare(cfg, traffic, data, answers, args.seed, device,
                      log=log)
    log(f"check: {numbers.pop('lanes')} distinct answers judged in "
        f"{time.perf_counter() - t:.3f} s")
    failed = sum(1 for a in answers
                 if any(x["status"] != "CONVERGED" for x in a))
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits}
    correct = bool(answers) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    power = ""
    if cuda:
        from perfbench.core import peaks

        power = peaks.power_limit()
        log(f"card: {power}")
    run = Run(w["name"], cfg, traffic, units, spans, trace, window_s,
              setup_s, power)
    metrics = {}
    for m, module in wanted:
        v = module.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = devtrace.busy_seconds(trace)
        dev["window_s"] = trace.window_s
        result["breakdown"] = breakdown(trace, spans)
    bad = forbidden_modules()
    if bad:
        log(f"refused: modules {bad} are loaded in the process that "
            "reports the result")
        return 3
    result["checks"] = checks
    for k in numbers:
        if k not in checks:
            log(f"reading {k}: {numbers[k]!r} (not compared in this cell)")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
