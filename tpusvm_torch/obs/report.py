"""Render telemetry back into the reference's human-readable contracts.

The port's copy of tpusvm/obs/report.py: every formatter renders the same
text from the same records, so a trace written by either package reads in
the other's `report`.

`render_phase_lines` is the single render path for end-of-run timing (the
reference's `<phase> time: X.XXX s` lines in first-entry order, then
`elapsed time:`): PhaseTimer.report() (live runs) and `report` (trace
files) both call it.

`render_report` is the `python -m tpusvm_torch report TRACE...` body: the
phase summary rebuilt from phase spans, the compile table from prof.compile
events (CUDA graph captures and nvcc builds), the convergence-gap table from
convergence.round events, the autopilot's drift decisions, the
cross-process timeline of a merged directory (pod workers, serve replicas)
and any embedded metrics snapshots' non-zero counters.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def render_phase_lines(acc: Dict[str, float], total: float) -> str:
    """The reference's end-of-run timing block (SURVEY.md §5.1)."""
    lines = [f"{name} time: {secs:.3f} s" for name, secs in acc.items()]
    lines.append(f"elapsed time: {total:.3f} s")
    return "\n".join(lines)


def phase_summary(records: Iterable[dict]) -> Tuple[Dict[str, float], float]:
    """(accumulated phase durations in first-entry order, total seconds)
    from trace records.

    Phases are spans written with attrs.phase=True (PhaseTimer). Total
    comes from the `end` record when present, else the span envelope.
    Records carrying a `_wall` key (a multi-trace merge —
    merge_trace_files) use the wall-clock envelope instead: per-process
    `end` totals would undercount a run spanning several workers."""
    acc: Dict[str, float] = {}
    total = 0.0
    t_min = t_max = None
    w_min = w_max = None
    for rec in records:
        if "_wall" in rec:
            w = rec["_wall"]
            w_min = w if w_min is None else min(w_min, w)
            w_end = w + rec.get("dur_s", 0.0)
            w_max = w_end if w_max is None else max(w_max, w_end)
        if rec["kind"] == "span":
            t_min = rec["t0"] if t_min is None else min(t_min, rec["t0"])
            t_max = rec["t1"] if t_max is None else max(t_max, rec["t1"])
            if rec.get("attrs", {}).get("phase"):
                name = rec["name"]
                acc[name] = acc.get(name, 0.0) + rec["dur_s"]
        elif rec["kind"] == "end":
            total = rec["total_s"]
    if w_min is not None:
        return acc, w_max - w_min
    if not total and t_min is not None:
        total = t_max - t_min
    return acc, total


def convergence_rows(records: Iterable[dict]) -> List[dict]:
    """The convergence.round events, in file (= round) order."""
    return [r["attrs"] for r in records
            if r["kind"] == "event" and r["name"] == "convergence.round"]


def format_convergence_table(rows: List[dict], max_rows: int = 40) -> str:
    """Fixed-width outer-round table: round, Keerthi gap, updates,
    active-set size (when the ring recorded one — round 9 shrink
    telemetry), status.

    Long runs are elided in the middle (first/last max_rows//2 rounds) —
    the interesting structure is the head (cold-start collapse) and the
    tail (the approach to 2*tau)."""
    if not rows:
        return "no convergence records in this trace"
    has_active = any(r.get("active") is not None for r in rows)
    if has_active:
        head = ["round      gap            updates   active  status",
                "-----      ---            -------   ------  ------"]
    else:
        head = ["round      gap            updates  status",
                "-----      ---            -------  ------"]
    idx = list(range(len(rows)))
    if len(idx) > max_rows:
        k = max_rows // 2
        idx = idx[:k] + [None] + idx[-k:]
    out = list(head)
    for i in idx:
        if i is None:
            out.append(f"  ... {len(rows) - 2 * (max_rows // 2)} "
                       "rounds elided ...")
            continue
        r = rows[i]
        gap = r.get("gap")
        gap_s = f"{gap:.6e}" if gap is not None else "n/a"
        line = (f"{r.get('round', i + 1):>5}  {gap_s:>13}  "
                f"{r.get('updates', 0):>7}")
        if has_active:
            act = r.get("active")
            line += f"  {act if act is not None else 'n/a':>7}"
        out.append(f"{line}  {r.get('status', '?')}")
    return "\n".join(out)


def merge_trace_files(paths: List[str]) -> List[dict]:
    """Records of several trace files interleaved on ONE wall clock.

    Each file's monotonic timestamps are mapped to wall time via its
    meta record (wall - t0), so cascade leaves, fold-parallel tune
    workers and a serve process traced to separate files come out as one
    chronological stream. Every record gains `_wall` (the sort key) and
    `_file` (provenance); metrics snapshots across files still merge
    exactly (nonzero_counters → obs.registry.merge_snapshots)."""
    from tpusvm_torch.obs.trace import read_trace

    out: List[dict] = []
    for p in paths:
        recs = read_trace(p)
        offset = 0.0
        for r in recs:
            if r["kind"] == "meta":
                offset = r.get("wall", 0.0) - r.get("t0", 0.0)
                break
        for r in recs:
            t = r.get("t0", r.get("ts", r.get("t1")))
            rr = dict(r)
            rr["_wall"] = offset + (t if t is not None else 0.0)
            rr["_file"] = p
            out.append(rr)
    out.sort(key=lambda r: r["_wall"])
    return out


def cross_process_spans(records: Iterable[dict]
                        ) -> Tuple[List[dict], List[str]]:
    """Resolve cross-process parentage over merged trace records.

    Two propagation mechanisms re-parent spans across files:

      * file-level: a process spawned WITH a context (pod worker,
        `ctx=` at Tracer construction) carries it in its meta record —
        the file's root spans parent under the originating span;
      * span-level: a span whose attrs carry a ``ctx`` dict (a worker's
        per-request train span, a replica's serve.request) parents
        under exactly the originating span named there.

    A context resolves when a merged file's meta matches its
    (trace_id, role, pid) — the origin identity a role-ful Tracer
    writes. Unresolvable contexts (origin file not merged in, junk)
    degrade to the span's local parentage.

    Returns (spans, roles): each span is its record plus
      _gid      globally-unique id "<file#>:<id>"
      _gparent  resolved parent gid (local parent, or the propagated
                target for cross-process roots); None for true roots
      _role     the file's role (meta), "main" when the file has none
      _pid      the file's pid (meta), None when absent
    in merged (_wall) order, and roles is the sorted distinct role set.
    """
    from tpusvm_torch.obs.trace import TraceContext

    files: Dict[str, dict] = {}
    order: List[str] = []
    for r in records:
        f = r.get("_file", "")
        if f not in files:
            files[f] = {"meta": None, "spans": []}
            order.append(f)
        if r["kind"] == "meta" and files[f]["meta"] is None:
            files[f]["meta"] = r
        elif r["kind"] == "span":
            files[f]["spans"].append(r)
    fidx = {f: i for i, f in enumerate(order)}
    origin: Dict[Tuple[str, str, int], str] = {}
    for f in order:
        m = files[f]["meta"] or {}
        if m.get("trace_id") and m.get("role") and m.get("pid") is not None:
            origin[(m["trace_id"], m["role"], m["pid"])] = f

    def resolve(ctx_dict):
        ctx = TraceContext.from_dict(ctx_dict)
        if ctx is None or ctx.span_id is None:
            return None
        f = origin.get((ctx.trace_id, ctx.role, ctx.pid))
        if f is None:
            return None
        return f"{fidx[f]}:{ctx.span_id}"

    spans: List[dict] = []
    roles = set()
    for f in order:
        m = files[f]["meta"] or {}
        role = m.get("role") or "main"
        roles.add(role)
        file_parent = resolve(m.get("ctx")) if m.get("ctx") else None
        for r in files[f]["spans"]:
            attrs = r.get("attrs") or {}
            gparent = None
            if attrs.get("ctx"):
                gparent = resolve(attrs["ctx"])
            if gparent is None and r.get("parent") is not None:
                gparent = f"{fidx[f]}:{r['parent']}"
            if gparent is None and r.get("parent") is None:
                gparent = file_parent
            spans.append({**r, "_gid": f"{fidx[f]}:{r['id']}",
                          "_gparent": gparent, "_role": role,
                          "_pid": m.get("pid")})
    spans.sort(key=lambda s: s.get("_wall", s.get("t0", 0.0)))
    return spans, sorted(roles)


def reparent_stats(records: Iterable[dict]) -> dict:
    """Machine-checkable re-parenting summary for a merged trace dir.

    `unresolved` counts root spans of ctx-carrying files that FAILED to
    re-parent (their origin span should be in the merged set — the
    chaos gate and `report --smoke` assert this stays 0)."""
    from tpusvm_torch.obs.trace import TraceContext

    recs = list(records)
    spans, roles = cross_process_spans(recs)
    ctx_files = set()
    for r in recs:
        if r["kind"] == "meta" and TraceContext.from_dict(
                r.get("ctx")) is not None:
            ctx_files.add(r.get("_file", ""))
    unresolved = sum(
        1 for s in spans
        if s.get("_file", "") in ctx_files and s.get("parent") is None
        and s["_gparent"] is None)
    reparented = sum(
        1 for s in spans
        if s["_gparent"] is not None
        and s["_gparent"].split(":")[0] != s["_gid"].split(":")[0])
    return {"files": len({s.get("_file", "") for s in spans}),
            "roles": roles, "spans": len(spans),
            "reparented": reparented, "unresolved": unresolved}


def _span_attr_brief(attrs: dict, limit: int = 40) -> str:
    parts = []
    for k in ("round", "req", "leaf", "shard", "model", "topology",
              "rows", "n_leaves"):
        if k in attrs:
            parts.append(f"{k}={attrs[k]}")
    s = " ".join(parts)
    return s if len(s) <= limit else s[:limit - 3] + "..."


def format_timeline(records: Iterable[dict], max_rows: int = 60) -> str:
    """The cross-process timeline: one line per span in wall order,
    per-role lanes, indentation by RESOLVED depth (a worker's train span
    indents under the coordinator's round span it was re-parented to).
    Long traces elide the middle like the convergence table."""
    spans, roles = cross_process_spans(records)
    if not spans:
        return "no spans in this trace"
    by_gid = {s["_gid"]: s for s in spans}

    def depth(s):
        d, cur, seen = 0, s, set()
        while cur["_gparent"] is not None and cur["_gparent"] in by_gid:
            if cur["_gid"] in seen:  # defensive: never loop on bad data
                break
            seen.add(cur["_gid"])
            cur = by_gid[cur["_gparent"]]
            d += 1
        return d

    base = min(s.get("_wall", s.get("t0", 0.0)) for s in spans)
    role_w = max(len(r) for r in roles)
    out = [f"{'start_ms':>10}  {'dur_ms':>9}  {'role':<{role_w}}  span",
           f"{'--------':>10}  {'------':>9}  {'----':<{role_w}}  ----"]
    idx = list(range(len(spans)))
    if len(idx) > max_rows:
        k = max_rows // 2
        idx = idx[:k] + [None] + idx[-k:]
    for i in idx:
        if i is None:
            out.append(f"  ... {len(spans) - 2 * (max_rows // 2)} "
                       "spans elided ...")
            continue
        s = spans[i]
        t = s.get("_wall", s.get("t0", 0.0)) - base
        brief = _span_attr_brief(s.get("attrs") or {})
        name = "  " * min(depth(s), 8) + s["name"]
        line = (f"{t * 1e3:>10.1f}  {s['dur_s'] * 1e3:>9.1f}  "
                f"{s['_role']:<{role_w}}  {name}")
        if brief:
            line += f"  [{brief}]"
        out.append(line)
    return "\n".join(out)


def format_round_gantt(records: Iterable[dict], width: int = 32) -> str:
    """Round-level gantt over the pod fit's wall window: one bar per
    coordinator pod.round span, with the worker spans that landed
    inside each round's window counted per role."""
    spans, _ = cross_process_spans(records)
    rounds = [s for s in spans if s["name"] == "pod.round"]
    if not rounds:
        return ""
    lo = min(s.get("_wall", s.get("t0", 0.0)) for s in spans)
    hi = max(s.get("_wall", s.get("t0", 0.0)) + s["dur_s"] for s in spans)
    total = max(hi - lo, 1e-9)
    out = [f"{'round':>5}  {'start_ms':>9}  {'dur_ms':>9}  "
           f"{'window':<{width}}  worker spans"]
    for s in rounds:
        t0 = s.get("_wall", s.get("t0", 0.0))
        t1 = t0 + s["dur_s"]
        a = int((t0 - lo) / total * width)
        b = max(a + 1, int((t1 - lo) / total * width))
        bar = "." * a + "#" * (b - a) + "." * (width - b)
        inside: Dict[str, int] = {}
        for w in spans:
            if w["_role"] == s["_role"] or w["kind"] != "span":
                continue
            wt = w.get("_wall", w.get("t0", 0.0))
            if t0 <= wt <= t1:
                inside[w["_role"]] = inside.get(w["_role"], 0) + 1
        counts = " ".join(f"{r}:{n}" for r, n in sorted(inside.items()))
        rnd = (s.get("attrs") or {}).get("round", "?")
        out.append(f"{rnd:>5}  {(t0 - lo) * 1e3:>9.1f}  "
                   f"{s['dur_s'] * 1e3:>9.1f}  {bar}  {counts}")
    return "\n".join(out)


def compile_rows(records: Iterable[dict]) -> List[dict]:
    """The prof.compile events (tpusvm_torch.obs.prof), in record order."""
    return [r["attrs"] for r in records
            if r["kind"] == "event" and r["name"] == "prof.compile"]


def format_compile_table(rows: List[dict]) -> str:
    """Per-executable compile/cost table (the observatory's headline).

    One row per executable, compiles and lower/compile seconds summed
    across events, FLOPs / bytes accessed / arithmetic intensity from the
    cost analysis (max across events — re-lowers of one entry point are
    the same program family). Backends without a cost model get an
    explicit `cost_analysis: unavailable` marker, never silent zeros."""
    if not rows:
        return "no compile records in this trace (profiling was off)"
    agg: Dict[str, dict] = {}
    order: List[str] = []
    for r in rows:
        name = r.get("executable", "?")
        a = agg.get(name)
        if a is None:
            agg[name] = a = {"n": 0, "lower_s": 0.0, "compile_s": 0.0,
                             "flops": None, "bytes": None,
                             "available": False}
            order.append(name)
        a["n"] += 1
        a["lower_s"] += r.get("lower_s") or 0.0
        a["compile_s"] += r.get("compile_s") or 0.0
        if r.get("cost_available"):
            a["available"] = True
            for src, dst in (("flops", "flops"),
                             ("bytes_accessed", "bytes")):
                v = r.get(src)
                if v is not None:
                    a[dst] = v if a[dst] is None else max(a[dst], v)
    out = ["executable                        #  lower s  compile s"
           "     GFLOP       MB  FLOP/B",
           "----------                        -  -------  ---------"
           "     -----       --  ------"]
    for name in order:
        a = agg[name]
        left = (f"{name:<32} {a['n']:>2}  {a['lower_s']:>7.3f}  "
                f"{a['compile_s']:>9.3f}")
        if not a["available"]:
            out.append(f"{left}  cost_analysis: unavailable")
            continue
        flops, nbytes = a["flops"], a["bytes"]
        gflop = f"{flops / 1e9:>9.4f}" if flops is not None else "      n/a"
        mb = (f"{nbytes / 1e6:>8.2f}" if nbytes is not None else "     n/a")
        ai = (f"{flops / nbytes:>6.2f}" if flops is not None and nbytes
              else "   n/a")
        out.append(f"{left}  {gflop} {mb}  {ai}")
    return "\n".join(out)


def autopilot_rows(records: Iterable[dict]) -> List[dict]:
    """The autopilot.drift decision events, in tick order."""
    return [r["attrs"] for r in records
            if r["kind"] == "event" and r["name"] == "autopilot.drift"]


def format_autopilot_table(rows: List[dict], max_rows: int = 40) -> str:
    """Per-tick drift-decision table: tick, decision, per-detector
    scores vs their (jittered) thresholds, and the reason string. Long
    runs elide the middle like the convergence table — the interesting
    structure is the warm-up and the ticks around a triggered refresh."""
    if not rows:
        return "no autopilot decisions in this trace"
    out = [" tick  decision  detector scores (score/threshold)",
           " ----  --------  ---------------------------------"]
    idx = list(range(len(rows)))
    if len(idx) > max_rows:
        k = max_rows // 2
        idx = idx[:k] + [None] + idx[-k:]
    for i in idx:
        if i is None:
            out.append(f"  ... {len(rows) - 2 * (max_rows // 2)} "
                       "ticks elided ...")
            continue
        r = rows[i]
        rep = r.get("report", {})
        dets = "  ".join(
            f"{d['name']}={d['score']:.3g}/{d['threshold']:.3g}"
            + ("*" if d.get("triggered") else "")
            for d in rep.get("detectors", []))
        out.append(f"{r.get('tick', i + 1):>5}  "
                   f"{'REFRESH' if r.get('decision') else 'watch':>8}  "
                   f"{dets}")
        if r.get("decision"):
            out.append(f"       reason: {r.get('reason', '?')}")
    return "\n".join(out)


def nonzero_counters(records: Iterable[dict]) -> List[str]:
    """`name{labels} value` lines for every non-zero counter/gauge in
    embedded metrics snapshots (merged when several are present)."""
    from tpusvm_torch.obs.registry import merge_snapshots

    snaps = [r["attrs"]["snapshot"] for r in records
             if r["kind"] == "event" and r["name"] == "metrics.snapshot"]
    if not snaps:
        return []
    merged = merge_snapshots(*snaps)
    lines = []
    for e in merged["metrics"]:
        if e["type"] == "histogram":
            if e["count"]:
                lines.append(f"{e['name']} count={e['count']} "
                             f"sum={e['sum']:g}")
        elif e["value"]:
            lab = ",".join(f"{k}={v}" for k, v in
                           sorted(e["labels"].items()))
            lines.append(f"{e['name']}{'{' + lab + '}' if lab else ''} "
                         f"{e['value']:g}")
    return lines


def render_report(records: List[dict]) -> str:
    """The `report` body for one parsed (or merged) trace."""
    acc, total = phase_summary(records)
    spans = sum(1 for r in records if r["kind"] == "span")
    events = sum(1 for r in records if r["kind"] == "event")
    parts = [f"trace: {spans} spans, {events} events", ""]
    comp = compile_rows(records)
    if comp:
        parts += ["compiles (lower/compile wall time, "
                  "XLA cost analysis):",
                  format_compile_table(comp), ""]
    conv = convergence_rows(records)
    parts += ["convergence (b_low - b_high per outer round):",
              format_convergence_table(conv), ""]
    auto = autopilot_rows(records)
    if auto:
        parts += ["autopilot (drift decisions per tick):",
                  format_autopilot_table(auto), ""]
    _, roles = cross_process_spans(records)
    if len(roles) > 1:
        # a merged multi-process trace: stitch ONE timeline across the
        # fleet (propagated contexts re-parent worker/replica spans)
        stats = reparent_stats(records)
        parts += [f"cross-process timeline ({stats['files']} files, "
                  f"roles: {', '.join(roles)}; "
                  f"{stats['reparented']} spans re-parented, "
                  f"{stats['unresolved']} unresolved):",
                  format_timeline(records), ""]
        gantt = format_round_gantt(records)
        if gantt:
            parts += ["pod rounds (gantt over the fit wall window):",
                      gantt, ""]
    counters = nonzero_counters(records)
    if counters:
        parts += ["counters:"] + ["  " + line for line in counters] + [""]
    parts.append(render_phase_lines(acc, total))
    return "\n".join(parts)
