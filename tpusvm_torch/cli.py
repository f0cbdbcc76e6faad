"""Command line: `python -m tpusvm_torch train|pod|predict|ingest|tune|serve|
refresh|autopilot|tenants|router|fleet-metrics|top|info|report|benchdiff`.

train fits a model on a CSV (--train, last column = label; --test scores a
held-out CSV) or a synthetic dataset, scores the held-out rows and prints
the reference's diagnostics (n and n_features, iterations, b to 15
places, the half gap x 1e10, the SV count, accuracy, phase timings), with
the JAX command line's flags and defaults: the hyperparameters (--preset,
--C, --gamma, --tau, --eps, --sv-tol), the numerics (--accum, --no-scale),
the mode (--mode single; oracle: the serial NumPy SMO; cascade: the tree or
star cascade over --shards leaves, with --topology, --sv-capacity,
--stratify, --max-rounds and per-round --checkpoint/--resume, in this
process or as one rank process each with --distributed
--coordinator-address --num-processes --process-id over torch.distributed
gloo, where rank 0 alone prints the result and saves), the solver
(--solver blocked|pair), the kernel family (--kernel, --degree, --coef0),
the feature dtype (--dtype), one-vs-rest (--multiclass; --class-parallel
splits the heads over the visible cards, or with --distributed over rank
processes, each saving the model), epsilon-SVR (--task svr, --epsilon), Platt
calibration (--calibrate K), crash-safe checkpoints (--checkpoint,
--resume, --checkpoint-every), active-set shrinking (--shrink-every,
--shrink-stable), and the approximate families (--kernel rff|nystrom with
--rff-dim, --rff-seed, --landmarks), and --smoke, a tiny gated run of the
(kernel, task) cell. train --data DIR trains from a sharded
dataset (--mode single: the exact families' solve, or the approximate
families' streaming primal fit; --mode cascade: the cascade filled shard by
shard; --mode pod: the cascade's leaves in worker processes, each
streaming its own shards). pod runs the pod cascade on a sharded dataset
(by default a synthetic rings draw, then held bit for bit against the
in-memory cascade; --smoke makes that a gate). ingest writes such a
dataset from a CSV or a synthetic draw. tune runs the cross-validated
(C, gamma) search (grid or halving, warm starts, --fleet) and trains the
winner. CSVs of class labels are read by the native reader.
predict scores a saved model of any kind (either package's `.npz`) on a
CSV or a sharded dataset (--data) or the synthetic held-out slice, and
prints accuracy, or --scores / --proba line by line (--mesh-predict splits
the rows over the visible cards). info prints the torch/CUDA versions and
the visible devices, or describes a model artifact, a tune-results JSON or
a sharded dataset (its manifest and each shard's StreamStatus). serve
hosts saved models over HTTP (tpusvm_torch.serve: micro-batching, one CUDA
graph a row bucket, hot-swap, --state, --watch; --smoke is its gate), and
refresh warm-starts a refit of a deployed model on grown data and can
hot-swap it into a running serve (--swap URL). autopilot supervises the
closed loop of one deployed model over an append-grown dataset (drift
detectors, warm refresh, hot-swap; --smoke is its gate), and tenants that
of many tenant models over one shared corpus (coalesced fleet refreshes,
a staggered roll-out; --smoke); info also describes a tenant store.
serve --trace writes a JSONL trace whose serve.request spans name the
span of the router that forwarded them. router is the HTTP front door
over serve replicas (tpusvm_torch.router: HRW placement, health-polled
admission, failover, staggered rollouts with skew holds; --trace;
--smoke is its gate), fleet-metrics prints one merged metrics view of a
fleet's processes, and top renders it as a table. train, predict, tune,
serve, refresh, autopilot, tenants and the router and fleet-metrics
smokes run on the card unless --device cpu.

Observability: --trace PATH (train, ingest, tune, serve, autopilot,
tenants, router; pod --trace-dir DIR, one file a process) writes a JSONL
trace of phase spans, rounds, convergence records, compile records (CUDA
graph captures, nvcc builds) and metric counters, which `report TRACE...`
renders (several files or a directory merge onto one wall clock, with the
cross-process timeline); --profile DIR (--xprof) captures a torch.profiler
trace (train, ingest, tune, serve); train --jsonl PATH appends structured
run events; `benchdiff OLD NEW` gates one benchmark JSONL against
another. --faults PLAN.json (or TPUSVM_FAULTS) activates a seeded
fault-injection plan for any sub-command.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from tpusvm_torch.config import (DATASET_PRESETS, KERNEL_FAMILIES,
                                 CascadeConfig, SVMConfig, is_approx_family,
                                 preset)
from tpusvm_torch.data.csv_reader import read_csv_regression
from tpusvm_torch.data.native_io import read_csv_fast
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                         BENCH_NOISE_MULTICLASS, blobs,
                                         mnist_like, mnist_like_multiclass,
                                         rings, svr_sine)
from tpusvm_torch.obs.trace import PhaseTimer
from tpusvm_torch.status import Status

_SYNTHETIC = ("mnist_like", "rings", "blobs", "mnist_like_multiclass",
              "svr_sine")


def _add_data_args(p: argparse.ArgumentParser, csv_flag: str,
                   csv_help: str, metavar: str = "CSV",
                   device: bool = True) -> None:
    p.add_argument(csv_flag, metavar=metavar, help=csv_help)
    p.add_argument("--synthetic", choices=_SYNTHETIC,
                   help="deterministic synthetic dataset instead of a CSV "
                   "(svr_sine: continuous targets, --task svr only; "
                   "mnist_like_multiclass: class ids, --multiclass)")
    p.add_argument("--n", type=int, default=60000,
                   help="synthetic train rows")
    p.add_argument("--n-test", type=int, default=10000,
                   help="synthetic test rows")
    p.add_argument("--d", type=int, default=784,
                   help="feature count (mnist_like, blobs, svr_sine)")
    p.add_argument("--seed", type=int, default=587, help="data seed")
    p.add_argument("--n-limit", type=int, default=None, metavar="N",
                   help="cap the rows read (the reference's gpu_svm_main4 "
                   "argv[1]; train: the training rows)")
    p.add_argument("--positive-label", type=int, default=1, metavar="K",
                   help="CSV binary mode: the class mapped to +1 (label != "
                   "K -> -1); default 1, the reference's digit")
    if device:
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpusvm_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="fit a model and score it")
    _add_data_args(tr, "--train", "training CSV (header line, last column "
                   "= label)")
    tr.add_argument("--test", metavar="CSV",
                    help="held-out CSV to score (with --train or --data)")
    tr.add_argument("--data", metavar="DIR",
                    help="a sharded dataset directory (`ingest`): the "
                    "scaler comes from the manifest's stats and shards are "
                    "loaded one at a time (--mode single, cascade or pod)")
    tr.add_argument("--mode", choices=("single", "oracle", "cascade", "pod"),
                    default="single",
                    help="single = on-device SMO; oracle = the serial NumPy "
                    "SMO (binary; the reference's main3.cpp); cascade = the "
                    "cascade over --shards leaves (the reference's MPI "
                    "programs); pod = the cascade's leaves as worker "
                    "processes streaming their shards of --data (--shards "
                    "workers, default 4)")
    tr.add_argument("--topology", choices=("tree", "star"), default="tree",
                    help="cascade merge topology (tree = mpi_svm_main3, "
                    "star = mpi_svm_main2)")
    tr.add_argument("--shards", type=int, default=None,
                    help="cascade shard count P (default: the world size "
                    "with --distributed, else the visible cards; 1 with "
                    "--device cpu; --mode pod: 4 worker processes)")
    tr.add_argument("--stratify", action="store_true",
                    help="cascade: per-class round-robin sharding instead "
                    "of the reference's contiguous scatter (safe on "
                    "label-sorted input)")
    tr.add_argument("--sv-capacity", type=int, default=4096,
                    help="padded SV buffer capacity per shard")
    tr.add_argument("--distributed", action="store_true",
                    help="run this process as one rank of the cascade "
                    "(--mode cascade): torch.distributed over gloo, with "
                    "--coordinator-address, --num-processes and "
                    "--process-id; launch the same command once per rank")
    tr.add_argument("--coordinator-address", default=None,
                    metavar="HOST:PORT",
                    help="with --distributed: the process group's address "
                    "(HOST:PORT, or file://PATH for a store in a shared "
                    "file)")
    tr.add_argument("--num-processes", type=int, default=None,
                    help="with --distributed: world size")
    tr.add_argument("--process-id", type=int, default=None,
                    help="with --distributed: this process's rank")
    tr.add_argument("--preset", choices=sorted(DATASET_PRESETS),
                    default=None, help="named (C, gamma) preset (overrides "
                    "--C and --gamma)")
    tr.add_argument("--C", type=float, default=10.0)
    tr.add_argument("--gamma", type=float, default=0.00125)
    tr.add_argument("--tau", type=float, default=1e-5)
    tr.add_argument("--eps", type=float, default=1e-12)
    tr.add_argument("--sv-tol", type=float, default=1e-8)
    tr.add_argument(
        "--precision", choices=("f32", "bf16_f32", "bf16_f32c"), default="f32",
        help="precision rung of the blocked solver's f-update contraction: "
        "f32 = full-f32 trust anchor (default); bf16_f32 = bfloat16 "
        "operands with exact f32 accumulation (pair with --shrink-every, "
        "whose un-shrink rebuild re-validates claims, or --solver-opt "
        "refine=N); bf16_f32c adds a compensated residual pass. Raw single "
        "pass stays solver-opt-only (matmul_precision=default, "
        "refine-gated)")
    tr.add_argument(
        "--convergence", type=int, default=0, metavar="T",
        help="carry a T-slot convergence ring through the blocked solver's "
        "outer loop (per-round Keerthi gap, update count, live rows and "
        "status; no host syncs, bit-transparent to the solution) and print "
        "its gap table; 0 = off. Requires --mode single with the blocked "
        "solver")
    tr.add_argument("--accum", choices=("none", "float64"), default="float64",
                    help="solver accumulator dtype: float64 (default; f32 "
                    "features, f64 alpha and f) or none (the features' f32)")
    tr.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                    default="float32",
                    help="feature/kernel dtype (the card's kernels take "
                    "float32; the others run the solvers' torch engines)")
    tr.add_argument("--no-scale", action="store_true",
                    help="skip min-max feature scaling")
    tr.add_argument("--solver", choices=("blocked", "pair", "fleet"),
                    default=None,
                    help="blocked working-set solver (default; binary and "
                    "svr), pair (one pair per iteration; the default with "
                    "--multiclass, where the heads run in lockstep) or fleet "
                    "(--multiclass only: every one-vs-rest head in one "
                    "lockstep blocked fleet, tpusvm_torch.fleet; --fleet is "
                    "shorthand)")
    tr.add_argument("--fleet", action="store_true",
                    help="with --multiclass/--task ovr: train all "
                    "one-vs-rest heads as one fleet (shorthand for --solver "
                    "fleet)")
    tr.add_argument("--fleet-compact", type=int, default=0, metavar="R",
                    help="fleet: the JAX CLI's problem-axis compaction every "
                    "R outer rounds; accepted and inert here, where a "
                    "finished problem already runs nothing (R >= 0)")
    tr.add_argument("--q", type=int, default=1024,
                    help="working-set size (blocked)")
    tr.add_argument("--wss", type=int, choices=(1, 2), default=1,
                    help="inner partner rule (blocked)")
    tr.add_argument("--max-inner", type=int, default=1024,
                    help="inner updates per round (blocked)")
    tr.add_argument("--max-iter", type=int, default=100000)
    tr.add_argument("--max-rounds", type=int, default=50,
                    help="cascade round cap")
    tr.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra solver keyword (repeatable), e.g. "
                    "pallas_multipair=4 or pallas_fused_selection=true "
                    "(blocked; the JAX CLI's names, or the short aliases "
                    "multipair, fused_selection, eta_exclude), chunk=256 "
                    "(pair)")
    tr.add_argument("--kernel", choices=KERNEL_FAMILIES, default="rbf",
                    help="kernel family: rbf (default), linear, poly = "
                    "(gamma*x.z + coef0)^degree, sigmoid = tanh(gamma*x.z "
                    "+ coef0); rff / nystrom are the approximate rbf "
                    "families: a seeded explicit feature map, applied on "
                    "the card, routes every solve through the linear path; "
                    "with --data they train out of core (per-shard mapping "
                    "in the prefetch hook and the streaming primal solver)")
    tr.add_argument("--rff-dim", type=int, default=2048, metavar="D",
                    help="--kernel rff: mapped feature width (a positive "
                    "multiple of 128; default 2048)")
    tr.add_argument("--rff-seed", type=int, default=0, metavar="S",
                    help="--kernel rff/nystrom: the map's seed; the same "
                    "seed gives the same map bits in either package "
                    "(default 0)")
    tr.add_argument("--landmarks", type=int, default=256, metavar="K",
                    help="--kernel nystrom: landmark count = mapped width (a "
                    "positive multiple of 128, <= n; default 256)")
    tr.add_argument("--degree", type=int, default=3,
                    help="polynomial degree (--kernel poly)")
    tr.add_argument("--coef0", type=float, default=0.0,
                    help="polynomial/sigmoid additive term")
    tr.add_argument("--multiclass", action="store_true",
                    help="one-vs-rest over all labels instead of the "
                    "reference's binary '1 vs rest' mapping")
    tr.add_argument("--class-parallel", action="store_true",
                    help="with --multiclass: split the class axis over the "
                    "visible cards (requires the pair solver); with "
                    "--distributed, one slice of the heads a rank process, "
                    "and every rank saves the whole model")
    tr.add_argument("--task", choices=("svc", "svr", "ovr"), default="svc",
                    help="svc = classification (default); svr = "
                    "epsilon-insensitive regression over the doubled "
                    "variable set (labels are continuous targets); ovr = "
                    "one-vs-rest (synonym for --multiclass)")
    tr.add_argument("--epsilon", type=float, default=0.1,
                    help="SVR tube half-width (--task svr)")
    tr.add_argument("--calibrate", type=int, default=0, metavar="K",
                    help="fit Platt-scaled predict_proba on K held-out "
                    "folds after training (binary --task svc)")
    tr.add_argument("--checkpoint", metavar="NPZ",
                    help="crash-safe training: --mode cascade or pod "
                    "writes the per-round state here; --mode single "
                    "(binary, blocked solver) the solver's outer-loop "
                    "carry every "
                    "--checkpoint-every rounds (atomic; a resumed run is "
                    "bit-identical to an uninterrupted one)")
    tr.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists (a missing "
                    "file means a fresh run)")
    tr.add_argument("--checkpoint-every", type=int, default=64, metavar="K",
                    help="checkpoint cadence in outer rounds (default 64)")
    tr.add_argument("--shrink-every", type=int, default=0, metavar="E",
                    help="active-set shrinking (blocked solver, binary or "
                    "svr): every E outer rounds, freeze the rows at a bound "
                    "and Keerthi-safe for --shrink-stable rounds and compact "
                    "the rest into a power-of-two bucket; an un-shrink "
                    "rebuilds f and the unshrunk criterion decides. 0 = off")
    tr.add_argument("--shrink-stable", type=int, default=3, metavar="S",
                    help="rounds a row must stay at a bound and safe before "
                    "--shrink-every may freeze it (default 3)")
    tr.add_argument("--save", metavar="PATH", help="write the model .npz")
    tr.add_argument("--smoke", action="store_true",
                    help="gate: a tiny synthetic run for the (kernel, task) "
                    "cell with the convergence ring on; non-zero exit "
                    "unless it converges (every head, --task ovr), beats "
                    "the held-out accuracy (R^2) gate and records a gap "
                    "trajectory ending within 2 tau")
    tr.add_argument("--jsonl", metavar="PATH",
                    help="append structured run events (data, train, eval, "
                    "timing) to a JSONL file")
    tr.add_argument("--trace", metavar="PATH",
                    help="write a schema-versioned JSONL telemetry trace "
                    "(phase spans, cascade and pod rounds, convergence "
                    "records, compile records, metric counters); render "
                    "with `report PATH`")
    tr.add_argument("--profile", "--xprof", metavar="DIR", dest="profile",
                    help="capture a torch.profiler trace of training into "
                    "DIR/trace.json (kernel-level on the card; view in "
                    "Perfetto)")
    tr.add_argument("-q", "--quiet", action="store_true")
    pr = sub.add_parser("predict", help="score a saved model")
    _add_data_args(pr, "--data", "CSV (header line, last column = label) or "
                   "a sharded dataset directory to score (a directory "
                   "streams batch by batch)", metavar="PATH")
    pr.add_argument("--model", metavar="PATH", required=True,
                    help="an artifact of either package (a one-vs-rest "
                    "model scores mnist_like as its 10-class draw)")
    pr.add_argument("--batch-size", type=int, default=4096,
                    help="--data DIR: rows scored per batch (default 4096)")
    pr.add_argument("--scores", action="store_true",
                    help="print decision scores instead of accuracy (one "
                    "line per row; multiclass: one column per class; svr: "
                    "the regressed values)")
    pr.add_argument("--proba", action="store_true",
                    help="print Platt-calibrated P(y=+1) per row (requires "
                    "a binary model trained with --calibrate)")
    pr.add_argument("--mesh-predict", action="store_true",
                    help="split the test rows over every visible card "
                    "(parallel/mesh.py; --device cpu: the CPU)")
    ing = sub.add_parser(
        "ingest", help="write a CSV or a synthetic draw as a sharded "
        "dataset: .npz shards and a JSON manifest with per-shard stats and "
        "checksums (the JAX package's format)")
    _add_data_args(ing, "--train", "CSV to ingest (header line, last column "
                   "= label)", device=False)
    # the JAX command line's shared data-source group carries --test;
    # ingest shards the --train rows only
    ing.add_argument("--test", metavar="CSV", help=argparse.SUPPRESS)
    ing.add_argument("--out", metavar="DIR",
                     help="output dataset directory (required unless "
                     "--smoke)")
    ing.add_argument("--multiclass", action="store_true",
                     help="keep raw integer labels instead of the binary "
                     "one-vs-rest mapping")
    ing.add_argument("--kernel", choices=("raw", "rff", "nystrom"),
                     default="raw",
                     help="shards always store RAW features: naming rff or "
                     "nystrom here explains (with an error) that the map is "
                     "applied at train time, per shard in the prefetch hook")
    # accepted so that the JAX command line meets the refusal of --kernel
    # rff/nystrom below, not an argparse error
    ing.add_argument("--rff-dim", type=int, default=2048, metavar="D",
                     help=argparse.SUPPRESS)
    ing.add_argument("--rff-seed", type=int, default=0, metavar="S",
                     help=argparse.SUPPRESS)
    ing.add_argument("--landmarks", type=int, default=256, metavar="K",
                     help=argparse.SUPPRESS)
    ing.add_argument("--rows-per-shard", type=int, default=65536,
                     help="rows per .npz shard (default 65536)")
    ing.add_argument("--block-rows", type=int, default=8192,
                     help="CSV streaming block size (peak ingest memory)")
    ing.add_argument("--resume", action="store_true",
                     help="continue a killed ingest of the SAME source from "
                     "its journal: verified durable shards are kept and the "
                     "rest re-streamed")
    ing.add_argument("--smoke", action="store_true",
                     help="ingest a tiny synthetic dataset to a temporary "
                     "directory and check it: every shard validates, the "
                     "reader round-trips the rows, the manifest scaler "
                     "equals a whole-array fit, the residency bound holds")
    ing.add_argument("--trace", metavar="PATH",
                     help="write ingest phase spans and shard/stream "
                     "counters to a JSONL telemetry trace")
    ing.add_argument("--profile", "--xprof", metavar="DIR", dest="profile",
                     help="capture a torch.profiler trace of the ingest "
                     "phase into DIR/trace.json")
    ing.add_argument("-q", "--quiet", action="store_true")
    po = sub.add_parser(
        "pod", help="self-contained pod-cascade run: a coordinator and "
        "worker processes train out of core from a sharded dataset, each "
        "leaf streaming only its manifest shards; held bit for bit against "
        "the in-memory cascade on the same rows")
    po.add_argument("--data", metavar="DIR", default=None,
                    help="existing sharded dataset dir to train on "
                    "(default: ingest a synthetic rings set into a temp "
                    "dir, which enables the in-memory parity gate)")
    po.add_argument("--workers", type=int, default=4, metavar="P",
                    help="worker process count = cascade leaf count "
                    "(default 4)")
    po.add_argument("--topology", choices=("tree", "star", "both"),
                    default="both",
                    help="merge topology to run (default both)")
    po.add_argument("--n", type=int, default=192,
                    help="synthetic row count (ignored with --data)")
    po.add_argument("--rows-per-shard", type=int, default=24,
                    help="synthetic ingest shard size (ignored with --data)")
    po.add_argument("--sv-capacity", type=int, default=128,
                    help="padded SV buffer capacity per leaf")
    po.add_argument("--C", type=float, default=10.0)
    po.add_argument("--gamma", type=float, default=10.0)
    po.add_argument("--max-rounds", type=int, default=12)
    po.add_argument("--smoke", action="store_true",
                    help="gate: non-zero exit unless every topology "
                    "converges, matches the in-memory cascade's SV-ID set / "
                    "alpha bytes / b exactly, conserves every row across the "
                    "workers, and keeps per-worker shard residency within "
                    "the prefetch bound")
    po.add_argument("--trace-dir", metavar="DIR", default=None,
                    help="distributed trace directory: the coordinator "
                    "writes coordinator.jsonl and every worker process its "
                    "own worker<id>.p<pid>.jsonl, stitched by propagated "
                    "trace contexts; `report DIR` renders the fleet as ONE "
                    "timeline")
    po.add_argument("--trace-max-bytes", type=int, default=None,
                    metavar="N", help="per-file trace rotation bound")
    po.add_argument("-q", "--quiet", action="store_true")
    po.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    _add_tune_parser(sub)
    _add_serve_parsers(sub)
    _add_closed_loop_parsers(sub)
    _add_router_parsers(sub)
    inf = sub.add_parser("info", help="print the torch/CUDA versions and the "
                         "visible devices, or describe a model artifact")
    inf.add_argument("path", nargs="?", default=None,
                     help="a model .npz of either package, a tune-results "
                     "JSON, a tenant store JSON, or a sharded dataset "
                     "directory")
    _add_obs_parsers(sub)
    faults_help = ("activate a seeded fault-injection plan "
                   "(tpusvm_torch.faults) for this run: named injection "
                   "points raise transients, inject latency, corrupt bytes "
                   "or simulate kills per the plan; also honoured from the "
                   "TPUSVM_FAULTS environment variable")
    ap.add_argument("--faults", metavar="PLAN.json", default=None,
                    help=faults_help)
    # after the sub-command too; absent there, it keeps the root's value
    for p in sub.choices.values():
        p.add_argument("--faults", metavar="PLAN.json",
                       default=argparse.SUPPRESS, help=faults_help)
    return ap


def _add_obs_parsers(sub) -> None:
    """`report` and `benchdiff`, with the JAX command line's flags."""
    rep = sub.add_parser(
        "report", help="render --trace JSONL telemetry: phase summary (the "
        "reference's timing lines), compile table, convergence-gap table, "
        "autopilot decisions and non-zero counters; several files or a "
        "directory merge into one wall-clock-interleaved report")
    rep.add_argument("path", metavar="TRACE", nargs="+",
                     help="trace file(s) written by --trace, or a directory "
                     "of them (pod workers and serve replicas collate into "
                     "one report; rotated trace.jsonl.1 sets are folded in)")
    rep.add_argument("--max-rows", type=int, default=40,
                     help="convergence table rows before middle elision")
    rep.add_argument("--smoke", action="store_true",
                     help="gate: non-zero exit unless the trace(s) parse at "
                     "the current schema version and carry at least one "
                     "phase span and one convergence record")
    bd = sub.add_parser(
        "benchdiff", help="schema-aware comparison of two benchmark JSONL "
        "artifacts (tpusvm_torch.obs.benchdiff): per-metric direction and "
        "tolerance rules, backend-provenance check, non-zero exit on any "
        "regression")
    bd.add_argument("old", metavar="OLD.jsonl", help="baseline artifact")
    bd.add_argument("new", metavar="NEW.jsonl",
                    help="candidate artifact to gate")
    bd.add_argument("--level", choices=["full", "smoke"], default="full",
                    help="full = every rule; smoke = direction-only "
                    "(wall-clock rules skipped: the CI gate, where the "
                    "runner is not the baseline's machine)")
    bd.add_argument("--format", choices=["text", "json", "markdown"],
                    default="text", help="verdict rendering")
    bd.add_argument("--allow-cross-backend", action="store_true",
                    help="annotate instead of refusing when the two "
                    "artifacts ran on different backends (default: refuse; "
                    "cross-backend numbers are not comparable)")


def _add_tune_parser(sub) -> None:
    """The `tune` sub-command, with the JAX command line's flags."""
    tu = sub.add_parser(
        "tune", help="cross-validated (C, gamma) search with warm-started "
        "fits (tune/); trains the winner on the full data")
    _add_data_args(tu, "--train", "training CSV (last column = label)")
    tu.add_argument("--test", metavar="CSV",
                    help="held-out CSV to score the winner on")
    tu.add_argument("--data", metavar="DIR",
                    help="a sharded dataset directory (`ingest`): folds from "
                    "the manifest's labels, each fold gathering only its "
                    "rows")
    tu.add_argument("--kernels", metavar="LIST", default=None,
                    help="comma-separated kernel families to search "
                    "alongside (C, gamma), e.g. rbf,linear,poly (default: "
                    "rbf only); the winner is the global CV argmax")
    tu.add_argument("--degree", type=int, default=3,
                    help="polynomial degree for the poly family")
    tu.add_argument("--coef0", type=float, default=1.0,
                    help="polynomial additive term for the poly family "
                    "(default 1.0)")
    tu.add_argument("--C-grid", metavar="LIST", dest="C_grid",
                    help="comma-separated C values (overrides "
                    "--center-C/--span/--step)")
    tu.add_argument("--gamma-grid", metavar="LIST",
                    help="comma-separated gamma values")
    tu.add_argument("--center-C", type=float, default=10.0,
                    help="log-grid center C when --C-grid is absent")
    tu.add_argument("--center-gamma", type=float, default=0.00125,
                    help="log-grid center gamma when --gamma-grid is "
                    "absent")
    tu.add_argument("--span", type=int, default=2,
                    help="log grid: steps each side of the center")
    tu.add_argument("--step", type=float, default=4.0,
                    help="log grid: multiplicative step per cell")
    tu.add_argument("--folds", type=int, default=3,
                    help="stratified CV folds (default 3)")
    tu.add_argument("--fold-seed", type=int, default=0,
                    help="fold split / rung subset shuffle seed")
    tu.add_argument("--schedule", choices=("grid", "halving"),
                    default="grid")
    tu.add_argument("--eta", type=int, default=3,
                    help="halving: rung growth factor and survivor "
                    "fraction denominator")
    tu.add_argument("--min-rung", type=int, default=256,
                    help="halving: smallest rung subset size")
    tu.add_argument("--no-warm-start", action="store_true",
                    help="fit every point cold")
    tu.add_argument("--patience", type=int, default=None,
                    help="grid: stop after this many consecutive "
                    "non-improving points")
    tu.add_argument("--plateau-tol", type=float, default=0.0,
                    help="minimum CV-accuracy gain that resets --patience")
    tu.add_argument("--fleet", action="store_true", dest="fleet",
                    help="run each rung's points as one fleet a fold "
                    "(fleet/: the points share the fold's scaled rows and "
                    "norms and differ only in (C, gamma))")
    tu.add_argument("--no-fleet", action="store_false", dest="fleet",
                    help="per-point sequential fits (the default)")
    tu.set_defaults(fleet=False)
    tu.add_argument("--fleet-compact", type=int, default=0, metavar="R",
                    help="--fleet: the JAX CLI's compaction cadence; "
                    "accepted and inert here (R >= 0)")
    tu.add_argument("--tau", type=float, default=1e-5)
    tu.add_argument("--eps", type=float, default=1e-12)
    tu.add_argument("--sv-tol", type=float, default=1e-8)
    tu.add_argument("--max-iter", type=int, default=100000)
    tu.add_argument("--dtype", choices=("float32", "bfloat16", "float64"),
                    default="float32")
    tu.add_argument("--accum", choices=("none", "float64"), default="float64",
                    help="solver accumulator dtype (see train --accum)")
    tu.add_argument("--no-scale", action="store_true",
                    help="skip min-max feature scaling")
    tu.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra blocked-solver knob, repeatable (e.g. "
                    "--solver-opt q=256)")
    tu.add_argument("--results", metavar="JSON",
                    help="write the versioned TuneResult table here")
    tu.add_argument("--save", metavar="NPZ",
                    help="save the winner model trained on the full data")
    tu.add_argument("--smoke", action="store_true",
                    help="gate: a 2x2 grid, 2 folds, synthetic rings (blobs "
                    "for a --kernels sweep); non-zero exit unless warm "
                    "seeding engaged, every point beats chance and the "
                    "winner model scores > 0.8 held out")
    tu.add_argument("--trace", metavar="PATH",
                    help="write a JSONL telemetry trace: tune.point spans, "
                    "the search phase, compile records and metric counters")
    tu.add_argument("--profile", "--xprof", metavar="DIR", dest="profile",
                    help="capture a torch.profiler trace of the search into "
                    "DIR/trace.json")
    tu.add_argument("-q", "--quiet", action="store_true")


def _synthetic(args, multiclass: bool):
    total = args.n + args.n_test
    if args.synthetic == "mnist_like_multiclass" or (
            args.synthetic == "mnist_like" and multiclass):
        return mnist_like_multiclass(n=total, d=args.d, seed=args.seed,
                                     noise=BENCH_NOISE_MULTICLASS)
    if args.synthetic == "mnist_like":
        return mnist_like(n=total, d=args.d, seed=args.seed,
                          noise=BENCH_NOISE, label_noise=BENCH_LABEL_NOISE)
    if args.synthetic == "blobs":
        return blobs(n=total, d=args.d, seed=args.seed)
    if args.synthetic == "svr_sine":
        return svr_sine(n=total, d=args.d, seed=args.seed)
    return rings(n=total, seed=args.seed)


def _read(path: str, args, task: str, n_limit=None):
    """(X, Y) of a CSV: continuous targets for svr, raw labels for
    one-vs-rest, else the binary `!= positive_label -> -1` mapping. Class
    labels go through the native reader (data/native_io.py)."""
    if task == "svr":
        return read_csv_regression(path, n_limit=n_limit)
    return read_csv_fast(path, n_limit=n_limit, binary_labels=task != "ovr",
                         positive_label=args.positive_label)


def _data(args, task: str = "svc"):
    """(X_train, Y_train, X_test, Y_test); the test side is None without
    --test. A synthetic draw's test slice is its tail, so --n-limit cuts
    the training rows without moving the test rows."""
    if (args.train is None) == (args.synthetic is None):
        raise SystemExit("pass exactly one of --train / --synthetic / --data")
    if args.train:
        X, Y = _read(args.train, args, task, args.n_limit)
        Xt = Yt = None
        if args.test:
            Xt, Yt = _read(args.test, args, task)
        return X, Y, Xt, Yt
    X, Y = _synthetic(args, task == "ovr")
    total = args.n + args.n_test
    n = args.n if args.n_limit is None else min(args.n, args.n_limit)
    return X[:n], Y[:n], X[total - args.n_test:], Y[total - args.n_test:]


def _check_train_args(args) -> None:
    """The JAX command line's refusals of flag combinations."""
    if args.task == "ovr":
        args.multiclass = True
    if args.fleet:
        if not args.multiclass:
            raise SystemExit("--fleet trains one-vs-rest heads as one "
                             "batched program; it requires "
                             "--multiclass/--task ovr")
        if args.solver not in (None, "fleet"):
            raise SystemExit(f"--fleet and --solver {args.solver} "
                             "conflict (--fleet means --solver fleet)")
        args.solver = "fleet"
    if args.solver == "fleet" and not args.multiclass:
        raise SystemExit("--solver fleet requires --multiclass/--task "
                         "ovr (the fleet batches the one-vs-rest heads)")
    if args.fleet_compact:
        if args.fleet_compact < 0:
            raise SystemExit("--fleet-compact must be >= 0")
        if args.solver != "fleet":
            raise SystemExit("--fleet-compact needs --fleet/--solver "
                             "fleet")
    if args.class_parallel:
        if not args.multiclass:
            raise SystemExit("--class-parallel requires --multiclass (it "
                             "shards the one-vs-rest class axis)")
        if args.solver in ("blocked", "fleet"):
            raise SystemExit(
                "--class-parallel shards the vmapped pair solver over the "
                "mesh; --solver blocked trains classes sequentially and "
                "--solver fleet is already one batched launch")
    approx = args.kernel in ("rff", "nystrom")
    if args.data:
        if args.train or args.synthetic:
            raise SystemExit("pass exactly one of --train / --synthetic / "
                             "--data")
        if args.multiclass:
            raise SystemExit("--data supports binary training (one-vs-rest "
                             "over shards is not in the JAX package "
                             "either); ingest was binary-mapped or use "
                             "--train")
        if args.mode == "oracle":
            raise SystemExit("--mode oracle reads CSVs (--train); --data "
                             "is the streaming path")
        if args.n_limit is not None:
            raise SystemExit("--n-limit does not apply to --data (the "
                             "manifest defines the rows; re-ingest with "
                             "--n-limit instead)")
        if args.distributed:
            raise SystemExit("--data with --distributed is not supported: "
                             "each rank would stream the whole dataset")
        if args.calibrate:
            raise SystemExit("--calibrate fits Platt scaling on in-memory "
                             "folds; it needs --train")
    if approx:
        if args.mode == "oracle":
            raise SystemExit(
                "--mode oracle has no approximate kernels: the NumPy oracle "
                "is the EXACT rbf anchor the approx families are gated "
                "against; train --kernel rbf --mode oracle instead")
        if args.mode in ("cascade", "pod") and args.data:
            raise SystemExit(
                f"--mode {args.mode} --data with an approximate kernel is "
                "not supported yet (leaf partitions carry RAW rows; the "
                "mapped width would change every buffer shape): drop "
                f"--mode {args.mode} for the streaming primal path, or load "
                "the data in-memory for a mapped cascade")
        if args.data and args.convergence:
            raise SystemExit(
                "--convergence rides the blocked solver's outer loop; "
                "streamed approximate training runs the primal epoch "
                "schedule (approx/primal.py), which has no convergence "
                "ring")
        if args.data and args.checkpoint:
            raise SystemExit(
                "--checkpoint is a blocked-solver surface; the streamed "
                "approximate fit runs the primal epoch schedule")
    if not args.distributed and (
            args.coordinator_address or args.num_processes is not None
            or args.process_id is not None):
        raise SystemExit("--coordinator-address/--num-processes/--process-id "
                         "require --distributed")
    if args.distributed:
        if args.mode != "cascade" and not args.class_parallel:
            raise SystemExit("--distributed runs the cascade's ranks (or "
                             "the class axis's) as processes; it needs "
                             "--mode cascade or --multiclass "
                             "--class-parallel")
        if (not args.coordinator_address or args.num_processes is None
                or args.process_id is None):
            raise SystemExit("--distributed needs --coordinator-address, "
                             "--num-processes and --process-id")
    if args.stratify and args.mode not in ("cascade", "pod"):
        raise SystemExit("--stratify only applies to --mode cascade/pod "
                         "(it changes how rows are dealt over the leaves)")
    if args.mode == "pod":
        # pod leaves stream their manifest shards from disk: there is no
        # in-memory source to hand them
        if not args.data:
            raise SystemExit(
                "--mode pod trains out-of-core from a sharded dataset dir: "
                "pass --data DIR (`python -m tpusvm_torch ingest` builds "
                "one)")
        if (args.solver or "blocked") not in ("blocked", "pair"):
            raise SystemExit("--mode pod leaves run the blocked or pair "
                             "solver")
    if args.test and not (args.train or args.data):
        raise SystemExit("--test scores a held-out CSV; it needs --train or "
                         "--data")
    if args.task == "svr":
        if args.mode != "single":
            raise SystemExit("--task svr requires --mode single")
        if args.multiclass:
            raise SystemExit("--task svr is a regression task; "
                             "--multiclass does not apply")
        if args.data:
            raise SystemExit("--task svr reads CSVs (--train, continuous "
                             "last column) or --synthetic svr_sine; sharded "
                             "--data datasets carry class labels")
        if args.calibrate:
            raise SystemExit("--calibrate fits class probabilities; it "
                             "requires --task svc")
    elif args.synthetic == "svr_sine":
        raise SystemExit("--synthetic svr_sine generates continuous "
                         "targets; it requires --task svr")
    if args.synthetic == "mnist_like_multiclass" and not args.multiclass:
        raise SystemExit("--synthetic mnist_like_multiclass generates class "
                         "ids; it requires --multiclass")
    if args.multiclass and args.mode != "single":
        raise SystemExit("--multiclass currently supports --mode single")
    if args.calibrate:
        if args.calibrate < 2:
            raise SystemExit("--calibrate needs >= 2 folds")
        if args.multiclass or args.mode != "single":
            raise SystemExit("--calibrate applies to binary --mode single "
                             "training (Platt scaling of the binary "
                             "decision function)")
    if args.mode == "oracle" and (args.solver_opt or args.shrink_every
                                  or args.precision != "f32"):
        raise SystemExit("--solver-opt/--precision/--shrink-every have no "
                         "effect on --mode oracle (the NumPy oracle has no "
                         "solver knobs)")
    solver = args.solver or ("pair" if args.multiclass else "blocked")
    if args.precision != "f32" and solver != "blocked":
        raise SystemExit("--precision/matmul_precision is a blocked-solver "
                         "ladder knob; the pair solver has no laddered "
                         "contraction")
    if args.convergence:
        if args.convergence < 0:
            raise SystemExit("--convergence must be >= 0")
        if args.mode != "single" or args.multiclass or solver != "blocked":
            raise SystemExit(
                "--convergence needs --mode single with the blocked solver "
                "(the ring is carried through blocked_smo_solve's outer "
                "loop)")
    if args.resume and not args.checkpoint:
        raise SystemExit("--resume requires --checkpoint")
    if args.checkpoint:
        if args.mode == "oracle":
            raise SystemExit("--checkpoint applies to --mode single "
                             "(solver-state checkpoints) or cascade "
                             "(per-round state); the NumPy oracle has no "
                             "checkpointable structure")
        if args.mode == "single" and (args.multiclass or args.task == "svr"
                                      or solver != "blocked"):
            raise SystemExit(
                "--checkpoint with --mode single needs the binary blocked "
                "solver (the outer-loop carry is what gets persisted)")
        if args.checkpoint_every < 1:
            raise SystemExit("--checkpoint-every must be >= 1")
    if args.shrink_every:
        if args.shrink_every < 1:
            raise SystemExit("--shrink-every must be >= 1")
        if solver != "blocked":
            raise SystemExit("--shrink-every needs the blocked solver "
                             "(working-set rounds are what gets compacted)")
        if args.mode not in ("single", "pod"):
            raise SystemExit(
                "--shrink-every needs --mode single or --mode pod: the "
                "shrinking driver segments the solve on the host, which "
                "the cascade's leaves do not (pod leaves are host "
                "processes, so they can)")
        if args.checkpoint and args.mode == "single":
            raise SystemExit(
                "--shrink-every and --checkpoint both segment the outer "
                "loop and cannot be combined yet (--mode pod checkpoints "
                "per round, which composes)")
        if args.multiclass:
            raise SystemExit("--shrink-every supports binary/svr --mode "
                             "single/pod training for now")


def _check_fleet_opts(opts: dict) -> None:
    """--solver-opt names of the fleet: fleet_smo_solve's knobs (less its
    arrays, the flagged hyperparameters and the resume surface), the
    driver's bucket and compact_every, and the solo knob names the fleet
    refuses by name at a non-inert value (fleet/batch.py)."""
    import inspect

    from tpusvm_torch.fleet import fleet_smo_solve
    from tpusvm_torch.fleet.batch import UNSUPPORTED_FLEET_OPTS

    flagged = {"C", "gamma", "eps", "tau", "max_iter", "accum_dtype",
               "kernel", "degree", "coef0"}
    reserved = {"X", "Ys", "valids", "alpha0s", "Cs", "gammas", "sn",
                "resume_states", "pause_at", "return_state", "device"} | flagged
    known = (set(inspect.signature(fleet_smo_solve).parameters) - reserved
             | {"bucket", "compact_every"} | set(UNSUPPORTED_FLEET_OPTS))
    bad = sorted(set(opts) - known)
    if bad:
        hint = [k for k in bad if k in flagged]
        raise SystemExit(
            f"--solver-opt: unknown 'fleet'-solver knob(s) {bad}; known: "
            f"{sorted(known)}"
            + (f" (use the dedicated flags for {hint})" if hint else ""))


def _parse_solver_opts(items) -> dict:
    """KEY=VALUE --solver-opt strings -> typed knob dict.

    Values convert bool -> int -> float -> string in that order, so
    fused_selection=false is a real False (not a truthy str) and
    multipair=4 an int, while knobs like inner=kernel stay strings.
    """
    opts = {}
    for item in items:
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise SystemExit(f"--solver-opt expects KEY=VALUE, got {item!r}")
        if value.lower() in ("true", "false"):
            opts[key] = value.lower() == "true"
            continue
        for conv in (int, float):
            try:
                opts[key] = conv(value)
                break
            except ValueError:
                continue
        else:
            opts[key] = value
    return opts


def _accuracy_line(model, Xt, Yt, timer, task: str = "svc", mesh=None,
                   log=None):
    """Print the held-out accuracy (R^2 for svr) and return it; None on no
    rows. mesh: the classifiers' rows split over it (predict
    --mesh-predict). log: a RunLogger (train) that also records the eval
    event."""
    if not len(Yt):
        return None
    with timer.phase("prediction"):
        acc = (model.score(Xt, Yt) if mesh is None or task == "svr"
               else model.score(Xt, Yt, mesh=mesh))
    say = print if log is None else log.info
    m = len(Yt)
    if task == "svr":
        # score() is R^2 for the regression task
        rmse = float(np.sqrt(np.mean(
            (model.predict(Xt) - np.asarray(Yt, np.float64)) ** 2)))
        say(f"r2 = {acc:.4f}  rmse = {rmse:.4f} ({m} rows)")
        if log is not None:
            log.event("eval", r2=acc, rmse=rmse, m=m)
    else:
        say(f"accuracy = {acc:.4f} ({round(acc * m)}/{m})")
        if log is not None:
            log.event("eval", accuracy=acc, m=m)
    return acc


def _config(args) -> SVMConfig:
    kw = dict(tau=args.tau, eps=args.eps, sv_tol=args.sv_tol,
              max_iter=args.max_iter, max_rounds=args.max_rounds,
              kernel=args.kernel, degree=args.degree,
              coef0=args.coef0, epsilon=args.epsilon, rff_dim=args.rff_dim,
              map_seed=args.rff_seed, landmarks=args.landmarks)
    try:
        if args.preset:
            return preset(args.preset, **kw)
        return SVMConfig(C=args.C, gamma=args.gamma, **kw)
    except ValueError as e:
        raise SystemExit(f"train: {e}")


def _fit_oracle(X, Y, cfg: SVMConfig, device):
    """The serial NumPy SMO behind the BinarySVC surface, on min-max scaled
    rows (as the JAX command line runs it, --no-scale or not)."""
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.oracle import get_sv_indices, smo_train

    model = BinarySVC(config=cfg, device=device)
    model.scaler_ = MinMaxScaler().fit(X)
    Xs = model.scaler_.transform(X)
    res = smo_train(Xs, Y, cfg)
    sv = get_sv_indices(res.alpha, cfg.sv_tol)
    model.sv_X_ = Xs[sv]
    model.sv_Y_ = np.asarray(Y)[sv].astype(np.int32)
    model.sv_alpha_ = res.alpha[sv]
    model.sv_ids_ = sv.astype(np.int32)
    model.b_ = res.b
    model.b_high_ = res.b_high
    model.b_low_ = res.b_low
    model.n_iter_ = res.n_iter
    model.status_ = res.status
    return model


def _fit_cascade(model, X, Y, args, group, dataset=None, tracer=None,
                 say=print):
    """--mode cascade: the cascade over --shards leaves (default: the world
    size under --distributed, else the visible cards, 1 on the CPU), in
    this process or as this rank of `group`."""
    import torch

    if args.shards is not None:
        shards = args.shards
    elif group is not None:
        shards = args.num_processes
    elif args.device == "cpu":
        shards = 1
    else:
        shards = torch.cuda.device_count() or 1
    try:
        cc = CascadeConfig(n_shards=shards, sv_capacity=args.sv_capacity,
                           topology=args.topology)
    except ValueError as e:
        raise SystemExit(f"train: {e}")
    kw = dict(group=group, verbose=not args.quiet,
              checkpoint_path=args.checkpoint, resume=args.resume,
              stratified=args.stratify, tracer=tracer)
    if dataset is not None:
        model.fit_cascade_stream(dataset, cc, **kw)
    else:
        model.fit_cascade(X, Y, cc, **kw)
    say(f"cascade: {model.cascade_rounds_} rounds, converged = "
        f"{model.status_.name == 'CONVERGED'}")
    return model


def _fit_pod(model, args, tracer=None, say=print):
    """--mode pod: the cascade over --shards worker processes (default 4:
    a small pod of processes, not the card count), each streaming its own
    shards of --data."""
    shards = args.shards or 4
    try:
        cc = CascadeConfig(n_shards=shards, sv_capacity=args.sv_capacity,
                           topology=args.topology)
    except ValueError as e:
        raise SystemExit(f"train: {e}")
    model.fit_pod(args.data, cc, verbose=not args.quiet,
                  checkpoint_path=args.checkpoint, resume=args.resume,
                  stratified=args.stratify, tracer=tracer)
    say(f"pod: {shards} workers, {model.cascade_rounds_} rounds, "
        f"converged = {model.status_.name == 'CONVERGED'}")
    return model


def _smoke_fixture(args) -> None:
    """train --smoke: the JAX command line's tiny fixture for the (kernel,
    task) cell under test. Rings need the RBF geometry (the approximate
    families get them too, with map widths sized to the problem), the
    linear-like families separable blobs, svr the sine regression problem,
    ovr a 10-class mnist-shaped problem; the binary cells carry a 32-slot
    convergence ring."""
    if args.task == "ovr":
        args.synthetic, args.d = "mnist_like", 64
        args.C, args.gamma = 10.0, 1.0 / 64
        args.train = args.data = args.test = None
        args.n, args.n_test, args.n_limit = 1024, 256, None
        args.mode = "single"
        args.solver = args.solver or ("fleet" if args.fleet else "blocked")
        return
    if args.task == "svr":
        args.synthetic, args.d = "svr_sine", 2
        args.C, args.gamma, args.epsilon = 10.0, 20.0, 0.1
    elif args.kernel in ("rbf", "rff", "nystrom"):
        args.synthetic = "rings"
        args.C, args.gamma = 10.0, 10.0
        if args.kernel == "rff":
            args.rff_dim = min(args.rff_dim, 512)
        if args.kernel == "nystrom":
            args.landmarks = min(args.landmarks, 128)
    elif args.kernel == "sigmoid":
        # tanh needs the negative offset to carve a margin on blobs
        args.synthetic, args.d = "blobs", 6
        args.C, args.gamma = 10.0, 0.25
        if args.coef0 == 0.0:
            args.coef0 = -1.0
    else:
        args.synthetic, args.d = "blobs", 6
        args.C, args.gamma = 1.0, 1.0
        if args.kernel == "poly" and args.coef0 == 0.0:
            args.coef0 = 1.0  # odd-degree poly needs the affine term
    args.train = args.data = args.test = None
    args.n, args.n_test, args.n_limit = 240, 60, None
    args.mode, args.multiclass = "single", False
    args.solver = args.solver or "blocked"
    if args.convergence == 0:
        args.convergence = 32


def _smoke_gates(args, model, acc) -> int:
    """train --smoke's gates, the JAX command line's: 0 when they hold."""
    failures = []
    if args.task == "ovr":
        bad = [(int(c), Status(int(s)).name)
               for c, s in zip(model.classes_, model.statuses_)
               if int(s) != Status.CONVERGED]
        if bad:
            failures.append(f"heads did not converge: {bad}")
        if acc is None or acc <= 0.25:
            failures.append(f"held-out accuracy gate failed ({acc!r})")
        ok = (f"train smoke ok [ovr/{args.solver}]: {len(model.classes_)} "
              f"heads, SV union {model.X_sv_.shape[0]}, accuracy "
              f"{acc if acc is None else format(acc, '.4f')}")
    else:
        gate = "r2" if args.task == "svr" else "accuracy"
        conv = model.convergence_
        if model.status_ != Status.CONVERGED:
            failures.append(f"solver ended {model.status_.name}")
        if acc is None or acc <= 0.8:
            failures.append(f"held-out {gate} gate failed ({acc!r})")
        if conv is None or len(conv["gap"]) == 0:
            failures.append("no convergence telemetry recorded")
        elif conv["gap"][-1] > 2.0 * args.tau * (1 + 1e-9):
            failures.append(
                f"final recorded gap {conv['gap'][-1]:g} exceeds the 2*tau "
                f"stopping criterion ({2 * args.tau:g})")
        if args.trace:
            from tpusvm_torch.obs import read_trace
            from tpusvm_torch.obs.report import convergence_rows, phase_summary

            try:
                records = read_trace(args.trace)
                if not phase_summary(records)[0]:
                    failures.append("trace carries no phase spans")
                if not convergence_rows(records):
                    failures.append("trace carries no convergence records")
            except ValueError as e:
                failures.append(f"trace unreadable: {e}")
        ok = (f"train smoke ok [{args.kernel}/{args.task}]: "
              f"{model.n_support_} SVs, {gate} "
              f"{acc if acc is None else format(acc, '.4f')}, "
              f"{conv['rounds_recorded'] if conv else 0} convergence rounds "
              "recorded")
    for f in failures:
        print(f"TRAIN SMOKE FAILED: {f}")
    if failures:
        return 1
    print(ok)
    return 0


def cmd_train(args) -> int:
    if args.smoke:
        _smoke_fixture(args)
    _check_train_args(args)
    if not args.distributed:
        return _train(args, None)
    import contextlib
    import io

    import torch.distributed as dist

    from tpusvm_torch.parallel.group import init_group

    group = init_group(args.coordinator_address, args.num_processes,
                       args.process_id)
    try:
        if args.process_id == 0:
            return _train(args, group)
        # the other ranks train their leaves (or heads) and print nothing
        with contextlib.redirect_stdout(io.StringIO()):
            return _train(args, group)
    finally:
        dist.destroy_process_group()


def _train(args, group) -> int:
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC
    from tpusvm_torch.utils import RunLogger, trace

    rank0 = group is None or args.process_id == 0
    cfg = _config(args)
    task = "ovr" if args.multiclass else args.task
    tracer = _make_tracer(args, "train") if rank0 else None
    log = RunLogger(jsonl_path=args.jsonl if rank0 else None,
                    primary=not args.quiet)
    say = log.info
    timer = PhaseTimer(tracer=tracer)
    dataset = None
    with timer.phase("data"):
        if args.data:
            from tpusvm_torch.stream import open_dataset

            dataset = open_dataset(args.data)
            X = Y = Xt = Yt = None
            if args.test:
                Xt, Yt = _read(args.test, args, task)
            n, n_features = dataset.n_rows, dataset.n_features
        else:
            X, Y, Xt, Yt = _data(args, task)
            n, n_features = X.shape
    say(f"n = {n}, n_features = {n_features}")
    log.event("data", n=n, n_features=n_features, mode=args.mode,
              streamed=dataset is not None)
    solver = args.solver or ("pair" if args.multiclass else "blocked")
    # the streamed approximate fit runs the primal solver: its knobs
    # replace the blocked solver's
    primal = dataset is not None and args.kernel in ("rff", "nystrom")
    opts = (dict(q=args.q, wss=args.wss, max_inner=args.max_inner)
            if solver in ("blocked", "fleet") and not primal else {})
    opts.update(_parse_solver_opts(args.solver_opt))
    if solver == "fleet":
        _check_fleet_opts(opts)
        if args.fleet_compact:
            if "compact_every" in opts:
                raise SystemExit("--fleet-compact and --solver-opt "
                                 "compact_every= are the same knob; pass one")
            opts["compact_every"] = args.fleet_compact
    if args.precision != "f32":
        if "matmul_precision" in opts:
            raise SystemExit("--precision and --solver-opt matmul_precision= "
                             "are the same knob; pass one")
        opts["matmul_precision"] = args.precision
    if "matmul_precision" in opts and solver != "blocked":
        raise SystemExit("--precision/matmul_precision is a blocked-solver "
                         "ladder knob; the pair solver has no laddered "
                         "contraction")
    if args.convergence:
        if "telemetry" in opts:
            raise SystemExit("--convergence and --solver-opt telemetry= are "
                             "the same knob; pass one")
        opts["telemetry"] = args.convergence
    if args.shrink_every:
        if "shrink_every" in opts:
            raise SystemExit("--shrink-every and --solver-opt shrink_every= "
                             "are the same knob; pass one")
        opts["shrink_every"] = args.shrink_every
        opts.setdefault("shrink_stable", args.shrink_stable)
    common = dict(config=cfg, device=args.device, solver=solver,
                  solver_opts=opts, scale=not args.no_scale,
                  accum_dtype="auto" if args.accum == "float64" else None,
                  dtype=args.dtype)
    with timer.phase("training"), trace(args.profile, device=args.device,
                                        tracer=tracer):
        if args.mode == "oracle":
            model = _fit_oracle(X, Y, cfg, args.device)
        elif args.mode == "cascade":
            model = _fit_cascade(BinarySVC(**common), X, Y, args, group,
                                 dataset, tracer=tracer, say=say)
        elif args.mode == "pod":
            model = _fit_pod(BinarySVC(**common), args, tracer=tracer,
                             say=say)
        elif args.task == "svr":
            model = EpsilonSVR(**common).fit(X, Y)
        elif args.multiclass:
            model = OneVsRestSVC(**common, class_parallel=args.class_parallel
                                 ).fit(X, Y, group=group)
        elif dataset is not None:
            model = BinarySVC(**common).fit_stream(
                dataset, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume)
        else:
            model = BinarySVC(**common).fit(
                X, Y, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                tracer=tracer)
    if args.multiclass:
        say(f"classes = {[int(c) for c in model.classes_]}")
        say(f"status = {[Status(int(s)).name for s in model.statuses_]}")
    else:
        say(f"iterations = {model.n_iter_}")
        say(f"b = {model.b_:.15f}")
        if np.isfinite(model.b_high_):
            gap = (model.b_high_ - model.b_low_) / 2.0
            say(f"(b_high - b_low)/2 * 1e10 = {gap * 1e10:.6f}")
        say(f"SV count = {model.n_support_}")
        say(f"status = {model.status_.name}")
        if getattr(model, "primal_result_", None) is not None:
            pr = model.primal_result_
            say(f"primal: {pr.epochs_run} epochs, {pr.n_steps} steps, "
                f"objective {pr.objective:.9g}, live shards <= "
                f"{model.stream_max_live_shards_}")
        log.event("train", n_iter=model.n_iter_, b=model.b_,
                  sv_count=model.n_support_, status=model.status_.name,
                  train_time_s=timer["training"])
    if args.calibrate:
        with timer.phase("calibration"):
            model.calibrate(X, Y, folds=args.calibrate)
        say("calibrated: Platt A=%.6f B=%.6f" % model.platt_)
        log.event("calibrate", folds=args.calibrate,
                  platt_a=model.platt_[0], platt_b=model.platt_[1])
    acc = None
    if Xt is not None and rank0:
        acc = _accuracy_line(model, Xt, Yt, timer, task, log=log)
    # the class axis's ranks all end with the whole model: each saves it
    if args.save and (rank0 or args.class_parallel):
        model.save(args.save)
        say(f"model saved to {args.save}")
    conv = getattr(model, "convergence_", None)
    if conv is not None and not args.quiet:
        from tpusvm_torch.obs.convergence import format_gap_table

        say("convergence (b_low - b_high per outer round):")
        say(format_gap_table(conv))
    if tracer is not None:
        from tpusvm_torch.obs import default_registry, to_trace_events
        from tpusvm_torch.pod.worker import kernel_wrappers

        if conv is not None:
            to_trace_events(tracer, conv)
        # the process's kernel launches ride in the snapshot (`report`
        # lists the non-zero ones under counters)
        reg = default_registry()
        for name, fn in kernel_wrappers().items():
            reg.gauge("kernel.launches", kernel=name).set(float(fn.launches))
        tracer.metrics_snapshot(reg.snapshot())
    say(timer.report())
    log.event("timing", **timer.asdict())
    log.close()
    _close_tracer(tracer)
    if args.smoke:
        return _smoke_gates(args, model, acc)
    return 0


def cmd_pod(args) -> int:
    """Self-contained pod-cascade run: out-of-core multiprocess training
    with a bit-level parity gate against the in-memory cascade."""
    import os
    import tempfile

    from tpusvm_torch.parallel.cascade import cascade_fit
    from tpusvm_torch.pod import pod_fit
    from tpusvm_torch.stream import ingest_arrays, open_dataset

    tracer = None
    if args.trace_dir:
        from tpusvm_torch import faults
        from tpusvm_torch.obs.trace import Tracer

        os.makedirs(args.trace_dir, exist_ok=True)
        # the coordinator's own trace file; workers open theirs at spawn
        # (pod_fit hands them the dir and this tracer's context) so the
        # whole fleet stitches into one `report` timeline
        tracer = Tracer(os.path.join(args.trace_dir, "coordinator.jsonl"),
                        role="pod-coordinator", argv=["pod"],
                        max_bytes=args.trace_max_bytes)
        faults.set_event_sink(tracer.event)
    topologies = (["tree", "star"] if args.topology == "both"
                  else [args.topology])
    cfg = SVMConfig(C=args.C, gamma=args.gamma, max_rounds=args.max_rounds)
    failures = []
    summaries = []
    with tempfile.TemporaryDirectory() as td:
        if args.data:
            data, X, Y = args.data, None, None
        else:
            X, Y = rings(n=args.n, seed=3)
            data = os.path.join(td, "ds")
            ingest_arrays(data, X, Y, rows_per_shard=args.rows_per_shard)
        n_rows = open_dataset(data).n_rows
        for topo in topologies:
            cc = CascadeConfig(n_shards=args.workers,
                               sv_capacity=args.sv_capacity, topology=topo)
            res = pod_fit(data, cfg, cc, verbose=not args.quiet,
                          device=args.device, tracer=tracer,
                          trace_dir=args.trace_dir,
                          trace_max_bytes=args.trace_max_bytes)
            if not args.quiet:
                print(f"pod[{topo}]: {res.rounds} rounds, "
                      f"{len(res.sv_ids)} SVs, b = {res.b:.12f}, "
                      f"rows {list(res.worker_rows)}, "
                      f"live shards {list(res.worker_max_live_shards)}, "
                      f"revives {res.revives}, start-up "
                      f"{res.startup_s:.2f} s")
            if not res.converged:
                failures.append(f"[{topo}] pod did not converge in "
                                f"{res.rounds} rounds")
            if sum(res.worker_rows) != n_rows:
                failures.append(
                    f"[{topo}] rows lost: workers hold "
                    f"{sum(res.worker_rows)} of {n_rows}")
            summaries.append((topo, res.rounds, len(res.sv_ids)))
            if X is None:
                continue
            # parity gate: the in-memory cascade on the identically scaled
            # rows must give the same bits (the pod moves leaf results
            # over the wire protocol; any serialization loss shows here)
            ctrl = cascade_fit(MinMaxScaler().fit_transform(X), Y, cfg, cc,
                               device=args.device)
            if set(res.sv_ids.tolist()) != set(ctrl.sv_ids.tolist()):
                failures.append(f"[{topo}] SV-ID set diverges from the "
                                "in-memory cascade")
            elif res.sv_alpha.tobytes() != ctrl.sv_alpha.tobytes():
                failures.append(f"[{topo}] alpha bytes diverge from the "
                                "in-memory cascade")
            if res.b != ctrl.b:
                failures.append(f"[{topo}] b diverges: pod {res.b!r} vs "
                                f"in-memory {ctrl.b!r}")
    if tracer is not None:
        faults.set_event_sink(None)
        tracer.close()
        if not args.quiet:
            print(f"trace: {args.trace_dir} (render with `python -m "
                  f"tpusvm_torch report {args.trace_dir}`)")
    if failures:
        for f in failures:
            print(f"POD{' SMOKE' if args.smoke else ''} FAILED: {f}")
        return 1
    parity = ("bit-identical to in-memory cascade" if X is not None
              else "parity gate skipped (--data)")
    print("pod ok: " + "; ".join(
        f"{t} {r} rounds/{s} SVs" for t, r, s in summaries)
        + f", {args.workers} workers, {parity}")
    return 0


def _print_rows(values) -> None:
    """One line per row, each value as the JAX command line prints it."""
    values = np.asarray(values)
    if len(values):  # reshape(n, -1) is ambiguous on 0 rows
        for row in values.reshape(len(values), -1):
            print(" ".join(f"{s:.15f}" for s in row))


def cmd_predict(args) -> int:
    from tpusvm_torch.models import load_any, model_task

    from tpusvm_torch.stream import is_dataset_dir

    timer = PhaseTimer()
    kind = model_task(args.model)
    if (args.data is None) == (args.synthetic is None):
        raise SystemExit("pass exactly one of --data / --synthetic")
    model = load_any(args.model, device=args.device)
    if args.proba and (kind != "svc" or model.platt_ is None):
        raise SystemExit(
            "--proba needs a calibrated binary model (train with "
            "--calibrate); this artifact carries no Platt coefficients")
    t = time.perf_counter()
    if args.data and is_dataset_dir(args.data):
        return _predict_stream(args, kind, model, timer)
    if args.data:
        Xt, Yt = _read(args.data, args, kind, args.n_limit)
    else:
        _, _, Xt, Yt = _data(argparse.Namespace(**vars(args), train=None,
                                                test=None), kind)
    timer.add("data", time.perf_counter() - t)
    mesh = None
    if args.mesh_predict:
        from tpusvm_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=["cpu"] if args.device == "cpu" else None)
    if args.proba:
        _print_rows(model.predict_proba(Xt, mesh=mesh)[:, 1])
        return 0
    if args.scores:
        kw = {} if kind == "svr" else {"mesh": mesh}
        _print_rows(model.decision_function(Xt, **kw))
        return 0
    if kind == "ovr":
        print(f"classes = {[int(c) for c in model.classes_]}")
        print(f"SV count = {len(model.X_sv_)}")
    else:
        print(f"SV count = {model.n_support_}")
    _accuracy_line(model, Xt, Yt, timer, kind, mesh)
    print(timer.report())
    return 0


def _predict_stream(args, kind: str, model, timer) -> int:
    """predict --data DIR: streamed scoring off the shards, batch by batch
    on the card; peak memory is the reader's bound plus one batch."""
    from tpusvm_torch.stream import (evaluate_stream, open_dataset,
                                     predict_stream)

    if kind == "svr":
        raise SystemExit("svr models read CSV test data (--data CSV with a "
                         "continuous last column)")
    dataset = open_dataset(args.data)
    if args.mesh_predict:
        raise SystemExit("--mesh-predict applies to CSV input; the streamed "
                         "path batches over shards instead")
    if args.scores:
        n_out = 0
        for scores, _ in predict_stream(model, dataset,
                                        batch_size=args.batch_size):
            if args.n_limit is not None:
                scores = scores[:max(0, args.n_limit - n_out)]
            n_out += len(scores)
            _print_rows(scores)
            if args.n_limit is not None and n_out >= args.n_limit:
                break
        return 0
    if kind == "ovr":
        print(f"classes = {[int(c) for c in model.classes_]}")
        print(f"SV count = {len(model.X_sv_)}")
    else:
        print(f"SV count = {model.n_support_}")
    t = time.perf_counter()
    acc, m = evaluate_stream(model, dataset, batch_size=args.batch_size,
                             n_limit=args.n_limit)
    timer.add("prediction", time.perf_counter() - t)
    print(f"accuracy = {acc:.4f} ({round(acc * m)}/{m})")
    print(timer.report())
    return 0


def cmd_ingest(args) -> int:
    """Write a CSV or a synthetic draw as a sharded dataset directory."""
    from tpusvm_torch.status import StreamStatus
    from tpusvm_torch.stream import ingest_arrays, ingest_csv, open_dataset

    if args.kernel != "raw":
        # shards hold raw features by design: a pre-mapped dataset would
        # pin one (D, seed) and break the scale-then-map order (the
        # scaler comes from the manifest at train time)
        raise SystemExit(
            f"ingest --kernel {args.kernel}: shards store RAW features; "
            "the approximate map is applied stream-side during training "
            "prefetch, so one ingested dataset serves every map; run "
            f"`python -m tpusvm_torch train --data OUT --kernel "
            f"{args.kernel} --rff-dim D --rff-seed S` instead")
    say = (lambda msg: None) if args.quiet else print
    if args.smoke:
        return _ingest_smoke(say)
    if not args.out:
        raise SystemExit("ingest: --out DIR is required (or --smoke)")
    if (args.train is None) == (args.synthetic is None):
        raise SystemExit("ingest: pass exactly one of --train / --synthetic")
    if args.synthetic == "svr_sine":
        raise SystemExit("ingest shards labelled datasets; --synthetic "
                         "svr_sine generates continuous targets (train "
                         "--task svr reads it directly)")
    from tpusvm_torch.utils import trace

    tracer = _make_tracer(args, "ingest")
    timer = PhaseTimer(tracer=tracer)
    with timer.phase("ingest"), trace(args.profile, device="cpu"):
        if args.train:
            manifest = ingest_csv(
                args.out, args.train, rows_per_shard=args.rows_per_shard,
                n_limit=args.n_limit, binary=not args.multiclass,
                positive_label=args.positive_label,
                block_rows=args.block_rows, resume=args.resume)
        else:
            if args.synthetic == "mnist_like_multiclass" \
                    and not args.multiclass:
                raise SystemExit("--synthetic mnist_like_multiclass "
                                 "generates class ids; it requires "
                                 "--multiclass")
            X, Y = _synthetic(
                argparse.Namespace(**dict(vars(args), n_test=0)),
                args.multiclass)
            if args.n_limit is not None:
                X, Y = X[:args.n_limit], Y[:args.n_limit]
            manifest = ingest_arrays(
                args.out, X, Y, rows_per_shard=args.rows_per_shard,
                binary=not args.multiclass,
                positive_label=(None if args.multiclass
                                else args.positive_label),
                resume=args.resume)
    with timer.phase("validate"):
        bad = [(manifest.shards[i].filename, s.name)
               for i, s in enumerate(open_dataset(args.out).validate())
               if s != StreamStatus.OK]
    if tracer is not None:
        from tpusvm_torch.obs import default_registry

        tracer.event("ingest.manifest", n_rows=manifest.n_rows,
                     n_features=manifest.n_features,
                     n_shards=len(manifest.shards), out=args.out,
                     valid=not bad)
        tracer.metrics_snapshot(default_registry().snapshot())
    _close_tracer(tracer)
    if bad:
        print(f"ingest: wrote shards that FAIL validation: {bad}")
        return 1
    stats = manifest.global_stats()
    say(f"ingested {manifest.n_rows} rows x {manifest.n_features} features "
        f"into {len(manifest.shards)} shards at {args.out}")
    say(f"class counts: {dict(sorted(stats.class_counts.items()))}")
    say(timer.report())
    return 0


def _ingest_smoke(say=print) -> int:
    """Ingest a tiny synthetic dataset and check every claim of the stream
    tier: manifest integrity, reader round trip, scaler-from-stats bits,
    the prefetch residency bound."""
    import tempfile

    from tpusvm_torch.status import StreamStatus
    from tpusvm_torch.stream import ShardReader, ingest_arrays, open_dataset

    X, Y = rings(n=301, seed=11)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        manifest = ingest_arrays(tmp, X, Y, rows_per_shard=64)
        ds = open_dataset(tmp)
        statuses = ds.validate()
        if not all(s == StreamStatus.OK for s in statuses):
            failures.append(f"validate: {[s.name for s in statuses]}")
        reader = ShardReader(ds, prefetch_depth=2)
        blocks = list(reader)
        Xr = np.concatenate([b[0] for b in blocks])
        Yr = np.concatenate([b[1] for b in blocks])
        if not (np.array_equal(Xr, X) and np.array_equal(Yr, Y)):
            failures.append("reader round-trip diverged from the generator")
        if reader.max_live_shards > 3:
            failures.append(
                f"residency bound violated: {reader.max_live_shards} live "
                "shards > prefetch_depth + 1 = 3")
        sc = ds.scaler()
        sf = MinMaxScaler().fit(X)
        if not (np.array_equal(sc.min_val, sf.min_val)
                and np.array_equal(sc.max_val, sf.max_val)):
            failures.append("manifest scaler != full-array fit")
    if failures:
        for f in failures:
            print(f"INGEST SMOKE FAILED: {f}")
        return 1
    say(f"ingest smoke ok: {manifest.n_rows} rows, {len(manifest.shards)} "
        "shards, scaler/round-trip/residency parity held")
    return 0


def cmd_tune(args) -> int:
    """Cross-validated (C, gamma) search, then the winner trained on the
    full data: the JAX command line's `tune`."""
    import dataclasses

    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.status import TuneStatus
    from tpusvm_torch.tune import (TuneConfig, format_table, log_grid,
                                   make_grid, normalize_kernel_specs,
                                   save_tune_result, tune)

    if args.smoke:
        # the JAX command line's fixture: 2 folds, a 2x2 grid; rings for
        # one family, separable blobs for a family sweep (rings fail the
        # linear family by construction)
        multi_family = args.kernels and "," in args.kernels
        args.synthetic = "blobs" if multi_family else "rings"
        args.d = 6
        args.train, args.test, args.data = None, None, None
        args.n, args.n_test, args.n_limit = 240, 60, None
        args.folds, args.fold_seed = 2, 0
        args.C_grid, args.gamma_grid = "1,8", "1,8"
        args.schedule = "grid"
    if args.synthetic in ("svr_sine", "mnist_like_multiclass"):
        raise SystemExit(f"tune is a binary classification search; "
                         f"--synthetic {args.synthetic} is not binary "
                         "training data")
    if args.C_grid or args.gamma_grid:
        if not (args.C_grid and args.gamma_grid):
            raise SystemExit("tune: pass both --C-grid and --gamma-grid (or "
                             "neither, for the log grid around "
                             "--center-C/--center-gamma)")
        try:
            grid = make_grid([float(v) for v in args.C_grid.split(",")],
                             [float(v) for v in args.gamma_grid.split(",")])
        except ValueError as e:
            raise SystemExit(f"tune: {e}")
    else:
        grid = log_grid(args.center_C, args.center_gamma, span=args.span,
                        step=args.step)
    base = SVMConfig(tau=args.tau, eps=args.eps, sv_tol=args.sv_tol,
                     max_iter=args.max_iter, degree=args.degree,
                     coef0=args.coef0)
    kernel_specs = (None if not args.kernels
                    else [k.strip() for k in args.kernels.split(",")])
    try:
        normalize_kernel_specs(kernel_specs, base)
        config = TuneConfig(
            folds=args.folds, seed=args.fold_seed, schedule=args.schedule,
            eta=args.eta, min_rung=args.min_rung,
            warm_start=not args.no_warm_start, patience=args.patience,
            plateau_tol=args.plateau_tol, fleet=args.fleet,
            fleet_compact=args.fleet_compact)
    except ValueError as e:
        raise SystemExit(f"tune: {e}")
    accum = "auto" if args.accum == "float64" else None
    from tpusvm_torch.utils import trace

    tracer = _make_tracer(args, "tune")
    timer = PhaseTimer(tracer=tracer)
    dataset = None
    if args.data:
        if args.train or args.synthetic:
            raise SystemExit("pass exactly one of --train / --synthetic / "
                             "--data")
        if args.n_limit is not None:
            raise SystemExit("--n-limit does not apply to --data (re-ingest "
                             "with --n-limit instead)")
        from tpusvm_torch.stream import open_dataset

        with timer.phase("data"):
            dataset = open_dataset(args.data)
        X = Y = Xt = Yt = None
        if args.test:
            Xt, Yt = _read(args.test, args, "svc")
        n, n_features = dataset.n_rows, dataset.n_features
    else:
        with timer.phase("data"):
            X, Y, Xt, Yt = _data(args, "svc")
        n, n_features = X.shape
    say = (lambda msg: None) if args.quiet else print
    say(f"n = {n}, n_features = {n_features}, grid = {grid.shape[0]}x"
        f"{grid.shape[1]}, folds = {args.folds}, schedule = {args.schedule}")
    with timer.phase("search"), trace(args.profile, device=args.device,
                                      tracer=tracer):
        result = tune(X, Y, grid, config, base=base, dtype=args.dtype,
                      accum_dtype=accum, scale=not args.no_scale,
                      solver_opts=_parse_solver_opts(args.solver_opt),
                      log_fn=say, dataset=dataset, tracer=tracer,
                      kernels=kernel_specs, device=args.device)
    print(format_table(result))
    if args.results:
        save_tune_result(args.results, result)
        say(f"results written to {args.results}")
    # the winner becomes a normal model: a full-data fit at the winning
    # point (its kernel family included), saved in the standard artifact
    win_cfg = dataclasses.replace(
        base, C=result.winner["C"], gamma=result.winner["gamma"],
        kernel=result.winner["kernel"], degree=result.winner["degree"],
        coef0=result.winner["coef0"])
    model = BinarySVC(config=win_cfg, dtype=args.dtype,
                      scale=not args.no_scale, device=args.device)
    with timer.phase("final-train"):
        if dataset is not None:
            model.fit_stream(dataset)
        else:
            model.fit(X, Y)
    say(f"winner model: {model.n_support_} SVs, status {model.status_.name}")
    test_acc = None
    if Xt is not None and len(Xt):
        test_acc = model.score(Xt, Yt)
        say(f"held-out accuracy = {test_acc:.4f}")
    if args.save:
        model.save(args.save)
        say(f"model saved to {args.save}")
    say(timer.report())
    if tracer is not None:
        from tpusvm_torch.obs import default_registry

        tracer.metrics_snapshot(default_registry().snapshot())
    _close_tracer(tracer)
    if args.smoke:
        evaluated = [r for r in result.points
                     if r["status"] == TuneStatus.EVALUATED.name]
        # beyond each family's first point every fold fit must have found
        # a warm seed; a fleet grid fits its population at once, so there
        # the warm gate is vacuous
        warm_ok = args.fleet or all(
            r["warm_seeded"] == args.folds
            for fam in {r["kernel"] for r in evaluated}
            for r in [r for r in evaluated if r["kernel"] == fam][1:])
        acc_ok = all(r["cv_accuracy"] is not None and r["cv_accuracy"] > 0.5
                     for r in evaluated)
        final_ok = test_acc is not None and test_acc > 0.8
        if not (warm_ok and acc_ok and final_ok):
            print(f"TUNE SMOKE FAILED: warm_ok={warm_ok} acc_ok={acc_ok} "
                  f"final_ok={final_ok} (test_acc={test_acc})")
            return 1
        print(f"tune smoke ok: {len(evaluated)} points over "
              f"{len(result.kernels)} kernel famil"
              f"{'ies' if len(result.kernels) > 1 else 'y'}, winner "
              f"kernel={result.winner['kernel']} C={result.winner['C']:g} "
              f"gamma={result.winner['gamma']:g}, test_acc={test_acc:.4f}")
    return 0


def _info_devices() -> int:
    import torch

    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device is visible (train and predict need "
              "--device cpu here)")
        return 0
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i} {p.name}, compute capability {p.major}.{p.minor}, "
              f"{p.total_memory / 2 ** 30:.1f} GiB")
    return 0


def _info_dataset(path: str) -> int:
    """Describe and verify a sharded dataset directory, as the JAX command
    line does: the manifest, then every shard whose StreamStatus is not OK
    (exit 1 then)."""
    from tpusvm_torch.status import StreamStatus
    from tpusvm_torch.stream import open_dataset

    ds = open_dataset(path)
    m = ds.manifest
    stats = m.global_stats()
    kind = "binary" if m.binary else "multiclass (raw labels)"
    print(f"sharded dataset: {m.n_rows} rows x {m.n_features} features, "
          f"{len(m.shards)} shards")
    print(f"labels: {kind}"
          + (f" (positive_label={m.positive_label})"
             if m.positive_label is not None else ""))
    print(f"class counts: {dict(sorted(stats.class_counts.items()))}")
    print(f"feature range: [{stats.min_val.min():g}, "
          f"{stats.max_val.max():g}]")
    statuses = ds.validate()
    bad = [(m.shards[i].filename, s.name)
           for i, s in enumerate(statuses) if s != StreamStatus.OK]
    if bad:
        print(f"validation FAILED on {len(bad)}/{len(statuses)} shards:")
        for name, status in bad:
            print(f"  {name}: {status}")
        return 1
    print(f"validation: all {len(statuses)} shards OK "
          "(checksums, row counts, stats)")
    return 0


def _info_artifact(path: str) -> int:
    """The JAX command line's description of a model artifact, a sharded
    dataset, a tune-results JSON or a tenant store."""
    import json
    import os
    import zipfile

    from tpusvm_torch.models import load_model, model_task
    from tpusvm_torch.stream import is_dataset_dir
    from tpusvm_torch.tenants import is_tenant_store
    from tpusvm_torch.tune import format_table, is_tune_result, load_tune_result

    if is_dataset_dir(path):
        return _info_dataset(path)
    if is_tune_result(path):
        print(format_table(load_tune_result(path)))
        return 0
    if is_tenant_store(path):
        return _info_tenant_store(path)
    if os.path.isdir(path):
        raise SystemExit(f"info: {path!r} is a directory without a "
                         "manifest.json: not a sharded dataset")
    if not zipfile.is_zipfile(path):
        try:
            with open(path) as f:
                json.load(f)
        except (OSError, ValueError) as e:
            raise SystemExit(f"info: {path!r} is not a readable model "
                             f"artifact ({e})")
        raise SystemExit(f"info: {path!r} is a JSON file but neither a "
                         "tune result nor a tenant store")
    try:
        task = model_task(path)
        state, config = load_model(path)
    except NotImplementedError as e:
        raise SystemExit(f"info: {e}")
    except (OSError, ValueError, KeyError) as e:
        raise SystemExit(f"info: {path!r} is not a readable model artifact "
                         f"({e})")
    kind = {"ovr": "multiclass (one-vs-rest)", "svr": "epsilon-SVR"}.get(
        task, "binary")
    print(f"model: {kind}")
    approx = is_approx_family(config.kernel)
    # approximate families: sv_X holds MAPPED rows; the raw width is the
    # map provenance field
    n_feat = (int(state["map_n_features_in"]) if approx
              and "map_n_features_in" in state else state["sv_X"].shape[1])
    if task == "ovr":
        print(f"classes: {state['classes'].tolist()}")
        print(f"SV union: {state['sv_X'].shape[0]}")
        print(f"n_features: {n_feat}")
    else:
        sv_key = "sv_coef" if task == "svr" else "sv_alpha"
        print(f"SV count: {len(state[sv_key])}")
        print(f"n_features: {n_feat}")
        print(f"b = {float(state['b']):.15f}")
    kern = f"kernel: {config.kernel}"
    if config.kernel == "poly":
        kern += f" (degree={config.degree} coef0={config.coef0:g})"
    if config.kernel == "sigmoid":
        kern += f" (coef0={config.coef0:g})"
    print(kern)
    if approx:
        # which map produced the mapped SV rows, and what rebuilds it
        dim = int(state["sv_X"].shape[1])
        if config.kernel == "rff":
            print(f"approx map: rff D={config.rff_dim} "
                  f"seed={config.map_seed} "
                  f"({n_feat} raw -> {dim} mapped features; omega "
                  "regenerates from config)")
        else:
            n_lm = (int(state["map_landmarks"].shape[0])
                    if "map_landmarks" in state else config.landmarks)
            print(f"approx map: nystrom landmarks={n_lm} "
                  f"seed={config.map_seed} "
                  f"({n_feat} raw -> {dim} mapped features; landmark "
                  "rows stored in the artifact)")
    print(f"config: C={config.C:g} gamma={config.gamma:g} "
          f"tau={config.tau:g} sv_tol={config.sv_tol:g}"
          + (f" epsilon={config.epsilon:g}" if task == "svr" else ""))
    print(f"scaled: {bool(state.get('scale', False))}")
    if task in ("svc", "svr"):
        prec = (str(state["train_precision"])
                if "train_precision" in state else "f32")
        se = int(state["shrink_every"]) if "shrink_every" in state else 0
        shrink = (f"every {se} rounds (stable {int(state['shrink_stable'])})"
                  if se else "off")
        print(f"trained: precision={prec} shrinking={shrink}")
        if "cascade_topology" in state:
            print(f"cascade: topology={str(state['cascade_topology'])} "
                  f"leaves={int(state['cascade_leaves'])} "
                  f"rounds={int(state['cascade_rounds'])}")
    if task == "svc":
        if "platt_a" in state:
            print(f"calibrated: yes (Platt A={float(state['platt_a']):.6f} "
                  f"B={float(state['platt_b']):.6f})")
        else:
            print("calibrated: no")
    return 0


# ------------------------------------------------------------- serving
def _add_serve_parsers(sub) -> None:
    """`serve` and `refresh`, with the JAX command line's flags."""
    sv = sub.add_parser(
        "serve", help="serve saved models over HTTP with deadline-aware "
        "micro-batching, one CUDA graph per row bucket (tpusvm_torch.serve)")
    sv.add_argument("--model", action="append", default=[],
                    metavar="[NAME=]NPZ", dest="models",
                    help="model to host, repeatable; NAME defaults to the "
                    "file stem (binary, one-vs-rest or SVR, either package's "
                    "artifact). Optional when --state names a manifest to "
                    "restore, --watch a directory to load from, or with "
                    "--smoke (which then fits a small rings model to host)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8471,
                    help="HTTP port (0 = ephemeral; default 8471)")
    sv.add_argument("--max-batch", type=int, default=64,
                    help="micro-batch coalescing cap = largest pad bucket")
    sv.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="max latency added waiting for batch co-riders")
    sv.add_argument("--queue-size", type=int, default=1024,
                    help="backpressure bound; a full queue fast-fails")
    sv.add_argument("--timeout-ms", type=float, default=1000.0,
                    help="default per-request deadline")
    sv.add_argument("--shed-threshold", type=float, default=None,
                    metavar="FRAC",
                    help="degraded mode: shed requests with OVERLOADED once "
                    "the queue holds FRAC of its capacity (0 < FRAC <= 1; "
                    "default: off, only the hard QUEUE_FULL bound applies)")
    sv.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive scoring failures that trip a model's "
                    "circuit breaker (requests then fail fast with "
                    "UNAVAILABLE; default 5)")
    sv.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                    help="open-breaker cooldown before a half-open probe is "
                    "admitted (default 30)")
    sv.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32", help="serving compute dtype")
    sv.add_argument("--no-warmup", action="store_true",
                    help="skip capturing the bucket graphs (the first "
                    "request per bucket then pays the capture)")
    rr = sv.add_argument_group("restart robustness / continuous serving")
    rr.add_argument("--cache-dir", metavar="DIR", default=None,
                    help="keep the bucket-signature manifest in DIR: every "
                    "warm-up and swap records the (model config, bucket) "
                    "programs it built (a CUDA graph cannot persist, so "
                    "each run captures its own); also honoured from "
                    "TPUSVM_CACHE_DIR")
    rr.add_argument("--assert-cached", action="store_true",
                    help="with --cache-dir: exit non-zero unless every "
                    "bucket signature this run built was already in DIR's "
                    "manifest when it started (the restart gate, run as "
                    "the second of two runs sharing DIR)")
    rr.add_argument("--state", metavar="JSON", default=None,
                    help="serialized registry manifest (serve_state.json, "
                    "either package's): restored at startup (the model set "
                    "reloads with its generation history) and atomically "
                    "rewritten after every successful load/swap")
    rr.add_argument("--watch", metavar="DIR", default=None,
                    help="poll DIR for model .npz files: a new stem loads "
                    "as a new model, a newer mtime on a hosted stem "
                    "hot-swaps it in (staged off to the side, probe-"
                    "verified, atomic generation flip; a bad artifact rolls "
                    "back and the old generation keeps serving)")
    rr.add_argument("--watch-interval-s", type=float, default=2.0,
                    help="--watch poll period (default 2.0)")
    sv.add_argument("--smoke", action="store_true",
                    help="no HTTP: warm up, fire concurrent in-process "
                    "requests, print metrics, exit non-zero on any error, "
                    "any post-warm-up capture or any served score that is "
                    "not the offline decision_function's bits (the gate)")
    sv.add_argument("--smoke-threads", type=int, default=8)
    sv.add_argument("--smoke-requests", type=int, default=32,
                    help="requests per smoke thread")
    sv.add_argument("--trace", metavar="PATH",
                    help="write a JSONL trace (role serve): a serve.request "
                    "span per HTTP predict, carrying the X-Tpusvm-Trace "
                    "context a router in front sent, the warm-up and smoke "
                    "phases, fault/retry events and the final metrics")
    sv.add_argument("--trace-max-bytes", type=int, default=None, metavar="N",
                    help="rotate the --trace file past N bytes (PATH.1 keeps "
                    "the previous file), so a long-running serve --trace "
                    "cannot fill the disk; default: unbounded")
    sv.add_argument("--profile", "--xprof", metavar="DIR", dest="profile",
                    help="capture a torch.profiler trace of the smoke or of "
                    "serving until shutdown into DIR/trace.json")
    slo = sv.add_argument_group("serving SLOs")
    slo.add_argument("--slo-p99-ms", type=float, default=None, metavar="MS",
                     help="per-model p99 latency target: at most 1%% of "
                     "windowed requests may exceed it; burn-rate gauges are "
                     "exported on /metrics and /healthz degrades while a "
                     "budget burns (default: no SLO)")
    slo.add_argument("--slo-error-budget", type=float, default=0.001,
                     metavar="FRAC",
                     help="allowed windowed error fraction "
                     "(errors/timeouts/unavailable; default 0.001)")
    slo.add_argument("--slo-window-s", type=float, default=60.0,
                     help="sliding SLO evaluation window (default 60)")
    slo.add_argument("--slo-shed", action="store_true",
                     help="admission control: shed new requests "
                     "(OVERLOADED, retryable) while the latency budget "
                     "burns; requires --slo-p99-ms")
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda")

    rf = sub.add_parser(
        "refresh", help="crash-safe online refresh: warm-start a refit from "
        "a DEPLOYED model's duals (binary, one-vs-rest or SVR), checkpoint "
        "it, save atomically, and hot-swap it into a running `serve` "
        "(tpusvm_torch.serve.refresh); --data DIR reads an append-grown "
        "sharded dataset")
    _add_data_args(rf, "--train", "training CSV (header line, last column "
                   "= label); its rows must start with the deployed run's")
    rf.add_argument("--test", metavar="CSV",
                    help="held-out CSV to score after the refit")
    rf.add_argument("--data", metavar="DIR",
                    help="a sharded dataset directory (`ingest`), read in "
                    "its manifest's row order")
    rf.add_argument("--model", metavar="NPZ",
                    help="the deployed artifact to refresh (required unless "
                    "--smoke); its config and duals seed the refit, and the "
                    "new data must keep its training rows as a prefix")
    rf.add_argument("--save", metavar="NPZ",
                    help="refreshed artifact output (atomic write; required "
                    "unless --smoke): drop it in a serve --watch directory "
                    "or name it with --swap")
    rf.add_argument("--cold", action="store_true",
                    help="skip the warm seed (the control arm the warm "
                    "path's update savings are measured against)")
    rf.add_argument("--checkpoint", metavar="NPZ",
                    help="crash-safe refit (binary): solver-carry "
                    "checkpoints every --checkpoint-every outer rounds; a "
                    "killed refresh resumed with --resume is bit-identical "
                    "to an uninterrupted one")
    rf.add_argument("--checkpoint-every", type=int, default=64, metavar="K")
    rf.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    rf.add_argument("--swap", metavar="URL", dest="swap_url",
                    help="after saving, POST /admin/swap on this running "
                    "serve frontend (e.g. http://127.0.0.1:8471): the staged "
                    "atomic flip; a refused swap reports the server's "
                    "rollback reason")
    rf.add_argument("--swap-name", metavar="NAME", default=None,
                    help="hosted model name to swap (default: the --save "
                    "file stem)")
    rf.add_argument("--smoke", action="store_true",
                    help="gate: deploy a tiny model, grow the data, refresh "
                    "warm + cold control, hot-swap in-process; asserts "
                    "convergence, warm update savings and bit-identical "
                    "served scores after the swap")
    rf.add_argument("-q", "--quiet", action="store_true")


def _add_closed_loop_parsers(sub) -> None:
    """`autopilot` and `tenants`, with the JAX command line's flags."""
    ap = sub.add_parser(
        "autopilot",
        help="supervised closed-loop online learning: watch an "
        "append-grown dataset, decide retrains off deterministic drift "
        "detectors, and drive crash-safe refresh + hot-swap unattended "
        "(tpusvm_torch.autopilot)")
    ap.add_argument("--data", metavar="DIR",
                    help="the sharded dataset to watch (grown by "
                    "stream appends; required unless --smoke)")
    ap.add_argument("--model", metavar="NPZ",
                    help="the deployed artifact the first refresh "
                    "warm-starts from (required unless --smoke); later "
                    "refreshes chain from the last swapped artifact")
    ap.add_argument("--save", metavar="NPZ", default=None,
                    help="refreshed-artifact output (atomic replace; "
                    "default: <model>.refresh.npz) — point a serve "
                    "--watch dir here for zero-coordination deploys")
    ap.add_argument("--state", metavar="JSON", default=None,
                    help="crash-safe supervisor state (atomic, "
                    "versioned, CRC-fingerprinted; default: "
                    "DATA/autopilot_state.json); --resume replays it")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed supervisor from --state: "
                    "decisions replay identically and an in-flight "
                    "refresh continues from its own checkpoint")
    ap.add_argument("--name", default=None,
                    help="hosted model name for swaps (default: the "
                    "--save file stem)")
    ap.add_argument("--swap", metavar="URL", dest="swap_url",
                    help="POST /admin/swap on this running serve "
                    "frontend after each refresh (omit for "
                    "artifact-drop mode: serve --watch picks up --save)")
    ap.add_argument("--interval-s", type=float, default=30.0,
                    help="tick period (default 30)")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="stop after N ticks (default: run forever)")
    det = ap.add_argument_group("drift detectors (None/off when unset)")
    det.add_argument("--growth-threshold", type=float, default=0.25,
                     help="refresh when appended rows exceed this "
                     "fraction of the rows at the last refresh "
                     "(default 0.25; -1 disables)")
    det.add_argument("--feature-threshold", type=float, default=0.10,
                     help="refresh when appended shards' min/max "
                     "escapes the deployed scaler's fitted range by "
                     "this relative fraction (default 0.10; -1 "
                     "disables)")
    det.add_argument("--score-threshold", type=float, default=0.20,
                     help="refresh when the served-score positive-rate "
                     "since the last refresh shifts this much vs the "
                     "baseline (needs --swap-less in-process serving "
                     "or smoke mode; -1 disables; default 0.20)")
    det.add_argument("--staleness-s", type=float, default=None,
                     help="refresh after this many seconds regardless "
                     "of drift (default: off)")
    det.add_argument("--min-new-rows", type=int, default=1,
                     help="suppress non-staleness refreshes until this "
                     "many rows appended (default 1)")
    det.add_argument("--jitter-frac", type=float, default=0.0,
                     help="seeded +/- threshold jitter fraction (the "
                     "fleet de-synchronizer; default 0 = exact)")
    det.add_argument("--seed", type=int, default=0,
                     help="decision seed (reports are byte-reproducible "
                     "per seed)")
    gate = ap.add_argument_group("retrain gating")
    gate.add_argument("--hysteresis", type=int, default=1,
                      help="consecutive triggered ticks required "
                      "(default 1)")
    gate.add_argument("--cooldown-s", type=float, default=0.0,
                      help="post-refresh quiet period (default 0)")
    gate.add_argument("--breaker-threshold", type=int, default=3,
                      help="consecutive refresh failures that trip the "
                      "refresh breaker into degraded-watch mode "
                      "(default 3)")
    gate.add_argument("--breaker-cooldown-s", type=float, default=60.0,
                      help="open-breaker cooldown before a half-open "
                      "refresh probe (default 60)")
    fit = ap.add_argument_group("refresh fit")
    fit.add_argument("--cold", action="store_true",
                     help="cold refits (skip the warm seed)")
    fit.add_argument("--checkpoint", metavar="NPZ", default=None,
                     help="crash-safe refit checkpoints (binary "
                     "artifacts; enables --deadline-s)")
    fit.add_argument("--checkpoint-every", type=int, default=64,
                     metavar="K")
    fit.add_argument("--deadline-s", type=float, default=None,
                     help="fit watchdog: stop a too-slow refit at a "
                     "checkpointed segment boundary and resume it on a "
                     "later tick (requires --checkpoint)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: ingest, deploy, append, run the "
                    "supervisor in-process against a live server under "
                    "any active fault plan; asserts a refresh lands, "
                    "the swap serves the refreshed bytes, and drift "
                    "reports are byte-reproducible")
    ap.add_argument("--smoke-ticks", type=int, default=6,
                    help="smoke tick budget (default 6)")
    ap.add_argument("--trace", metavar="PATH",
                    help="write a JSONL trace: autopilot.tick spans, "
                    "autopilot.drift decision events, fault events")
    ap.add_argument("--trace-max-bytes", type=int, default=None,
                    metavar="N", help="rotate the --trace file past N bytes")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the refits (and --smoke's server) run "
                    "(default: the card)")

    tn = sub.add_parser(
        "tenants",
        help="multi-tenant platform tier (tpusvm.tenants): thousands of "
        "per-tenant closed loops over ONE shared append-grown corpus — "
        "per-tenant drift detection, drifted tenants coalesced into "
        "power-of-two fleet refresh launches with warm seeds, staggered "
        "hot-swap roll-out")
    tn.add_argument("--data", metavar="DIR",
                    help="the shared sharded dataset every tenant views "
                    "(grown by stream appends; required unless --smoke)")
    tn.add_argument("--store", metavar="JSON", default=None,
                    help="crash-safe tenant registry + supervisor state "
                    "(atomic, versioned, CRC-fingerprinted; default: "
                    "DATA/tenants_store.json); --resume replays it")
    tn.add_argument("--artifacts", metavar="DIR", default=None,
                    help="refreshed per-tenant artifacts land here as "
                    "<tenant_id>.npz (atomic replace; default: "
                    "DATA/tenant_models) — point a serve --watch dir "
                    "here for zero-coordination deploys")
    tn.add_argument("--resume", action="store_true",
                    help="resume a killed supervisor from --store: "
                    "per-tenant decisions replay identically and an "
                    "in-flight coalesced launch continues from its "
                    "fleet checkpoint bit-identically")
    tn.add_argument("--swap", metavar="URL", dest="swap_url",
                    help="POST /admin/swap per tenant on this running "
                    "serve frontend after each refresh (omit for "
                    "artifact-drop mode)")
    tn.add_argument("--interval-s", type=float, default=30.0,
                    help="tick period (default 30)")
    tn.add_argument("--max-ticks", type=int, default=None,
                    help="stop after N ticks (default: run forever)")
    tdet = tn.add_argument_group("drift detectors (per tenant; "
                                 "None/off when unset)")
    tdet.add_argument("--growth-threshold", type=float, default=0.25,
                      help="refresh a tenant when appended rows exceed "
                      "this fraction of its rows at last refresh "
                      "(default 0.25; -1 disables)")
    tdet.add_argument("--feature-threshold", type=float, default=0.10,
                      help="refresh when appended shards' min/max "
                      "escapes the tenant artifact's fitted range by "
                      "this relative fraction (default 0.10; -1 "
                      "disables)")
    tdet.add_argument("--staleness-s", type=float, default=None,
                      help="refresh a tenant after this many seconds "
                      "regardless of drift (default: off)")
    tdet.add_argument("--min-new-rows", type=int, default=1,
                      help="suppress non-staleness refreshes until this "
                      "many rows appended (default 1)")
    tdet.add_argument("--jitter-frac", type=float, default=0.0,
                      help="seeded +/- threshold jitter fraction; each "
                      "tenant jitters with its own derived seed, so a "
                      "nonzero value de-synchronises the fleet "
                      "(default 0 = exact)")
    tdet.add_argument("--seed", type=int, default=0,
                      help="base decision seed (per-tenant seeds derive "
                      "from it; decisions replay per seed)")
    tgate = tn.add_argument_group("refresh gating + coalescing")
    tgate.add_argument("--hysteresis", type=int, default=1,
                       help="consecutive triggered ticks required per "
                       "tenant (default 1)")
    tgate.add_argument("--cooldown-s", type=float, default=0.0,
                       help="per-tenant post-refresh quiet period "
                       "(default 0)")
    tgate.add_argument("--min-fleet", type=int, default=2,
                       help="smallest drifted group coalesced into a "
                       "fleet launch; smaller groups refresh solo "
                       "(default 2)")
    tgate.add_argument("--stagger-s", type=float, default=0.0,
                       help="delay between per-tenant swaps of one "
                       "generation roll-out (default 0)")
    tgate.add_argument("--breaker-threshold", type=int, default=3,
                       help="consecutive all-failed refresh rounds that "
                       "trip the fleet refresh breaker (default 3)")
    tgate.add_argument("--breaker-cooldown-s", type=float, default=60.0,
                       help="open-breaker cooldown before a half-open "
                       "refresh probe (default 60)")
    tfit = tn.add_argument_group("refresh fit")
    tfit.add_argument("--cold", action="store_true",
                      help="cold refits (skip the deployed warm seeds)")
    tfit.add_argument("--checkpoint-every", type=int, default=64,
                      metavar="K",
                      help="fleet-checkpoint segment length in outer "
                      "rounds (default 64)")
    tn.add_argument("--smoke", action="store_true",
                    help="CI gate: provision a small tenant fleet over "
                    "one ingested corpus, grow it, run the supervisor "
                    "in-process against a live server under any active "
                    "fault plan; asserts a coalesced refresh lands, "
                    "every tenant's swap serves its refreshed bytes, "
                    "and the store resumes consistently")
    tn.add_argument("--smoke-tenants", type=int, default=8,
                    help="smoke fleet size (default 8)")
    tn.add_argument("--smoke-ticks", type=int, default=6,
                    help="smoke tick budget (default 6)")
    tn.add_argument("--trace", metavar="PATH",
                    help="write a JSONL trace: tenants.tick spans, "
                    "coalesced refresh and roll-out events, fault events")
    tn.add_argument("--trace-max-bytes", type=int, default=None,
                    metavar="N", help="rotate the --trace file past N bytes")
    tn.add_argument("-q", "--quiet", action="store_true")
    tn.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fleet launches and refits (and "
                    "--smoke's server) run (default: the card)")



def _serve_config(args):
    from tpusvm_torch.serve import ServeConfig

    return ServeConfig(
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        queue_size=args.queue_size,
        timeout_ms=args.timeout_ms,
        shed_threshold=args.shed_threshold,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        slo_p99_ms=args.slo_p99_ms,
        slo_error_budget=args.slo_error_budget,
        slo_window_s=args.slo_window_s,
        slo_shed=args.slo_shed,
    )


def _smoke_model(server, td: str) -> None:
    """`serve --smoke` with nothing named to host: a rings model (the JAX
    serving tests' fixture) saved and loaded as `rings`."""
    import os

    from tpusvm_torch.models import BinarySVC

    X, Y = rings(n=240, seed=2)
    path = os.path.join(td, "rings.npz")
    BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=server.device,
              dtype=server.dtype).fit(X, Y).save(path)
    server.load_model("rings", path)


def cmd_serve(args) -> int:
    import os
    import tempfile

    from tpusvm_torch.serve import ModelLoadError, Server

    cache_dir = args.cache_dir or os.environ.get("TPUSVM_CACHE_DIR")
    if args.assert_cached and not cache_dir:
        raise SystemExit("serve: --assert-cached needs --cache-dir (or "
                         "TPUSVM_CACHE_DIR): there is no manifest to hold "
                         "the run's bucket signatures against")
    if not (args.models or args.state or args.watch or args.smoke):
        raise SystemExit("serve: nothing to host — pass --model, --state "
                         "MANIFEST, or --watch DIR")
    try:
        cfg = _serve_config(args)
        cfg.resolved_slo()
        cfg.resolved_shed_at()
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    server = Server(cfg, dtype=args.dtype, device=args.device)
    tracer = _make_tracer(args, "serve", role="serve")
    with tempfile.TemporaryDirectory() as td:
        try:
            return _serve(args, server, cache_dir, td, tracer)
        except ModelLoadError as e:
            # the classified load failure (ServeStatus.LOAD_FAILED): the
            # offending path and cause, never a raw numpy/zipfile traceback
            raise SystemExit(f"serve: {e}")
        finally:
            if tracer is not None:
                for name in server.registry.names():
                    tracer.event("serve.metrics", model=name,
                                 snapshot=server.metrics(name))
                    tracer.metrics_snapshot(
                        server._worker(name).metrics.registry_snapshot())
            server.close()
            _close_tracer(tracer)


def _make_tracer(args, command: str, role=None):
    """The shared --trace plumbing: one Tracer (rotating past
    --trace-max-bytes) receiving the fault/retry/breaker lifecycle events
    and the compile observatory's prof.compile records (CUDA graph
    captures, nvcc builds: obs/prof.py), plus a profile.capture event when
    --profile/--xprof is also set, so the trace names the capture dir.

    role= makes the tracer a trace-context origin (serve, router, pod): its
    spans can be the resolved parents of other processes' spans when trace
    files merge in `report`."""
    if not getattr(args, "trace", None):
        return None
    from tpusvm_torch import faults
    from tpusvm_torch.obs import prof
    from tpusvm_torch.obs.trace import Tracer

    tracer = Tracer(args.trace, argv=[command], role=role,
                    max_bytes=getattr(args, "trace_max_bytes", None))
    faults.set_event_sink(tracer.event)
    prof.enable_profiling(event_sink=tracer.event)
    if getattr(args, "profile", None):
        tracer.event("profile.capture", dir=args.profile)
    return tracer


def _close_tracer(tracer) -> None:
    from tpusvm_torch.obs import prof

    prof.disable_profiling()
    if tracer is not None:
        from tpusvm_torch import faults

        faults.set_event_sink(None)
        tracer.close()


def _serve(args, server, cache_dir, td, tracer=None) -> int:
    import contextlib
    import json
    import os
    import signal

    if cache_dir:
        manifest = server.configure_cache(cache_dir)
        known = len(manifest.get("signatures", {}))
        print(f"bucket-signature manifest: {cache_dir} ({known} known "
              f"signatures{' — expecting a warm start' if known else ''})")
    if args.state:
        try:
            restored = server.restore_state(args.state)
        except FileNotFoundError:
            print(f"serve state {args.state}: absent (fresh start); will be "
                  "written after the first load")
        except ValueError as e:
            raise SystemExit(f"serve: --state: {e}")
        else:
            for n in restored["restored"]:
                gen = server.registry.generation(n)
                print(f"restored {n} (generation {gen}) from {args.state}")
            for n in restored["skipped"]:
                print(f"NOT restored (no source path recorded): {n}")
        server.enable_state(args.state)
    for spec in args.models:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = "", spec
        if not name:
            name = os.path.splitext(os.path.basename(path))[0]
        entry = server.load_model(name, path)
        print(f"loaded {name}: {entry.kind}, {entry.n_sv} SVs, "
              f"{entry.n_features} features, on {entry.device}")
    if args.smoke and not server.registry.names() and not args.watch:
        _smoke_model(server, td)
        print("smoke: hosting a rings model (C=10, gamma=10, 240 rows)")
    if not args.no_warmup:
        t = time.perf_counter()
        span = (tracer.span("warmup", phase=True) if tracer
                else contextlib.nullcontext())
        with span:
            built = server.warmup()
        for name, n in built.items():
            kind = ("CUDA graphs captured" if server.device.type == "cuda"
                    else "programs built")
            print(f"warmed {name}: {n} bucket {kind}")
        print(f"warm-up: {time.perf_counter() - t:.3f} s")

    watcher = None
    if args.watch:
        from tpusvm_torch.serve.watch import ModelWatcher

        watcher = ModelWatcher(server, args.watch,
                               interval_s=args.watch_interval_s,
                               log_fn=print)
        watcher.poll_once()  # pick up anything already there
        if not args.smoke:
            watcher.start()
        print(f"watching {args.watch} every {args.watch_interval_s:g}s")

    def cached_gate() -> int:
        if not args.assert_cached:
            return 0
        unknown = server.unknown_signatures()
        if unknown:
            print(f"SMOKE FAILED --assert-cached: {len(unknown)} bucket "
                  f"signatures this run built were not in the manifest: "
                  f"{unknown[:4]}")
            return 1
        print("assert-cached ok: every bucket signature this run built was "
              "in the manifest")
        return 0

    from tpusvm_torch.utils import trace as _profile_trace

    if args.smoke:
        span = (tracer.span("smoke", phase=True) if tracer
                else contextlib.nullcontext())
        with span, _profile_trace(args.profile, device=args.device):
            rc = _serve_smoke(server, args.smoke_threads,
                              args.smoke_requests)
        rc = rc or cached_gate()
        print(server.metrics_text(), end="")
        return rc

    from tpusvm_torch.serve.http import make_http_server

    httpd = make_http_server(server, host=args.host, port=args.port)
    # per-request serve.request spans honouring a propagated
    # X-Tpusvm-Trace context (a router in front names its forward span)
    httpd.tpusvm_tracer = tracer
    # close() owns the HTTP teardown: shutdown + server_close + join
    server.attach_http(httpd)
    host, port = httpd.server_address[:2]
    # with --port 0 the kernel chose the port just now: record the real
    # address into serve_state.json and flush the line
    server.set_bound_address(host, port)
    rc = cached_gate()
    if rc:
        return rc

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    print(f"serving on http://{host}:{port} "
          f"(POST /v1/models/<name>:predict, POST /admin/swap, "
          f"GET /metrics)", flush=True)
    try:
        with _profile_trace(args.profile, device=args.device):
            httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if watcher is not None:
            watcher.stop()
        print(server.metrics_text(), end="")
        print(json.dumps(server.status()), flush=True)
    return 0


def _serve_smoke(server, n_threads: int, n_requests: int) -> int:
    """Concurrent in-process exercise of every hosted model: the gate
    asserts zero errors, zero post-warm-up captures, and that every served
    score is the offline decision_function's bits on the same rows (the
    artifact loaded again, scored without the server)."""
    import threading

    from tpusvm_torch.models import load_any

    failures = []
    for name in server.registry.names():
        entry = server.registry.get(name)
        rng = np.random.default_rng(0)
        rows = rng.random((n_threads * n_requests, entry.n_features))
        got = np.empty(len(rows), dtype=object)
        bad = []
        lock = threading.Lock()

        def run(t, name=name, rows=rows, bad=bad, lock=lock, got=got):
            for i in range(t * n_requests, (t + 1) * n_requests):
                r = server.submit(name, rows[i], timeout_s=30.0)
                if not r.ok:
                    with lock:
                        bad.append(r.status)
                got[i] = r.scores

        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        snap = server.metrics(name)
        offline = "not compared (no artifact path)"
        if entry.source_path and not bad:
            est = load_any(entry.source_path, device=entry.device,
                           dtype=entry.dtype)
            want = np.asarray(est.decision_function(rows))
            same = np.array_equal(np.stack(list(got)), want)
            offline = "bit-equal" if same else "DIFFERENT"
            if not same:
                bad.append("scores differ from the offline decision_function")
        if bad or snap["errors"] or snap["recompiles"]:
            failures.append((name, bad[:4], snap["errors"],
                             snap["recompiles"]))
        print(f"smoke {name}: {snap['ok']} ok, {snap['errors']} errors, "
              f"{snap['recompiles']} recompiles, mean batch rows "
              f"{snap['mean_batch_rows']:.2f}, served scores vs offline "
              f"decision_function: {offline}")
    if failures:
        for name, bad, errors, recompiles in failures:
            print(f"SMOKE FAILED {name}: statuses={bad} errors={errors} "
                  f"recompiles={recompiles}")
        return 1
    return 0


def cmd_refresh(args) -> int:
    """Warm-started crash-safe refit of a deployed model + hot-swap."""
    import os

    from tpusvm_torch.models import model_task
    from tpusvm_torch.serve.refresh import refresh_fit, swap_via_http

    if args.smoke:
        return _refresh_smoke(args.device)
    if not args.model or not args.save:
        raise SystemExit("refresh: --model (the deployed artifact) and "
                         "--save (the refreshed output) are required (or "
                         "--smoke)")
    if args.resume and not args.checkpoint:
        raise SystemExit("refresh: --resume requires --checkpoint")
    say = (lambda msg: None) if args.quiet else print
    timer = PhaseTimer()
    # the loader needs the TASK the artifact was trained for (one-vs-rest
    # keeps raw labels, SVR reads continuous targets): sniff it
    try:
        task = model_task(args.model)
    except (OSError, ValueError) as e:
        raise SystemExit(f"refresh: {e}")
    t = time.perf_counter()
    if args.data:
        from tpusvm_torch.stream import open_dataset

        if task == "svr":
            raise SystemExit("refresh: svr artifacts read CSV/synthetic "
                             "continuous targets; sharded datasets store "
                             "integer labels")
        try:
            X, Y = open_dataset(args.data).load_arrays()
        except (OSError, ValueError) as e:
            raise SystemExit(f"refresh: --data: {e}")
        Xt = Yt = None
    else:
        X, Y, Xt, Yt = _data(args, task)
    timer.add("data", time.perf_counter() - t)
    say(f"refresh: {X.shape[0]} rows x {X.shape[1]} features ({task} "
        f"deployed: {args.model})")
    t = time.perf_counter()
    try:
        model = refresh_fit(
            args.model, X, Y, out_path=args.save,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume, warm=not args.cold, device=args.device)
    except (OSError, ValueError) as e:
        raise SystemExit(f"refresh: {e}")
    timer.add("training", time.perf_counter() - t)
    n_iter = (int(np.sum(model.n_iter_)) if np.ndim(model.n_iter_)
              else model.n_iter_)
    status = (model.status_.name if task != "ovr" else
              str([Status(int(s)).name for s in model.statuses_]))
    n_sv = model.n_support_ if task != "ovr" else len(model.X_sv_)
    say(f"refreshed model: {n_sv} SVs, {n_iter} updates, status {status}, "
        f"saved to {args.save}")
    if Xt is not None and len(Xt):
        t = time.perf_counter()
        acc = model.score(Xt, Yt)
        timer.add("prediction", time.perf_counter() - t)
        say(f"held-out {'r2' if task == 'svr' else 'accuracy'} = {acc:.4f}")
    if args.swap_url:
        name = args.swap_name or os.path.splitext(
            os.path.basename(args.save))[0]
        try:
            out = swap_via_http(args.swap_url, name,
                                os.path.abspath(args.save))
        except (RuntimeError, OSError) as e:
            raise SystemExit(f"refresh: {e}")
        say(f"swapped {name} -> generation {out['generation']} "
            f"({out['latency_s'] * 1e3:.1f} ms; the artifact is live)")
    say(timer.report())
    return 0


def _refresh_smoke(device: str) -> int:
    """The refresh loop's gate: deploy tiny, grow, refresh warm + cold
    control, hot-swap in-process; gates convergence, warm update savings,
    and bit-identical served scores after the swap."""
    import os
    import tempfile

    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.refresh import refresh_fit

    failures = []
    X, Y = rings(n=360, seed=11)
    with tempfile.TemporaryDirectory() as td:
        deployed = os.path.join(td, "deployed.npz")
        refreshed = os.path.join(td, "refreshed.npz")
        cfg = SVMConfig(C=10.0, gamma=10.0)
        # the deployed model: trained on the data's prefix
        BinarySVC(cfg, device=device).fit(X[:240], Y[:240]).save(deployed)
        warm = refresh_fit(deployed, X, Y, out_path=refreshed, device=device)
        cold = refresh_fit(deployed, X, Y,
                           out_path=os.path.join(td, "cold.npz"),
                           warm=False, device=device)
        if warm.status_.name != "CONVERGED":
            failures.append(f"warm refresh ended {warm.status_.name}")
        if cold.status_.name != "CONVERGED":
            failures.append(f"cold control ended {cold.status_.name}")
        if warm.n_iter_ >= cold.n_iter_:
            failures.append(
                f"warm seed saved nothing: {warm.n_iter_} updates warm vs "
                f"{cold.n_iter_} cold")
        acc = warm.score(X, Y)
        if acc <= 0.8:
            failures.append(f"refreshed accuracy gate failed ({acc:.4f})")
        # the hot-swap leg: deployed serves, the refresh swaps in, and the
        # served scores ARE the refreshed model's offline scores
        with Server(ServeConfig(max_batch=8), device=device) as srv:
            srv.load_model("m", deployed)
            srv.warmup()
            out = srv.swap("m", refreshed)
            scores, _ = srv.predict_direct("m", X[:16])
            ref = srv.registry.get("m")
            offline = BinarySVC.load(refreshed, device=device)
            want = np.asarray(offline.decision_function(X[:16]))
            if not np.array_equal(scores, want):
                failures.append("served scores after swap are not "
                                "bit-identical to the refreshed model")
            if out["generation"] != 2 or ref.generation != 2:
                failures.append(f"swap generation bookkeeping off: {out}")
            h = srv.health()
            if h["status"] != "ok" or h["swap"]["m"]["staleness_s"] < 0:
                failures.append(f"health after swap: {h['status']}")
    if failures:
        for f in failures:
            print(f"REFRESH SMOKE FAILED: {f}")
        return 1
    print(f"refresh smoke ok: warm {warm.n_iter_} vs cold {cold.n_iter_} "
          f"updates ({1 - warm.n_iter_ / cold.n_iter_:.1%} saved), accuracy "
          f"{acc:.4f}, swap generation 2, served scores bit-identical")
    return 0


def _traced(args, command: str, run) -> int:
    """Run `run()` under the command's --trace tracer; the trace ends with
    the process registry's snapshot (autopilot and tenants)."""
    tracer = _make_tracer(args, command)
    try:
        return run()
    finally:
        if tracer is not None:
            from tpusvm_torch.obs import default_registry

            tracer.metrics_snapshot(default_registry().snapshot())
        _close_tracer(tracer)


def cmd_autopilot(args) -> int:
    """The closed-loop online-learning supervisor (tpusvm_torch.autopilot);
    with --trace its autopilot.drift decisions reach the trace through the
    faults event sink."""
    return _traced(args, "autopilot", lambda: _autopilot(args))


def _autopilot(args) -> int:
    from tpusvm_torch.autopilot import Autopilot, AutopilotConfig, DriftThresholds

    if args.smoke:
        return _autopilot_smoke(args)
    if not args.data or not args.model:
        raise SystemExit("autopilot: --data DIR and --model NPZ are "
                         "required (or --smoke)")
    say = (lambda msg: None) if args.quiet else print

    def thr(v):
        return None if v is not None and v < 0 else v

    cfg = AutopilotConfig(
        data_dir=args.data,
        model_path=args.model,
        out_path=args.save,
        state_path=args.state,
        name=args.name,
        interval_s=args.interval_s,
        thresholds=DriftThresholds(
            feature=thr(args.feature_threshold),
            growth=thr(args.growth_threshold),
            score=thr(args.score_threshold),
            staleness_s=args.staleness_s,
            min_new_rows=args.min_new_rows,
            jitter_frac=args.jitter_frac,
        ),
        hysteresis=args.hysteresis,
        cooldown_s=args.cooldown_s,
        warm=not args.cold,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        deadline_s=args.deadline_s,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        seed=args.seed,
        device=args.device,
    )
    try:
        pilot = Autopilot(cfg, swap_url=args.swap_url,
                          resume=args.resume, log_fn=say)
    except (OSError, ValueError) as e:
        raise SystemExit(f"autopilot: {e}")
    say(f"autopilot: watching {args.data} every {cfg.interval_s:g}s "
        f"(state {pilot.cfg.state_path}, out {pilot.cfg.out_path})")
    try:
        out = pilot.run(max_ticks=args.max_ticks)
    except KeyboardInterrupt:
        out = {"ticks": pilot.state.tick,
               "generation": pilot.state.generation,
               "refreshes": pilot.state.refreshes,
               "failures": pilot.state.failures}
    say(f"autopilot: {out['ticks']} ticks, {out['refreshes']} "
        f"refreshes ({out['failures']} failures), generation "
        f"{out['generation']}")
    return 0


def _autopilot_smoke(args) -> int:
    """The gate: the whole closed loop in-process (ingest, deploy, serve,
    append, supervise) on args.device; a refresh lands, the swap serves
    the refreshed bytes, drift reports are byte-reproducible and a resumed
    supervisor replays the same state."""
    import os
    import tempfile

    from tpusvm_torch.autopilot import (
        Autopilot,
        AutopilotConfig,
        DriftThresholds,
        evaluate,
    )
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.status import AutopilotStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays, open_dataset

    failures = []
    X, Y = rings(n=400, seed=11)
    with tempfile.TemporaryDirectory() as td:

        data = os.path.join(td, "data")
        ingest_arrays(data, X[:240], Y[:240], rows_per_shard=64)
        deployed = os.path.join(td, "deployed.npz")
        BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=args.device).fit(
            X[:240], Y[:240]).save(deployed)
        thresholds = DriftThresholds(growth=0.5, feature=0.10,
                                     score=None, jitter_frac=0.0)
        with Server(ServeConfig(max_batch=8), device=args.device) as srv:
            srv.load_model("m", deployed)
            srv.warmup()
            ref_old, _ = srv.predict_direct("m", X[:16])
            cfg = AutopilotConfig(
                data_dir=data, model_path=deployed,
                out_path=os.path.join(td, "m.refresh.npz"),
                name="m", thresholds=thresholds, hysteresis=1,
                checkpoint_path=os.path.join(td, "refresh_ck.npz"),
                checkpoint_every=8,
                breaker_threshold=3, breaker_cooldown_s=0.1,
                seed=20260805, device=args.device,
            )
            pilot = Autopilot(cfg, server=srv,
                              log_fn=(lambda m: None) if args.quiet
                              else print)
            first = pilot.tick()
            if first["status"] != AutopilotStatus.WATCHING:
                failures.append(
                    f"tick on unchanged data: {first['status'].name}")
            # grow the dataset past the growth threshold (the appends
            # run through the crash-safe tail writer)
            w = ShardWriter.open_append(data)
            for s in range(240, 400, 40):
                w.append(X[s:s + 40], Y[s:s + 40])
            w.close()
            statuses = []
            for _ in range(args.smoke_ticks):
                statuses.append(pilot.tick()["status"])
                if statuses[-1] == AutopilotStatus.REFRESHED:
                    break
            if AutopilotStatus.REFRESHED not in statuses:
                failures.append(
                    "no refresh landed in "
                    f"{args.smoke_ticks} ticks: "
                    f"{[s.name for s in statuses]}")
            else:
                scores, _ = srv.predict_direct("m", X[:16])
                offline = BinarySVC.load(cfg.out_path, device=args.device)
                want = np.asarray(offline.decision_function(X[:16]))
                if not np.array_equal(scores, want):
                    failures.append("served scores after the autopilot "
                                    "swap are not bit-identical to the "
                                    "refreshed artifact")
                if np.array_equal(scores, ref_old):
                    failures.append("swap was a no-op (old == new "
                                    "scores — the gate is vacuous)")
                if srv.registry.generation("m") < 2:
                    failures.append("registry generation did not "
                                    "advance")
            # determinism: same inputs + seed => byte-identical report
            ds = open_dataset(data)
            kw = dict(manifest=ds.manifest,
                      fitted_min=np.zeros(2), fitted_max=np.ones(2),
                      rows_at_refresh=240, since_refresh_s=1.0,
                      score_baseline=None, score_current=None,
                      thresholds=thresholds, seed=7, tick=3)
            if evaluate(**kw).to_json_bytes() != \
                    evaluate(**kw).to_json_bytes():
                failures.append("drift report is not byte-reproducible")
            # resumed supervisor must replay to the same state
            pilot2 = Autopilot(cfg, server=srv, resume=True,
                               log_fn=lambda m: None)
            if pilot2.state.generation != pilot.state.generation \
                    or pilot2.state.rows_at_refresh \
                    != pilot.state.rows_at_refresh:
                failures.append("resumed state diverged: "
                                f"{pilot2.state} vs {pilot.state}")
    if failures:
        for f in failures:
            print(f"AUTOPILOT SMOKE FAILED: {f}")
        return 1
    print(f"autopilot smoke ok: refresh landed in "
          f"{len(statuses)} ticks "
          f"({pilot.state.failures} absorbed failures), generation "
          f"{pilot.state.generation}, served scores bit-identical, "
          "drift reports byte-reproducible")
    return 0


def cmd_tenants(args) -> int:
    """The multi-tenant coalescing supervisor (tpusvm_torch.tenants)."""
    return _traced(args, "tenants", lambda: _tenants(args))


def _tenants(args) -> int:
    from tpusvm_torch.autopilot import DriftThresholds
    from tpusvm_torch.tenants import TenantsConfig, TenantsSupervisor

    if args.smoke:
        return _tenants_smoke(args)
    if not args.data:
        raise SystemExit("tenants: --data DIR is required (or --smoke)")
    say = (lambda msg: None) if args.quiet else print

    def thr(v):
        return None if v is not None and v < 0 else v

    cfg = TenantsConfig(
        data_dir=args.data,
        store_path=args.store,
        artifacts_dir=args.artifacts,
        interval_s=args.interval_s,
        thresholds=DriftThresholds(
            feature=thr(args.feature_threshold),
            growth=thr(args.growth_threshold),
            score=None,
            staleness_s=args.staleness_s,
            min_new_rows=args.min_new_rows,
            jitter_frac=args.jitter_frac,
        ),
        hysteresis=args.hysteresis,
        cooldown_s=args.cooldown_s,
        warm=not args.cold,
        checkpoint_every=args.checkpoint_every,
        min_fleet=args.min_fleet,
        stagger_s=args.stagger_s,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        seed=args.seed,
        device=args.device,
    )
    try:
        sup = TenantsSupervisor(cfg, swap_url=args.swap_url,
                                resume=args.resume, log_fn=say)
    except (OSError, ValueError) as e:
        raise SystemExit(f"tenants: {e}")
    if not sup.state.tenants and not args.resume:
        raise SystemExit(
            "tenants: the store has no registered tenants — register "
            "them programmatically (TenantsSupervisor.register) or "
            "--resume an existing store"
        )
    say(f"tenants: supervising {len(sup.state.tenants)} tenants over "
        f"{args.data} every {cfg.interval_s:g}s (store "
        f"{sup.cfg.store_path}, artifacts {sup.cfg.artifacts_dir})")
    try:
        out = sup.run(max_ticks=args.max_ticks)
    except KeyboardInterrupt:
        out = {"ticks": sup.state.tick,
               "generation": sup.state.generation,
               "refreshes": sup.state.refreshes,
               "failures": sup.state.failures}
    say(f"tenants: {out['ticks']} ticks, {out['refreshes']} per-tenant "
        f"refreshes ({out['failures']} failures), generation "
        f"{out['generation']}")
    return 0


def _tenants_smoke(args) -> int:
    """The gate: the whole multi-tenant loop in-process (ingest one shared
    corpus, fit the tenants' donors, serve every tenant, grow the corpus,
    supervise) on args.device; one coalesced refresh lands, every
    tenant's swap serves its refreshed bytes, and the store resumes to the
    same fleet state."""
    import os
    import tempfile

    from tpusvm_torch.autopilot import DriftThresholds
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.status import TenantsStatus
    from tpusvm_torch.stream import ShardWriter, ingest_arrays
    from tpusvm_torch.tenants import (
        TenantRecord,
        TenantsConfig,
        TenantsSupervisor,
        load_store,
        tenant_labels,
    )

    say = (lambda m: None) if args.quiet else print
    failures = []
    n_tenants = max(2, args.smoke_tenants)
    K = 4
    rng = np.random.default_rng(20260806)
    n0, n1, d = 240, 120, 6
    X = rng.normal(size=(n0 + n1, d))
    labels = rng.integers(0, K, size=n0 + n1).astype(np.int32)
    for k in range(K):
        X[labels == k] += 0.8 * k
    with tempfile.TemporaryDirectory() as td:

        data = os.path.join(td, "data")
        ingest_arrays(data, X[:n0], labels[:n0], rows_per_shard=64)
        recs = []
        for i in range(n_tenants):
            recs.append(TenantRecord(
                tenant_id=f"tenant{i:03d}", positive_label=i % K,
                C=1.0 + 0.5 * (i % 3), gamma=0.3 + 0.1 * (i % 2),
                row_mod=(2 if i % 5 == 4 else None),
            ))
        with Server(ServeConfig(max_batch=8), device=args.device) as srv:
            for rec in recs:
                Y, valid = tenant_labels(labels[:n0], rec)
                opts = {} if valid is None else {"valid": valid}
                path = os.path.join(td, rec.tenant_id + ".donor.npz")
                BinarySVC(SVMConfig(C=rec.C, gamma=rec.gamma),
                          solver_opts=opts,
                          device=args.device).fit(X[:n0], Y).save(path)
                rec.model_path = path
                rec.rows_at_refresh = n0
                srv.load_model(rec.tenant_id, path)
            srv.warmup()
            cfg = TenantsConfig(
                data_dir=data,
                thresholds=DriftThresholds(growth=0.25, feature=0.10,
                                           score=None, jitter_frac=0.0),
                hysteresis=1, checkpoint_every=8,
                breaker_threshold=3, breaker_cooldown_s=0.1,
                seed=20260806, device=args.device,
            )
            sup = TenantsSupervisor(cfg, server=srv, log_fn=say)
            for rec in recs:
                sup.register(rec)
            first = sup.tick()
            if first["status"] != TenantsStatus.WATCHING:
                failures.append(
                    f"tick on unchanged data: {first['status'].name}")
            w = ShardWriter.open_append(data)
            w.append(X[n0:], labels[n0:])
            w.close()
            statuses = []
            for _ in range(args.smoke_ticks):
                statuses.append(sup.tick()["status"])
                if statuses[-1] in (TenantsStatus.REFRESHED,
                                    TenantsStatus.PARTIAL):
                    break
            if TenantsStatus.REFRESHED not in statuses:
                failures.append(
                    f"no coalesced refresh landed in {args.smoke_ticks} "
                    f"ticks: {[s.name for s in statuses]}")
            else:
                for rec in recs:
                    st_rec = sup.state.tenants[rec.tenant_id]
                    if st_rec.generation != 1:
                        failures.append(
                            f"{rec.tenant_id}: generation "
                            f"{st_rec.generation} != 1")
                        continue
                    scores, _ = srv.predict_direct(rec.tenant_id, X[:16])
                    offline = BinarySVC.load(st_rec.model_path,
                                             device=args.device)
                    want = np.asarray(offline.decision_function(X[:16]))
                    if not np.array_equal(scores, want):
                        failures.append(
                            f"{rec.tenant_id}: served scores after the "
                            "swap are not bit-identical to its "
                            "refreshed artifact")
                    if srv.registry.generation(rec.tenant_id) < 2:
                        failures.append(
                            f"{rec.tenant_id}: registry generation did "
                            "not advance")
            # the store must resume to the same fleet state
            sup2 = TenantsSupervisor(cfg, server=srv, resume=True,
                                     log_fn=lambda m: None)
            if sup2.state.generation != sup.state.generation or \
                    len(sup2.state.tenants) != len(sup.state.tenants):
                failures.append("resumed store diverged: "
                                f"gen {sup2.state.generation} vs "
                                f"{sup.state.generation}")
            persisted = load_store(sup.cfg.store_path)
            if persisted.stage != "idle":
                failures.append(
                    f"store left stage {persisted.stage!r} after a "
                    "completed round")
    if failures:
        for f in failures:
            print(f"TENANTS SMOKE FAILED: {f}")
        return 1
    print(f"tenants smoke ok: {n_tenants} tenants refreshed in one "
          f"coalesced generation ({sup.state.failures} absorbed "
          "failures), every tenant served its refreshed bytes, store "
          "resumes consistently")
    return 0




def _info_tenant_store(path: str) -> int:
    """Describe a multi-tenant registry/store file (the JAX command
    line's lines)."""
    from tpusvm_torch.tenants import load_store

    try:
        st = load_store(path)
    except ValueError as e:
        raise SystemExit(f"info: {e}")
    print(f"tenant store: {len(st.tenants)} tenants, generation "
          f"{st.generation} (tick {st.tick})")
    print(f"stage: {st.stage}"
          + (f" — in-flight launch over "
             f"{len(st.inflight.get('tenant_ids', []))} tenants at "
             f"{st.inflight.get('stage_rows')} rows"
             if st.inflight else ""))
    print(f"refreshes landed: {st.refreshes} ({st.failures} failures)")
    if st.tenants:
        gens = [r.generation for r in st.tenants.values()]
        subset = sum(1 for r in st.tenants.values()
                     if r.row_mod is not None)
        armed = sum(1 for r in st.tenants.values()
                    if r.consecutive_triggered > 0)
        print(f"tenant generations: min {min(gens)} max {max(gens)}")
        print(f"views: {subset} row-subset, "
              f"{len(st.tenants) - subset} full-corpus; {armed} "
              "drift-armed")
    return 0

# ------------------------------------------------- routing, fleet view
def _add_router_parsers(sub) -> None:
    """`router`, `fleet-metrics` and `top`, with the JAX command line's
    flags."""
    ro = sub.add_parser(
        "router",
        help="multi-replica routing tier (tpusvm_torch.router): an HTTP "
        "front door over N `serve` replicas — HRW placement, burn-aware "
        "admission, failover on connection failure/503, staggered "
        "rollouts with skew holds")
    ro.add_argument("--replica", action="append", default=[],
                    metavar="URL", dest="replicas",
                    help="replica base URL (http://host:port), "
                    "repeatable; the initial membership — /admin/join "
                    "and /admin/leave mutate it live")
    ro.add_argument("--host", default="127.0.0.1")
    ro.add_argument("--port", type=int, default=8470,
                    help="router HTTP port (0 = ephemeral; default 8470)")
    ro.add_argument("--replication", type=int, default=2, metavar="K",
                    help="HRW replication factor: a model's requests "
                    "prefer its K placed replicas (default 2)")
    ro.add_argument("--seed", type=int, default=0,
                    help="placement seed (tables are byte-reproducible "
                    "per seed)")
    ro.add_argument("--poll-interval-s", type=float, default=1.0,
                    help="replica /healthz poll period (default 1.0)")
    ro.add_argument("--down-after", type=int, default=2,
                    help="consecutive failed polls that mark a replica "
                    "down (default 2; one blip keeps its state)")
    ro.add_argument("--health-timeout-s", type=float, default=2.0,
                    help="per-poll fetch timeout (default 2.0)")
    ro.add_argument("--forward-timeout-s", type=float, default=10.0,
                    help="per-attempt forward timeout (default 10.0)")
    ro.add_argument("--skew-window", type=int, default=1,
                    help="rollout generation-skew hold threshold "
                    "(default 1: the steady staggered state)")
    ro.add_argument("--smoke", action="store_true",
                    help="gate: an in-process two-replica fleet behind the "
                    "router — concurrent clients, a replica outage mid-run "
                    "(failover must absorb it), a staggered rollout; "
                    "asserts zero lost responses, every score bitwise one "
                    "of the two generations, and a skew-free final vector")
    ro.add_argument("--smoke-threads", type=int, default=4)
    ro.add_argument("--smoke-requests", type=int, default=40,
                    help="requests per smoke thread")
    ro.add_argument("--trace", metavar="PATH",
                    help="write router.forward spans (one per proxied "
                    "request, carrying the minted trace context that "
                    "replicas honor) to a JSONL trace")
    ro.add_argument("--trace-max-bytes", type=int, default=None,
                    metavar="N")
    ro.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --smoke's replicas fit and score (the "
                    "router itself is host logic)")

    def add_fleet_sources(p):
        p.add_argument("--router", metavar="URL", default=None,
                       help="router base URL: adopts its /fleet/"
                       "metrics.json (the router scrapes its replicas)")
        p.add_argument("--replica", action="append", default=[],
                       metavar="URL", dest="replicas",
                       help="serve replica base URL (scrapes "
                       "/metrics.json), repeatable")
        p.add_argument("--snapshot-file", action="append", default=[],
                       metavar="PATH", dest="snapshot_files",
                       help="on-disk snapshot payload (e.g. an "
                       "autopilot metrics_snapshot_path drop), "
                       "repeatable")
        p.add_argument("--timeout-s", type=float, default=2.0,
                       help="per-scrape fetch timeout (default 2.0)")

    fm = sub.add_parser(
        "fleet-metrics",
        help="scrape every fleet process (serve replicas' "
        "/metrics.json, a router's /fleet/metrics.json, on-disk "
        "snapshot drops) and print ONE merged, (role, instance)-"
        "labelled metrics view (obs.fleet.merge_fleet: counters sum, "
        "gauges max, histograms add)")
    add_fleet_sources(fm)
    fm.add_argument("--format", choices=["text", "json"], default="text")
    fm.add_argument("--smoke", action="store_true",
                    help="gate: an in-process two-replica fleet behind a "
                    "router; non-zero exit unless the merged fleet view "
                    "equals merge_fleet() of the per-process snapshots "
                    "scraped directly (exact counter totals, label-tagged)")
    fm.add_argument("-q", "--quiet", action="store_true")
    fm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --smoke's replicas fit and score")

    tp = sub.add_parser(
        "top",
        help="live fleet table (one row per process: role, instance, "
        "pid, generation, request totals, qps, p99, burn, breaker, "
        "live shards) refreshed from the same sources as "
        "fleet-metrics")
    add_fleet_sources(tp)
    tp.add_argument("--interval-s", type=float, default=2.0,
                    help="refresh period (default 2.0)")
    tp.add_argument("--once", action="store_true",
                    help="scrape once, print one table, exit (scripts; no "
                    "screen clearing)")
    tp.add_argument("--iterations", type=int, default=0, metavar="N",
                    help="exit after N refreshes (0 = until Ctrl-C)")
    tp.add_argument("--no-clear", action="store_true",
                    help="append tables instead of clearing the screen")


def cmd_router(args) -> int:
    """The routing front door over `serve` replicas (host logic)."""
    import json
    import signal

    from tpusvm_torch.router import Router, RouterConfig, make_router_http

    if args.smoke:
        return _router_smoke(args)
    if not args.replicas:
        raise SystemExit("router: no fleet — pass --replica URL "
                         "(repeatable) or --smoke")
    cfg = RouterConfig(
        replicas=tuple(args.replicas),
        replication=args.replication,
        seed=args.seed,
        poll_interval_s=args.poll_interval_s,
        down_after=args.down_after,
        health_timeout_s=args.health_timeout_s,
        forward_timeout_s=args.forward_timeout_s,
        skew_window=args.skew_window,
    )
    tracer = _make_tracer(args, "router", role="router")
    router = Router(cfg, tracer=tracer).start()
    httpd = make_router_http(router, host=args.host, port=args.port)
    router.attach_http(httpd)
    host, port = httpd.server_address[:2]

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    print(f"routing on http://{host}:{port} over "
          f"{len(cfg.replicas)} replicas (k={cfg.replication}, "
          f"seed={cfg.seed}) — POST /v1/models/<name>:predict, "
          f"POST /admin/rollout|join|leave, GET /healthz /metrics "
          f"/v1/replicas", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        print(router.metrics_text(), end="")
        print(json.dumps(router.health()), flush=True)
        router.close()
        _close_tracer(tracer)
    return 0


def _smoke_replicas(paths, device, n=2):
    """n in-process serve replicas, each hosting paths[0] as "m" (warmed)
    behind its own HTTP listener: (servers, [(httpd, host, port)])."""
    from tpusvm_torch.serve import ServeConfig, Server
    from tpusvm_torch.serve.http import make_http_server, start_http_thread

    servers, fronts = [], []
    for _ in range(n):
        srv = Server(ServeConfig(max_batch=8), device=device)
        servers.append(srv)
        srv.load_model("m", paths[0])
        srv.warmup()
        httpd = make_http_server(srv, port=0)
        srv.attach_http(httpd, start_http_thread(httpd))
        host, port = httpd.server_address[:2]
        fronts.append((httpd, host, port))
    return servers, fronts


def _router_smoke(args) -> int:
    """Gate: an in-process two-replica fleet behind the router.

    Concurrent clients stream through Router.forward while the replica
    every request prefers goes dark mid-run (its HTTP listener stops:
    failover must absorb it) and comes back for a staggered rollout.
    Asserts zero lost responses, every score bitwise one of the two
    generations, a skew-free final vector and byte-reproducible placement
    tables."""
    import json
    import os
    import tempfile
    import threading

    from tpusvm_torch.models import BinarySVC, load_any
    from tpusvm_torch.obs.registry import MetricsRegistry
    from tpusvm_torch.router import (Router, RouterConfig, placement_table,
                                     table_bytes)
    from tpusvm_torch.serve.http import make_http_server, start_http_thread
    from tpusvm_torch.serve.http import stop_http_server
    from tpusvm_torch.status import RouterStatus

    failures = []
    Xa, Ya = rings(n=240, seed=2)
    Xb, Yb = rings(n=240, seed=9)
    A = BinarySVC(SVMConfig(C=10.0, gamma=10.0), device=args.device).fit(Xa, Ya)
    B = BinarySVC(SVMConfig(C=10.0, gamma=5.0), device=args.device).fit(Xb, Yb)
    Xq, _ = rings(n=16, seed=3)
    failovers = 0
    with tempfile.TemporaryDirectory() as td:
        pa, pb = os.path.join(td, "v1.npz"), os.path.join(td, "v2.npz")
        A.save(pa)
        B.save(pb)
        # the oracles: each artifact's offline decision_function, which a
        # served score equals bit for bit
        refA, refB = ([float(v) for v in np.asarray(
            load_any(p, device=args.device).decision_function(Xq))]
            for p in (pa, pb))
        if refA == refB:
            print("ROUTER SMOKE FAILED: generations are not "
                  "distinguishable — the bitwise gate is vacuous")
            return 1
        replicas, fronts, router = [], [], None
        try:
            replicas, fronts = _smoke_replicas([pa], args.device)
            urls = [f"http://{h}:{p}" for _, h, p in fronts]
            keys = ["m", "m-shadow", "m-canary"]
            if table_bytes(placement_table(keys, urls, k=2, seed=3)) \
                    != table_bytes(placement_table(list(keys), tuple(urls),
                                                   k=2, seed=3)):
                failures.append("placement tables for one seed are not "
                                "byte-identical")
            # a deliberately SLOW poller (0.9 s grace): the outage must be
            # met by forwards, i.e. the failover path, not admission
            reg = MetricsRegistry()
            router = Router(RouterConfig(
                replicas=tuple(urls), replication=2, seed=3,
                poll_interval_s=0.3, down_after=3, forward_timeout_s=15.0),
                registry=reg, log_fn=None)
            router.start()
            bad = []
            lock = threading.Lock()
            phase2 = threading.Event()  # set once the rollout finished

            def client(t):
                for i in range(args.smoke_requests):
                    idx = (t + i) % len(Xq)
                    body = json.dumps({"instances": [
                        np.asarray(Xq[idx], float).tolist()]}).encode()
                    code, data, _ra = router.forward("m", body)
                    if code == 429:
                        time.sleep(0.05)
                        continue
                    if code != 200:
                        with lock:
                            bad.append(("code", code, data[:120]))
                        continue
                    s = json.loads(data)["scores"][0]
                    if isinstance(s, list):
                        s = s[0]
                    allowed = ([refB[idx]] if phase2.is_set()
                               else [refA[idx], refB[idx]])
                    if s not in allowed:
                        with lock:
                            bad.append(("torn", idx, s))

            def metric(name):
                return sum(m["value"] for m in reg.snapshot()["metrics"]
                           if m["name"] == name)

            # the replica every "m" request prefers goes dark, so the
            # outage is met by forwards and absorbed by failover
            dark = urls.index(router.replica_set.placement("m")[0])
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(args.smoke_threads)]
            for t in threads:
                t.start()
            target = (args.smoke_threads * args.smoke_requests) // 4
            deadline = time.monotonic() + 30.0
            while metric("router.requests") < target \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            httpd0, host0, port0 = fronts[dark]
            stop_http_server(httpd0)  # the outage: connection refused
            for t in threads:
                t.join(120.0)
            if bad:
                failures.append(f"lost/torn responses during the outage: "
                                f"{bad[:5]} ({len(bad)} total)")
            failovers = metric("router.failovers")
            if not failovers:
                failures.append("the outage never exercised failover "
                                "(router.failovers == 0)")

            # phase 2: the dark replica returns on ITS port; the rollout
            httpd0b = make_http_server(replicas[dark], host=host0,
                                       port=port0)
            replicas[dark].attach_http(httpd0b, start_http_thread(httpd0b))
            fronts[dark] = (httpd0b, host0, port0)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                router.poller.poll_once()
                if all(s == "ok" for s in router.poller.states().values()):
                    break
                time.sleep(0.1)
            out = router.rollout("m", pb)
            rep = out["report"]
            gens = set(rep["vector"].values())
            if out["status"] != RouterStatus.OK.name or out["failed"] \
                    or len(out["swapped"]) != 2 or rep["skew"] != 0 \
                    or rep["unknown"] or len(gens) != 1:
                failures.append(f"rollout not clean/skew-free: {out}")
            phase2.set()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(args.smoke_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
            if bad:
                failures.append(f"post-rollout responses off the new "
                                f"generation: {bad[:5]}")
            h = router.health()
            if h["router"] != RouterStatus.OK.name:
                failures.append(f"router health not OK at the end: {h}")
        finally:
            if router is not None:
                router.close()
            for srv in replicas:
                srv.close()
    if failures:
        for f in failures:
            print(f"ROUTER SMOKE FAILED: {f}")
        return 1
    total = args.smoke_threads * args.smoke_requests * 2
    print(f"router smoke ok: {total} requests over 2 replicas, 0 "
          f"lost/torn (failovers {int(failovers)} absorbed the outage), "
          f"rollout skew-free, placement bytes reproducible")
    return 0


def _fleet_collector(args):
    """A FleetCollector from the shared --router/--replica/--snapshot-file
    source flags (fleet-metrics and top)."""
    from tpusvm_torch.obs.fleet import FleetCollector

    c = FleetCollector(timeout_s=args.timeout_s)
    n = 0
    if args.router:
        c.add_router(args.router)
        n += 1
    for url in args.replicas:
        c.add_replica(url)
        n += 1
    for path in args.snapshot_files:
        c.add_file(path)
        n += 1
    if not n:
        raise SystemExit(
            f"{args.cmd}: no fleet sources — pass --router URL, "
            "--replica URL (repeatable), and/or --snapshot-file PATH"
            + (" (or --smoke)" if args.cmd == "fleet-metrics" else ""))
    return c


def _fleet_metrics_smoke(args) -> int:
    """Gate: an in-process two-replica fleet behind a router; the merged
    fleet view must equal merge_fleet() of the per-process payloads it
    scraped (exact), and the merged serve.ok total must conserve the
    routed request count across the replicas (label-tagged)."""
    import json
    import os
    import tempfile

    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.obs.fleet import (FleetCollector, merge_fleet,
                                        render_fleet_text)
    from tpusvm_torch.obs.registry import (MetricsRegistry,
                                           render_snapshot_text)
    from tpusvm_torch.router import Router, RouterConfig

    failures = []
    X, Y = rings(n=96, seed=2)
    model = BinarySVC(SVMConfig(C=10.0, gamma=10.0),
                      device=args.device).fit(X, Y)
    Xq = np.asarray(X[:8], float)
    n_req, ok, per_replica = 12, 0, {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.npz")
        model.save(path)
        replicas, router = [], None
        try:
            replicas, fronts = _smoke_replicas([path], args.device)
            urls = [f"http://{h}:{p}" for _, h, p in fronts]
            router = Router(RouterConfig(
                replicas=tuple(urls), replication=2, seed=3,
                poll_interval_s=0.2, forward_timeout_s=10.0),
                registry=MetricsRegistry(), log_fn=None)
            router.start()
            for i in range(n_req):
                body = json.dumps(
                    {"instances": [Xq[i % len(Xq)].tolist()]}).encode()
                code, _, _ra = router.forward("m", body)
                ok += int(code == 200)
            if ok != n_req:
                failures.append(f"only {ok}/{n_req} requests scored "
                                "through the router")
            # scrape the fleet as `fleet-metrics` does: every replica
            # directly, plus the router's own payload
            coll = FleetCollector(timeout_s=2.0)
            for url in urls:
                coll.add_replica(url)
            coll.add_callable(router.fleet_payload, name="router")
            view = coll.scrape_once()
            if view.errors:
                failures.append(f"scrape errors: {view.errors}")
            # the published merged view is exactly merge_fleet() of the
            # per-process payloads it scraped, in rendered form
            if render_snapshot_text(view.merged) != render_snapshot_text(
                    merge_fleet(view.processes)):
                failures.append("merged view != merge_fleet() of the "
                                "scraped per-process snapshots")
            # conservation: the label-tagged per-replica serve.ok counters
            # sum to the routed request count (no double count, no loss)
            total = 0.0
            for m in view.merged["metrics"]:
                if m["name"] == "serve.ok" and m["type"] == "counter":
                    inst = m["labels"].get("instance", "?")
                    per_replica[inst] = per_replica.get(inst, 0.0) \
                        + m["value"]
                    total += m["value"]
            if total != float(ok):
                failures.append(
                    f"merged serve.ok total {total} != {ok} routed "
                    f"requests (per replica: {per_replica})")
            if len(per_replica) != 2:
                failures.append(f"expected 2 labelled replica instances, "
                                f"got {sorted(per_replica)}")
            if not args.quiet:
                print(render_fleet_text(view))
        finally:
            if router is not None:
                router.close()
            for srv in replicas:
                srv.close()
    if failures:
        for f in failures:
            print(f"FLEET-METRICS SMOKE FAILED: {f}")
        return 1
    print(f"fleet-metrics smoke ok: 2 replicas + router merged exactly; "
          f"serve.ok conserved at {n_req} across {sorted(per_replica)}")
    return 0


def cmd_fleet_metrics(args) -> int:
    """One merged, (role, instance)-labelled metrics view of a fleet."""
    import json

    from tpusvm_torch.obs.fleet import fleet_json, render_fleet_text

    if args.smoke:
        return _fleet_metrics_smoke(args)
    view = _fleet_collector(args).scrape_once()
    if args.format == "json":
        print(json.dumps(fleet_json(view), sort_keys=True))
    else:
        print(render_fleet_text(view), end="")
    # a partial scrape still prints (half a fleet view beats none), but a
    # fleet that is ENTIRELY unreachable is an error
    return 1 if view.errors and not view.processes else 0


def cmd_top(args) -> int:
    """Live fleet table over the fleet-metrics sources."""
    from tpusvm_torch.obs.fleet import format_top, top_rows

    coll = _fleet_collector(args)
    if args.once:
        view = coll.scrape_once()
        print(format_top(top_rows(view, coll.rates()), errors=view.errors),
              end="")
        return 1 if view.errors and not view.processes else 0
    t0 = time.monotonic()
    i = 0
    with coll:  # stop() joins the scrape thread on the way out
        coll.start(interval_s=args.interval_s)
        try:
            while True:
                view = coll.view()
                out = format_top(top_rows(view, coll.rates()),
                                 errors=view.errors,
                                 clock_s=time.monotonic() - t0)
                if not args.no_clear:
                    print("\x1b[2J\x1b[H", end="")
                print(out, end="", flush=True)
                i += 1
                if args.iterations and i >= args.iterations:
                    break
                time.sleep(args.interval_s)
        except KeyboardInterrupt:
            pass
    return 0


def _report_paths(raw_paths) -> list:
    """Expand the report positionals: directories become their sorted
    *.jsonl members (rotated .jsonl.N backups are folded in by
    read_trace, so they are not listed separately)."""
    import glob
    import os

    paths = []
    for p in raw_paths:
        if os.path.isdir(p):
            members = sorted(glob.glob(os.path.join(p, "*.jsonl")))
            if not members:
                raise SystemExit(
                    f"report: directory {p!r} holds no *.jsonl trace files"
                )
            paths.extend(members)
        else:
            paths.append(p)
    return paths


def cmd_report(args) -> int:
    """Render --trace JSONL telemetry back into the reference's
    human-readable contracts (phase timing block + convergence table),
    plus the compile observatory's cost table. Several files (or a
    directory) merge into one wall-clock-interleaved report: registry
    snapshots merge exactly, phase durations accumulate, and the total
    is the cross-process wall envelope."""
    from tpusvm_torch.obs import read_trace
    from tpusvm_torch.obs.report import (
        autopilot_rows,
        compile_rows,
        convergence_rows,
        cross_process_spans,
        format_autopilot_table,
        format_compile_table,
        format_convergence_table,
        format_round_gantt,
        format_timeline,
        merge_trace_files,
        nonzero_counters,
        phase_summary,
        render_phase_lines,
        reparent_stats,
    )

    paths = _report_paths(args.path)
    try:
        if len(paths) == 1:
            records = read_trace(paths[0])
        else:
            records = merge_trace_files(paths)
    except OSError as e:
        raise SystemExit(f"report: cannot read trace ({e})")
    except ValueError as e:
        if args.smoke:
            print(f"REPORT SMOKE FAILED: {e}")
            return 1
        raise SystemExit(f"report: {e}")

    phases, total = phase_summary(records)
    conv = convergence_rows(records)
    spans = sum(1 for r in records if r["kind"] == "span")
    events = sum(1 for r in records if r["kind"] == "event")
    label = paths[0] if len(paths) == 1 else f"{len(paths)} files"
    print(f"trace: {label} ({spans} spans, {events} events)")
    if len(paths) > 1:
        for p in paths:
            print(f"  {p}")
    print()
    comp = compile_rows(records)
    if comp:
        print("compiles (lower/compile wall time, XLA cost analysis):")
        print(format_compile_table(comp))
        print()
    print("convergence (b_low - b_high per outer round):")
    print(format_convergence_table(conv, max_rows=args.max_rows))
    print()
    auto = autopilot_rows(records)
    if auto:
        print("autopilot (drift decisions per tick):")
        print(format_autopilot_table(auto, max_rows=args.max_rows))
        print()
    counters = nonzero_counters(records)
    if counters:
        print("counters:")
        for line in counters:
            print(f"  {line}")
        print()
    _, roles = cross_process_spans(records)
    stats = None
    if len(roles) > 1:
        # a merged multi-process trace: the distributed-observability
        # payoff — ONE timeline across the fleet, spans re-parented by
        # the trace contexts propagated over frames/headers
        stats = reparent_stats(records)
        print(f"cross-process timeline ({stats['files']} files, "
              f"roles: {', '.join(roles)}; "
              f"{stats['reparented']} spans re-parented, "
              f"{stats['unresolved']} unresolved):")
        print(format_timeline(records, max_rows=args.max_rows))
        print()
        gantt = format_round_gantt(records)
        if gantt:
            print("pod rounds (gantt over the fit wall window):")
            print(gantt)
            print()
    print(render_phase_lines(phases, total))

    if args.smoke:
        failures = []
        if not phases:
            failures.append("no phase spans in the trace")
        if not conv:
            failures.append("no convergence records in the trace")
        if stats is not None and stats["unresolved"]:
            # every ctx-carrying file's root spans must have found their
            # origin span — a propagation break would silently flatten
            # the timeline otherwise
            failures.append(
                f"{stats['unresolved']} cross-process root span(s) "
                "failed to re-parent under their propagated context")
        if failures:
            for f in failures:
                print(f"REPORT SMOKE FAILED: {f}")
            return 1
        extra = ""
        if stats is not None:
            extra = (f", {stats['files']} files/"
                     f"{len(stats['roles'])} roles stitched "
                     f"({stats['reparented']} re-parented)")
        print(f"report smoke ok: {len(phases)} phases, "
              f"{len(conv)} convergence rounds" + extra)
    return 0


def cmd_benchdiff(args) -> int:
    """Schema-aware regression gate over two benchmark JSONL artifacts."""
    from tpusvm_torch.obs.benchdiff import run_benchdiff

    return run_benchdiff(args)


def cmd_info(args) -> int:
    return _info_artifact(args.path) if args.path else _info_devices()


def main(argv: Optional[List[str]] = None) -> int:
    import os

    parser = build_parser()
    args = parser.parse_args(argv)
    plan_path = args.faults or os.environ.get("TPUSVM_FAULTS")
    if plan_path:
        # chaos mode: activate the seeded fault plan before any subsystem
        # touches its injection points, so hit counting starts at 0
        from tpusvm_torch import faults

        try:
            plan = faults.load_plan(plan_path)
        except (OSError, ValueError) as e:
            parser.error(f"--faults: {e}")
        faults.activate(plan)
        print(f"fault plan active: {plan_path} "
              f"(seed {plan.seed}, {len(plan.rules)} rules)")
    return {"train": cmd_train, "pod": cmd_pod, "predict": cmd_predict,
            "ingest": cmd_ingest, "tune": cmd_tune, "serve": cmd_serve,
            "refresh": cmd_refresh, "autopilot": cmd_autopilot,
            "tenants": cmd_tenants, "router": cmd_router,
            "fleet-metrics": cmd_fleet_metrics, "top": cmd_top,
            "info": cmd_info, "report": cmd_report,
            "benchdiff": cmd_benchdiff}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
