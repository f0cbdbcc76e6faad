"""Command line: `python -m tpusvm_torch train|predict|info`.

train fits a model on a CSV (--train, last column = label; --test scores a
held-out CSV) or a synthetic dataset, scores the held-out rows and prints
the reference's diagnostics (n and n_features, iterations, b to 15
places, the half gap x 1e10, the SV count, accuracy, phase timings), with
the JAX command line's flags and defaults: the hyperparameters (--preset,
--C, --gamma, --tau, --eps, --sv-tol), the numerics (--accum, --no-scale),
the mode (--mode single, or oracle: the serial NumPy SMO), the solver
(--solver blocked|pair), the kernel family (--kernel, --degree, --coef0),
one-vs-rest (--multiclass), epsilon-SVR (--task svr, --epsilon), Platt
calibration (--calibrate K), crash-safe checkpoints (--checkpoint,
--resume, --checkpoint-every) and active-set shrinking (--shrink-every,
--shrink-stable). predict scores a saved model of any kind (either
package's `.npz`) on a CSV (--data) or the synthetic held-out slice. info
prints the torch/CUDA versions and the visible devices, or describes a
model artifact. train and predict run on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from tpusvm_torch.config import (DATASET_PRESETS, KERNEL_FAMILIES,
                                 SVMConfig, preset)
from tpusvm_torch.data.csv_reader import read_csv, read_csv_regression
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                         BENCH_NOISE_MULTICLASS, blobs,
                                         mnist_like, mnist_like_multiclass,
                                         rings, svr_sine)
from tpusvm_torch.status import Status

_SYNTHETIC = ("mnist_like", "rings", "blobs", "mnist_like_multiclass",
              "svr_sine")


def _add_data_args(p: argparse.ArgumentParser, csv_flag: str,
                   csv_help: str) -> None:
    p.add_argument(csv_flag, metavar="CSV", help=csv_help)
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
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpusvm_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="fit a model and score it")
    _add_data_args(tr, "--train", "training CSV (header line, last column "
                   "= label)")
    tr.add_argument("--test", metavar="CSV",
                    help="held-out CSV to score (with --train)")
    tr.add_argument("--mode", choices=("single", "oracle", "cascade", "pod"),
                    default="single",
                    help="single = on-device SMO; oracle = the serial NumPy "
                    "SMO (binary; the reference's main3.cpp); cascade and "
                    "pod are not ported yet")
    tr.add_argument("--preset", choices=sorted(DATASET_PRESETS),
                    default=None, help="named (C, gamma) preset (overrides "
                    "--C and --gamma)")
    tr.add_argument("--C", type=float, default=10.0)
    tr.add_argument("--gamma", type=float, default=0.00125)
    tr.add_argument("--tau", type=float, default=1e-5)
    tr.add_argument("--eps", type=float, default=1e-12)
    tr.add_argument("--sv-tol", type=float, default=1e-8)
    tr.add_argument("--accum", choices=("none", "float64"), default="float64",
                    help="solver accumulator dtype: float64 (default; f32 "
                    "features, f64 alpha and f) or none (the features' f32)")
    tr.add_argument("--no-scale", action="store_true",
                    help="skip min-max feature scaling")
    tr.add_argument("--solver", choices=("blocked", "pair"), default=None,
                    help="blocked working-set solver (default; binary and "
                    "svr) or pair (one pair per iteration; the default with "
                    "--multiclass, where the heads run in lockstep)")
    tr.add_argument("--q", type=int, default=1024,
                    help="working-set size (blocked)")
    tr.add_argument("--wss", type=int, choices=(1, 2), default=1,
                    help="inner partner rule (blocked)")
    tr.add_argument("--max-inner", type=int, default=1024,
                    help="inner updates per round (blocked)")
    tr.add_argument("--max-iter", type=int, default=100000)
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
                    "+ coef0); rff / nystrom are not ported yet")
    tr.add_argument("--degree", type=int, default=3,
                    help="polynomial degree (--kernel poly)")
    tr.add_argument("--coef0", type=float, default=0.0,
                    help="polynomial/sigmoid additive term")
    tr.add_argument("--multiclass", action="store_true",
                    help="one-vs-rest over all labels instead of the "
                    "reference's binary '1 vs rest' mapping")
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
                    help="crash-safe training (binary, blocked solver): "
                    "write the solver's outer-loop carry here every "
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
    pr = sub.add_parser("predict", help="score a saved model")
    _add_data_args(pr, "--data", "CSV to score (header line, last column = "
                   "label)")
    pr.add_argument("--model", metavar="PATH", required=True,
                    help="an artifact of either package (a one-vs-rest "
                    "model scores mnist_like as its 10-class draw)")
    inf = sub.add_parser("info", help="print the torch/CUDA versions and the "
                         "visible devices, or describe a model artifact")
    inf.add_argument("path", nargs="?", default=None,
                     help="a model .npz of either package")
    return ap


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
    one-vs-rest, else the binary `!= positive_label -> -1` mapping."""
    if task == "svr":
        return read_csv_regression(path, n_limit=n_limit)
    return read_csv(path, n_limit=n_limit, binary=task != "ovr",
                    positive_label=args.positive_label)


def _data(args, task: str = "svc"):
    """(X_train, Y_train, X_test, Y_test); the test side is None without
    --test. A synthetic draw's test slice is its tail, so --n-limit cuts
    the training rows without moving the test rows."""
    if (args.train is None) == (args.synthetic is None):
        raise SystemExit("pass exactly one of --train / --synthetic")
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
    if args.mode in ("cascade", "pod"):
        raise SystemExit(f"--mode {args.mode} is not ported yet (ROADMAP "
                         "Queue 1 item 9)")
    if args.test and not args.train:
        raise SystemExit("--test scores a held-out CSV; it needs --train")
    if args.task == "svr":
        if args.mode != "single":
            raise SystemExit("--task svr requires --mode single")
        if args.multiclass:
            raise SystemExit("--task svr is a regression task; "
                             "--multiclass does not apply")
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
    if args.kernel in ("rff", "nystrom"):
        raise SystemExit(f"--kernel {args.kernel}: the approximate-kernel "
                         "feature maps are not ported yet (ROADMAP Queue 1 "
                         "item 10)")
    if args.mode == "oracle" and (args.solver_opt or args.shrink_every):
        raise SystemExit("--solver-opt/--shrink-every have no effect on "
                         "--mode oracle (the NumPy oracle has no solver "
                         "knobs)")
    solver = args.solver or ("pair" if args.multiclass else "blocked")
    if args.resume and not args.checkpoint:
        raise SystemExit("--resume requires --checkpoint")
    if args.checkpoint:
        if args.mode == "oracle":
            raise SystemExit("--checkpoint applies to --mode single "
                             "(solver-state checkpoints); the NumPy oracle "
                             "has no checkpointable structure")
        if args.multiclass or args.task == "svr" or solver != "blocked":
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
        if args.checkpoint:
            raise SystemExit(
                "--shrink-every and --checkpoint both segment the outer "
                "loop and cannot be combined yet")
        if args.multiclass:
            raise SystemExit("--shrink-every supports binary/svr --mode "
                             "single training for now")


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


class _Timer:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.acc = {}

    def add(self, name: str, since: float) -> None:
        self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - since

    def report(self) -> str:
        lines = [f"{k} time: {v:.3f} s" for k, v in self.acc.items()]
        lines.append(f"elapsed time: {time.perf_counter() - self.t0:.3f} s")
        return "\n".join(lines)


def _accuracy_line(model, Xt, Yt, timer, task: str = "svc") -> None:
    if not len(Yt):
        return
    t = time.perf_counter()
    acc = model.score(Xt, Yt)
    timer.add("prediction", t)
    m = len(Yt)
    if task == "svr":
        # score() is R^2 for the regression task
        rmse = float(np.sqrt(np.mean(
            (model.predict(Xt) - np.asarray(Yt, np.float64)) ** 2)))
        print(f"r2 = {acc:.4f}  rmse = {rmse:.4f} ({m} rows)")
    else:
        print(f"accuracy = {acc:.4f} ({round(acc * m)}/{m})")


def _config(args) -> SVMConfig:
    kw = dict(tau=args.tau, eps=args.eps, sv_tol=args.sv_tol,
              max_iter=args.max_iter, kernel=args.kernel, degree=args.degree,
              coef0=args.coef0, epsilon=args.epsilon)
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


def cmd_train(args) -> int:
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC

    _check_train_args(args)
    cfg = _config(args)
    task = "ovr" if args.multiclass else args.task
    timer = _Timer()
    t = time.perf_counter()
    X, Y, Xt, Yt = _data(args, task)
    timer.add("data", t)
    print(f"n = {X.shape[0]}, n_features = {X.shape[1]}")
    solver = args.solver or ("pair" if args.multiclass else "blocked")
    opts = (dict(q=args.q, wss=args.wss, max_inner=args.max_inner)
            if solver == "blocked" else {})
    opts.update(_parse_solver_opts(args.solver_opt))
    if args.shrink_every:
        if "shrink_every" in opts:
            raise SystemExit("--shrink-every and --solver-opt shrink_every= "
                             "are the same knob; pass one")
        opts["shrink_every"] = args.shrink_every
        opts.setdefault("shrink_stable", args.shrink_stable)
    common = dict(config=cfg, device=args.device, solver=solver,
                  solver_opts=opts, scale=not args.no_scale,
                  accum_dtype="auto" if args.accum == "float64" else None)
    t = time.perf_counter()
    if args.mode == "oracle":
        model = _fit_oracle(X, Y, cfg, args.device)
    elif args.task == "svr":
        model = EpsilonSVR(**common).fit(X, Y)
    elif args.multiclass:
        model = OneVsRestSVC(**common).fit(X, Y)
    else:
        model = BinarySVC(**common).fit(
            X, Y, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume)
    timer.add("training", t)
    if args.multiclass:
        print(f"classes = {[int(c) for c in model.classes_]}")
        print(f"status = {[Status(int(s)).name for s in model.statuses_]}")
    else:
        print(f"iterations = {model.n_iter_}")
        print(f"b = {model.b_:.15f}")
        if np.isfinite(model.b_high_):
            gap = (model.b_high_ - model.b_low_) / 2.0
            print(f"(b_high - b_low)/2 * 1e10 = {gap * 1e10:.6f}")
        print(f"SV count = {model.n_support_}")
        print(f"status = {model.status_.name}")
    if args.calibrate:
        t = time.perf_counter()
        model.calibrate(X, Y, folds=args.calibrate)
        timer.add("calibration", t)
        print("calibrated: Platt A=%.6f B=%.6f" % model.platt_)
    if Xt is not None:
        _accuracy_line(model, Xt, Yt, timer, task)
    if args.save:
        model.save(args.save)
        print(f"model saved to {args.save}")
    print(timer.report())
    return 0


def cmd_predict(args) -> int:
    from tpusvm_torch.models import load_any, model_task

    timer = _Timer()
    kind = model_task(args.model)
    t = time.perf_counter()
    if (args.data is None) == (args.synthetic is None):
        raise SystemExit("pass exactly one of --data / --synthetic")
    if args.data:
        Xt, Yt = _read(args.data, args, kind, args.n_limit)
    else:
        _, _, Xt, Yt = _data(argparse.Namespace(**vars(args), train=None,
                                                test=None), kind)
    timer.add("data", t)
    model = load_any(args.model, device=args.device)
    if kind == "ovr":
        print(f"classes = {[int(c) for c in model.classes_]}")
        print(f"SV count = {len(model.X_sv_)}")
    else:
        print(f"SV count = {model.n_support_}")
    _accuracy_line(model, Xt, Yt, timer, kind)
    print(timer.report())
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


def _info_artifact(path: str) -> int:
    """The JAX command line's description of a model artifact. The other
    artifact kinds it describes belong to modules not ported yet."""
    import json
    import os
    import zipfile

    from tpusvm_torch.models import load_model, model_task

    if os.path.isdir(path):
        raise SystemExit(f"info: {path!r} is a directory; sharded datasets "
                         "are not ported yet (ROADMAP Queue 1 item 11)")
    if not zipfile.is_zipfile(path):
        try:
            with open(path) as f:
                json.load(f)
        except (OSError, ValueError) as e:
            raise SystemExit(f"info: {path!r} is not a readable model "
                             f"artifact ({e})")
        raise SystemExit(f"info: {path!r} is a JSON file; tune results and "
                         "tenant stores are not ported yet (ROADMAP Queue 1 "
                         "item 11)")
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
    n_feat = state["sv_X"].shape[1]
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


def cmd_info(args) -> int:
    return _info_artifact(args.path) if args.path else _info_devices()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "predict": cmd_predict,
            "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
