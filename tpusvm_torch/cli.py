"""Command line: `python -m tpusvm_torch train|predict`.

train fits a model on a synthetic dataset, scores its held-out slice and
prints the reference's diagnostics (n and n_features, iterations, b to 15
places, the half gap x 1e10, the SV count, accuracy, phase timings), with
the JAX command line's flags and defaults for the solver (--solver
blocked|pair), the kernel family (--kernel, --degree, --coef0), one-vs-rest
(--multiclass), epsilon-SVR (--task svr, --epsilon) and Platt calibration
(--calibrate K). predict scores a saved model of any kind (either
package's `.npz`) on the same kind of synthetic held-out slice. Both run on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from tpusvm_torch.config import KERNEL_FAMILIES, SVMConfig
from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                         BENCH_NOISE_MULTICLASS, blobs,
                                         mnist_like, mnist_like_multiclass,
                                         rings, svr_sine)
from tpusvm_torch.status import Status

_SYNTHETIC = ("mnist_like", "rings", "blobs", "mnist_like_multiclass",
              "svr_sine")


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--synthetic", choices=_SYNTHETIC, required=True,
                   help="deterministic synthetic dataset (svr_sine: "
                   "continuous targets, --task svr only; "
                   "mnist_like_multiclass: class ids, --multiclass)")
    p.add_argument("--n", type=int, default=60000, help="train rows")
    p.add_argument("--n-test", type=int, default=10000, help="test rows")
    p.add_argument("--d", type=int, default=784,
                   help="feature count (mnist_like, blobs, svr_sine)")
    p.add_argument("--seed", type=int, default=587, help="data seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpusvm_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="fit a model and score it")
    _add_data_args(tr)
    tr.add_argument("--C", type=float, default=10.0)
    tr.add_argument("--gamma", type=float, default=0.00125)
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
    tr.add_argument("--save", metavar="PATH", help="write the model .npz")
    pr = sub.add_parser("predict", help="score a saved model")
    _add_data_args(pr)
    pr.add_argument("--model", metavar="PATH", required=True,
                    help="an artifact of either package (a one-vs-rest "
                    "model scores mnist_like as its 10-class draw)")
    return ap


def _data(args, multiclass: bool = False):
    """(X_train, Y_train, X_test, Y_test): the test slice is the tail."""
    total = args.n + args.n_test
    if args.synthetic == "mnist_like_multiclass" or (
            args.synthetic == "mnist_like" and multiclass):
        X, Y = mnist_like_multiclass(n=total, d=args.d, seed=args.seed,
                                     noise=BENCH_NOISE_MULTICLASS)
    elif args.synthetic == "mnist_like":
        X, Y = mnist_like(n=total, d=args.d, seed=args.seed,
                          noise=BENCH_NOISE, label_noise=BENCH_LABEL_NOISE)
    elif args.synthetic == "blobs":
        X, Y = blobs(n=total, d=args.d, seed=args.seed)
    elif args.synthetic == "svr_sine":
        X, Y = svr_sine(n=total, d=args.d, seed=args.seed)
    else:
        X, Y = rings(n=total, seed=args.seed)
    return X[:args.n], Y[:args.n], X[args.n:], Y[args.n:]


def _check_train_args(args) -> None:
    """The JAX command line's refusals of flag combinations."""
    if args.task == "ovr":
        args.multiclass = True
    if args.task == "svr":
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
    if args.calibrate:
        if args.calibrate < 2:
            raise SystemExit("--calibrate needs >= 2 folds")
        if args.multiclass:
            raise SystemExit("--calibrate applies to binary --mode single "
                             "training (Platt scaling of the binary "
                             "decision function)")
    if args.kernel in ("rff", "nystrom"):
        raise SystemExit(f"--kernel {args.kernel}: the approximate-kernel "
                         "feature maps are not ported yet (ROADMAP Queue 1 "
                         "item 10)")


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


def cmd_train(args) -> int:
    from tpusvm_torch.models import BinarySVC, EpsilonSVR, OneVsRestSVC

    _check_train_args(args)
    timer = _Timer()
    t = time.perf_counter()
    X, Y, Xt, Yt = _data(args, args.multiclass)
    timer.add("data", t)
    print(f"n = {X.shape[0]}, n_features = {X.shape[1]}")
    cfg = SVMConfig(C=args.C, gamma=args.gamma, max_iter=args.max_iter,
                    kernel=args.kernel, degree=args.degree, coef0=args.coef0,
                    epsilon=args.epsilon)
    solver = args.solver or ("pair" if args.multiclass else "blocked")
    opts = (dict(q=args.q, wss=args.wss, max_inner=args.max_inner)
            if solver == "blocked" else {})
    opts.update(_parse_solver_opts(args.solver_opt))
    common = dict(config=cfg, device=args.device, solver=solver,
                  solver_opts=opts)
    if args.task == "svr":
        model = EpsilonSVR(**common)
    elif args.multiclass:
        model = OneVsRestSVC(**common)
    else:
        model = BinarySVC(**common)
    t = time.perf_counter()
    model.fit(X, Y)
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
    _accuracy_line(model, Xt, Yt, timer, args.task)
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
    _, _, Xt, Yt = _data(args, kind == "ovr")
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "predict": cmd_predict}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
