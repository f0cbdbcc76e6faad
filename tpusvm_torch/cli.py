"""Command line: `python -m tpusvm_torch train|predict`.

train fits a BinarySVC on a synthetic dataset, scores its held-out slice
and prints the reference's diagnostics (n and n_features, iterations, b to
15 places, the half gap x 1e10, the SV count, accuracy, phase timings).
predict scores a saved model (either package's `.npz`) on the same kind of
synthetic held-out slice. Both run on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.synthetic import (BENCH_LABEL_NOISE, BENCH_NOISE,
                                         blobs, mnist_like, rings)

_SYNTHETIC = ("mnist_like", "rings", "blobs")


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--synthetic", choices=_SYNTHETIC, required=True,
                   help="deterministic synthetic dataset")
    p.add_argument("--n", type=int, default=60000, help="train rows")
    p.add_argument("--n-test", type=int, default=10000, help="test rows")
    p.add_argument("--d", type=int, default=784,
                   help="feature count (mnist_like, blobs)")
    p.add_argument("--seed", type=int, default=587, help="data seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpusvm_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="fit a binary RBF SVM and score it")
    _add_data_args(tr)
    tr.add_argument("--C", type=float, default=10.0)
    tr.add_argument("--gamma", type=float, default=0.00125)
    tr.add_argument("--q", type=int, default=1024, help="working-set size")
    tr.add_argument("--wss", type=int, choices=(1, 2), default=1)
    tr.add_argument("--max-inner", type=int, default=1024)
    tr.add_argument("--max-iter", type=int, default=100000)
    tr.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra blocked_smo_solve keyword (repeatable), e.g. "
                    "multipair=4 or fused_selection=true")
    tr.add_argument("--save", metavar="PATH", help="write the model .npz")
    pr = sub.add_parser("predict", help="score a saved model")
    _add_data_args(pr)
    pr.add_argument("--model", metavar="PATH", required=True)
    return ap


def _data(args):
    """(X_train, Y_train, X_test, Y_test): the test slice is the tail."""
    total = args.n + args.n_test
    if args.synthetic == "mnist_like":
        X, Y = mnist_like(n=total, d=args.d, seed=args.seed,
                          noise=BENCH_NOISE, label_noise=BENCH_LABEL_NOISE)
    elif args.synthetic == "blobs":
        X, Y = blobs(n=total, d=args.d, seed=args.seed)
    else:
        X, Y = rings(n=total, seed=args.seed)
    return X[:args.n], Y[:args.n], X[args.n:], Y[args.n:]


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


def _accuracy_line(model, Xt, Yt, timer) -> None:
    if not len(Yt):
        return
    t = time.perf_counter()
    acc = model.score(Xt, Yt)
    timer.add("prediction", t)
    m = len(Yt)
    print(f"accuracy = {acc:.4f} ({round(acc * m)}/{m})")


def cmd_train(args) -> int:
    from tpusvm_torch.models.svm import BinarySVC

    timer = _Timer()
    t = time.perf_counter()
    X, Y, Xt, Yt = _data(args)
    timer.add("data", t)
    print(f"n = {X.shape[0]}, n_features = {X.shape[1]}")
    cfg = SVMConfig(C=args.C, gamma=args.gamma, max_iter=args.max_iter)
    opts = dict(q=args.q, wss=args.wss, max_inner=args.max_inner)
    opts.update(_parse_solver_opts(args.solver_opt))
    model = BinarySVC(config=cfg, device=args.device, solver_opts=opts)
    t = time.perf_counter()
    model.fit(X, Y)
    timer.add("training", t)
    print(f"iterations = {model.n_iter_}")
    print(f"b = {model.b_:.15f}")
    if np.isfinite(model.b_high_):
        gap = (model.b_high_ - model.b_low_) / 2.0
        print(f"(b_high - b_low)/2 * 1e10 = {gap * 1e10:.6f}")
    print(f"SV count = {model.n_support_}")
    print(f"status = {model.status_.name}")
    _accuracy_line(model, Xt, Yt, timer)
    if args.save:
        model.save(args.save)
        print(f"model saved to {args.save}")
    print(timer.report())
    return 0


def cmd_predict(args) -> int:
    from tpusvm_torch.models.svm import BinarySVC

    timer = _Timer()
    t = time.perf_counter()
    _, _, Xt, Yt = _data(args)
    timer.add("data", t)
    model = BinarySVC.load(args.model, device=args.device)
    print(f"SV count = {model.n_support_}")
    _accuracy_line(model, Xt, Yt, timer)
    print(timer.report())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"train": cmd_train, "predict": cmd_predict}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
