#!/usr/bin/env python3
"""The streamed rff primal fit on chip_smoke.py phase 5's data at several
mini-batch sizes, in both packages: where does the plateau stop, and does
the model learn?

    JAX_PLATFORMS=cpu python3 scripts/torch_primal_batch_probe.py \
        [--rows 10000] [--batches 1024 256 64] [--skip-jax]

The data are mnist_like(n=rows + 2000, d=784, noise=30, label_noise=0.005,
seed=587) (phase 5's generator, cut in rows), rows [:rows] ingested in
four shards, scored on the 2,000 after them; C=10, gamma=0.00125,
rff_dim=2048, map_seed=0, primal_epochs=64, primal_tol=0.05. For each
batch size and package it prints the status, the epochs and steps, the
held-out accuracy, the share of held-out rows that are negative (the
accuracy of the majority-class predictor) and the ranking AUC of the
scores: a fit whose AUC is high while its accuracy equals the negative
share has a good direction and an unconverged bias. The port runs on the
CPU here (--device cuda on a card). The last line is one JSON object.
"""

import argparse
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _auc(scores, y):
    pos = y > 0
    ranks = np.argsort(np.argsort(scores))
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos - 1) / 2)
                 / (n_pos * n_neg))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10000)
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 256, 64])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--skip-jax", action="store_true")
    args = ap.parse_args()
    warnings.filterwarnings("ignore", "streaming primal fit ended")

    from tpusvm_torch import stream
    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data import mnist_like
    from tpusvm_torch.models import BinarySVC

    n = args.rows
    X, Y = mnist_like(n=n + 2000, d=784, noise=30.0, label_noise=0.005,
                      seed=587)
    Xt, Yt = X[n:], Y[n:]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        stream.ingest_arrays(tmp, X[:n], Y[:n], rows_per_shard=-(-n // 4))
        fits = {}
        for batch in args.batches:
            opts = dict(primal_batch=batch, primal_epochs=64,
                        primal_tol=0.05)
            cfg = dict(C=10.0, gamma=0.00125, kernel="rff", rff_dim=2048,
                       map_seed=0)
            fits[("port", batch)] = BinarySVC(
                SVMConfig(**cfg), solver_opts=opts,
                device=args.device).fit_stream(stream.open_dataset(tmp))
            if not args.skip_jax:
                import jax

                jax.config.update("jax_platforms", "cpu")
                from tpusvm import stream as jstream
                from tpusvm.config import SVMConfig as JConfig
                from tpusvm.models import BinarySVC as JSVC

                fits[("jax", batch)] = JSVC(
                    JConfig(**cfg), solver_opts=opts).fit_stream(
                        jstream.open_dataset(tmp))
        for (pkg, batch), m in fits.items():
            scores = np.asarray(m.decision_function(Xt))
            acc = float((np.asarray(m.predict(Xt)) == Yt).mean())
            row = dict(package=pkg, batch=batch, status=m.status_.name,
                       steps=int(m.n_iter_),
                       epochs=int(m.n_iter_) // -(-n // batch),
                       accuracy=acc, negative_share=float((Yt < 0).mean()),
                       auc=_auc(scores, Yt), b=float(m.b_))
            rows.append(row)
            print(f"{pkg:4s} batch {batch:5d}: {row['status']}, "
                  f"{row['epochs']} epochs, {row['steps']} steps, accuracy "
                  f"{acc:.4f} (negative share {row['negative_share']:.4f}), "
                  f"AUC {row['auc']:.4f}, b {row['b']:.6f}")
    print(json.dumps({"probe": "torch_primal_batch_probe", "rows": n,
                      "fits": rows}))


if __name__ == "__main__":
    main()
