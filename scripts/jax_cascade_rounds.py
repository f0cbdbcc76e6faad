#!/usr/bin/env python3
"""The JAX package's cascade on the CPU at chip_smoke.py phase 14's
configuration, to set the port's round counts beside the reference's.

    python3 scripts/jax_cascade_rounds.py [--rows 60000]

Runs `tpusvm.parallel.cascade_fit` (the reference package, not the port)
on a simulated 8-device CPU mesh, as tests/conftest.py sets it up, on
phase 5's data: mnist_like(n=70000, d=784, noise=30, label_noise=0.005,
seed=587), min-max scaled on the training rows [:rows], float32 features
with f64 accumulators, C=10, gamma=0.00125, max_rounds 50: chip_smoke.py
14(a)'s tree, P=4, sv_capacity 4,096, blocked leaves with phase 5's
options (q=2048, wss=2, max_inner=4096). Each round's line is the
package's own verbose line; the last line is one JSON object: rounds,
whether the ID-set test ended the fit, the global SV count of each round,
b, held-out accuracy on [60000:], and the seconds taken.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=60000)
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from tpusvm.config import CascadeConfig, SVMConfig
    from tpusvm.data import MinMaxScaler
    from tpusvm.data.synthetic import mnist_like
    from tpusvm.parallel import cascade_fit
    from tpusvm.solver import predict

    X, Y = mnist_like(n=70000, d=784, noise=30.0, label_noise=0.005,
                      seed=587)
    sc = MinMaxScaler().fit(X[:a.rows])
    Xtr = sc.transform(X[:a.rows]).astype(np.float32)
    Xt = sc.transform(X[60000:]).astype(np.float32)
    opts = dict(q=2048, wss=2, max_inner=4096)
    cfg = SVMConfig(C=10.0, gamma=0.00125, max_iter=10**6, max_rounds=50)
    t = time.perf_counter()
    r = cascade_fit(Xtr, Y[:a.rows], cfg,
                    CascadeConfig(n_shards=4, sv_capacity=4096,
                                  topology="tree"),
                    dtype=jnp.float32, verbose=True, solver="blocked",
                    solver_opts=opts)
    secs = time.perf_counter() - t
    pred = np.asarray(predict(jnp.asarray(Xt), jnp.asarray(r.sv_X),
                              jnp.asarray(r.sv_Y), jnp.asarray(r.sv_alpha),
                              r.b, gamma=cfg.gamma))
    acc = float((pred == Y[60000:]).mean())
    print(json.dumps(dict(
        rows=a.rows, rounds=r.rounds, converged=bool(r.converged),
        global_svs=[int(h["sv_count"]) for h in r.history], b=float(r.b),
        accuracy=acc, seconds=secs, jax=jax.__version__)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
