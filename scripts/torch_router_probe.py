"""chip_smoke.py's phase 24 (the router over serve replica processes, with
its chaos gate) alone, with the model its replicas host.

Draws chip_smoke.py's rows (mnist_like, seed 587), fits phase 5's model
(the artifact every replica hosts), then runs phase 24: (a) the router's hop and the kill and
revive of the placed replica under 8 one-row clients, (b) generation 2 by
a warm refresh, rolled out staggered under that load, (c) the replicas'
serve.request spans against the router's router.forward spans, (d)
fleet-metrics and top over the router, (e) the chaos gate. Prints the
card's name and power limit first.

  python3 scripts/torch_router_probe.py               # the card, full width
  python3 scripts/torch_router_probe.py --device cpu --rows 4000 --d 64 \\
      --q 256                                         # a CPU rehearsal
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=70000,
                    help="rows drawn; the last 10,000 are held out (a "
                    "quarter below 70,000; default 70000, chip_smoke's)")
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--q", type=int, default=cs.FULL_OPTS["q"],
                    help="the working-set size of the fits (default "
                    "chip_smoke's 2048; max_inner is 2q)")
    args = ap.parse_args()

    import torch

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.ops.cuda.fused_fupdate import rbf_cross_matvec_kernel
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel

    dev = args.device
    smi = "cpu"
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        t = time.perf_counter()
        _build.build_all()
        cs.log(f"built the kernels in {time.perf_counter() - t:.1f} s")
    else:
        torch.set_num_threads(4)
    cs.log(f"[probe] {smi}")
    out = _build.BUILD_DIR / "router_probe"
    out.mkdir(parents=True, exist_ok=True)
    n_test = 10000 if args.rows >= 70000 else args.rows // 4
    n_tr = args.rows - n_test
    cs.N_ROUTER_APPEND = min(cs.N_ROUTER_APPEND, n_test // 2)
    cs.N_ROUTER_HOP = min(cs.N_ROUTER_HOP, n_test // 2)
    cs.FULL_OPTS.update(q=args.q, wss=2, max_inner=2 * args.q)
    gamma = cs.GAMMA * 784 / args.d
    X_all, Y_all = mnist_like(n=args.rows, d=args.d, noise=30.0,
                              label_noise=0.005, seed=587)
    t = time.perf_counter()
    m5 = BinarySVC(SVMConfig(C=cs.C, gamma=gamma, max_iter=10**6),
                   solver_opts=cs.FULL_OPTS, device=dev).fit(
                       X_all[:n_tr], Y_all[:n_tr])
    p5 = str(out / "m5.npz")
    m5.save(p5)
    cs.log(f"[probe] phase 5's fit in {time.perf_counter() - t:.1f} s: "
           f"{m5.n_support_} SVs")
    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel}
    launches = {}
    t = time.perf_counter()
    cs.phase_router(X_all, Y_all, n_tr, p5, dev, counters, launches, smi,
                    out)
    cs.log(f"[probe] phase 24 in {time.perf_counter() - t:.1f} s; launches "
           f"{launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
