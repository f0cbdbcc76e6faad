"""chip_smoke.py's phase 22 (serving and refresh) alone, with the models it
serves.

Draws chip_smoke.py's rows (mnist_like, seed 587, and the ten-class draw of
phase 8), fits phase 5's model (saved as the artifact phase 22 serves),
phase 11's (refine), 8(a)'s ten blocked heads and 18(a)'s rff model, then
runs phase 22: (a) in-process serving of three models with the card's
bit checks, (b) `serve --port 0` as a subprocess over HTTP, (c) eight
hot-swaps under load with the device memory after each, (d) the refresh
warm and cold and `refresh --swap URL`, (e) the three smokes beside (d).
Prints the card's name and power limit first.

  python3 scripts/torch_serve_probe.py                 # the card, full width
  python3 scripts/torch_serve_probe.py --device cpu --rows 2200 --d 64
                                                       # a CPU rehearsal
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
    args = ap.parse_args()

    import torch

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.synthetic import (BENCH_NOISE_MULTICLASS,
                                             mnist_like,
                                             mnist_like_multiclass)
    from tpusvm_torch.models import BinarySVC, OneVsRestSVC
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
    n_test = 10000 if args.rows >= 70000 else args.rows // 4
    n_tr = args.rows - n_test
    cs.N_APPEND = min(cs.N_APPEND, n_test // 2)
    cs.N_HTTP = min(cs.N_HTTP, n_test // 2)
    gamma = cs.GAMMA * 784 / args.d
    X_all, Y_all = mnist_like(n=args.rows, d=args.d, noise=30.0,
                              label_noise=0.005, seed=587)
    Xm, lm = mnist_like_multiclass(n=args.rows, d=args.d,
                                   noise=BENCH_NOISE_MULTICLASS)
    out = _build.BUILD_DIR / "serve_probe"
    out.mkdir(parents=True, exist_ok=True)
    cfg = SVMConfig(C=cs.C, gamma=gamma, max_iter=10**6)
    t = time.perf_counter()
    m5 = BinarySVC(cfg, solver_opts=cs.FULL_OPTS, device=dev).fit(
        X_all[:n_tr], Y_all[:n_tr])
    p5 = str(out / "m5.npz")
    m5.save(p5)
    acc5 = float((m5.predict(X_all[n_tr:]) == Y_all[n_tr:]).mean())
    m11 = BinarySVC(cfg, solver_opts=dict(cs.FULL_OPTS, refine=4096,
                                          max_refines=2),
                    device=dev).fit(X_all[:n_tr], Y_all[:n_tr])
    ovr = OneVsRestSVC(cfg, solver="blocked", solver_opts=cs.OVR_OPTS,
                       device=dev).fit(Xm[:n_tr], lm[:n_tr])
    rff = BinarySVC(SVMConfig(C=cs.C, gamma=gamma, max_iter=10**6,
                              kernel="rff", rff_dim=cs.APPROX_RFF_DIM,
                              map_seed=0),
                    solver_opts=cs.FULL_OPTS, device=dev).fit(
                        X_all[:n_tr], Y_all[:n_tr])
    cs.log(f"[probe] fits in {time.perf_counter() - t:.1f} s: phase 5 "
           f"{m5.n_support_} SVs, accuracy {acc5:.4f}; phase 11 "
           f"{m11.n_support_} SVs; 8(a) SV union {len(ovr.X_sv_)}; rff "
           f"{rff.n_support_} SVs")
    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel}
    launches = {}
    t = time.perf_counter()
    cs.phase_serve(X_all, Y_all, n_tr, m5, p5, m11, ovr, Xm, rff, dev,
                   counters, launches, smi, out)
    cs.log(f"[probe] phase 22 in {time.perf_counter() - t:.1f} s; launches "
           f"{launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
