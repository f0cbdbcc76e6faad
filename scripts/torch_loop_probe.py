"""chip_smoke.py's phase 23 (the closed loop: the autopilot, the tenants,
their chaos gates) alone, with the model it deploys.

Draws chip_smoke.py's rows (mnist_like, seed 587, and the ten-class draw of
phase 8), fits phase 5's model (the artifact phase 23(a) deploys), then
runs phase 23: (a) the autopilot's two chained warm refreshes over an
append-grown dataset, swapped into an in-process server under client
load, the second killed and resumed; (b) the tenants' cold fleet
provision and their coalesced warm refresh twice, a control and a killed
and resumed arm, rolled out under client load; (c) the two chaos gates
as subprocesses beside them. Prints the card's name and power limit
first.

  python3 scripts/torch_loop_probe.py                  # the card, full width
  python3 scripts/torch_loop_probe.py --device cpu --rows 8000 --d 64 \\
      --tenants 8 --q 256                              # a CPU rehearsal
  python3 scripts/torch_loop_probe.py --only b --stacks-after 480
                          # 23(b) alone; the main thread's stack if it hangs
  python3 scripts/torch_loop_probe.py --memory-history
                          # each live device block's allocating stack
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _main_stack_after(secs: float) -> None:
    """Print the main thread's stack and exit after `secs` seconds (the
    server's many threads would crowd it out of faulthandler's dump)."""
    import os
    import threading
    import traceback

    main = threading.main_thread().ident

    def run():
        time.sleep(secs)
        frame = sys._current_frames().get(main)
        print(f"[probe] stopped after {secs:.0f} s; the main thread:\n"
              + "".join(traceback.format_stack(frame)), flush=True)
        os._exit(3)

    threading.Thread(target=run, daemon=True).start()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=70000,
                    help="rows drawn; the last 10,000 are held out (a "
                    "quarter below 70,000; default 70000, chip_smoke's)")
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--tenants", type=int, default=cs.N_TENANTS)
    ap.add_argument("--only", choices=("a", "b"), default=None,
                    help="run only 23(a) or 23(b), without the chaos gates")
    ap.add_argument("--stacks-after", type=float, default=None, metavar="S",
                    help="print the main thread's stack and exit after S "
                    "seconds (a hang's diagnosis)")
    ap.add_argument("--memory-history", action="store_true",
                    help="record the allocating Python stack of every live "
                    "device block (torch.cuda.memory._record_memory_history), "
                    "so a failed memory gate names where its blocks came from")
    ap.add_argument("--q", type=int, default=cs.FULL_OPTS["q"],
                    help="the working-set size of every fit (default "
                    "chip_smoke's 2048; max_inner is 2q)")
    args = ap.parse_args()

    import torch

    from tpusvm_torch.config import SVMConfig
    from tpusvm_torch.data.synthetic import (BENCH_NOISE_MULTICLASS,
                                             mnist_like,
                                             mnist_like_multiclass)
    from tpusvm_torch.models import BinarySVC
    from tpusvm_torch.ops.cuda import _build
    from tpusvm_torch.ops.cuda.fused_fupdate import (
        rbf_cross_matvec_batched_kernel, rbf_cross_matvec_kernel)
    from tpusvm_torch.ops.cuda.inner_smo import (inner_smo_batched_kernel,
                                                 inner_smo_kernel)

    if args.stacks_after:
        _main_stack_after(args.stacks_after)
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
    # the same proportions as the full width: a batch is 1/60 of the
    # training rows, the tenants' append half the held-out rows
    cs.N_LOOP_BATCH = n_tr // 60
    cs.N_APPEND = min(cs.N_APPEND, n_test // 2)
    opts = dict(q=args.q, wss=2, max_inner=2 * args.q)
    cs.FULL_OPTS.update(opts)
    cs.OVR_OPTS.update(opts)
    gamma = cs.GAMMA * 784 / args.d
    X_all, Y_all = mnist_like(n=args.rows, d=args.d, noise=30.0,
                              label_noise=0.005, seed=587)
    Xm, lm = mnist_like_multiclass(n=args.rows, d=args.d,
                                   noise=BENCH_NOISE_MULTICLASS)
    out = _build.BUILD_DIR / "loop_probe"
    out.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    m5 = BinarySVC(SVMConfig(C=cs.C, gamma=gamma, max_iter=10**6),
                   solver_opts=cs.FULL_OPTS, device=dev).fit(
                       X_all[:n_tr], Y_all[:n_tr])
    p5 = str(out / "m5.npz")
    m5.save(p5)
    cs.log(f"[probe] phase 5's fit in {time.perf_counter() - t:.1f} s: "
           f"{m5.n_support_} SVs")
    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel,
                "inner_smo_batched": inner_smo_batched_kernel,
                "fused_fupdate_batched": rbf_cross_matvec_batched_kernel}
    launches = {}
    if args.memory_history and dev == "cuda":
        torch.cuda.memory._record_memory_history(
            enabled="state", context="alloc", stacks="python")
    t = time.perf_counter()
    if args.only == "a":
        acc5h = float((m5.predict(X_all[n_tr + 5 * cs.N_LOOP_BATCH:])
                       == Y_all[n_tr + 5 * cs.N_LOOP_BATCH:]).mean())
        cs._loop_autopilot(X_all, Y_all, n_tr, acc5h, p5, dev, counters,
                           launches, smi, out)
    elif args.only == "b":
        cs._loop_tenants(Xm, lm, n_tr, gamma, args.tenants, dev, counters,
                         launches, smi, out)
    else:
        cs.phase_closed_loop(X_all, Y_all, n_tr, m5, p5, Xm, lm, gamma, dev,
                             counters, launches, smi, out,
                             n_tenants=args.tenants)
    cs.log(f"[probe] phase 23 in {time.perf_counter() - t:.1f} s; launches "
           f"{launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
