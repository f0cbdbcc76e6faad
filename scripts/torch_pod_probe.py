"""chip_smoke.py's phase 19 (the pod) alone, with what it compares against.

Draws chip_smoke.py's rows (mnist_like, seed 587), ingests the training
rows at 16,384 rows a shard (phase 17(a)), fits 17(d)'s in-process
fit_cascade_stream (14(b)'s star, P=4, blocked leaves), then runs phase 19:
(a) fit_pod against it bit for bit with the kernel launches read from the
workers, (b) the worker-kill arm, (c) the three subprocess smokes. Prints
the card's name and power limit first.

  python3 scripts/torch_pod_probe.py                  # the card, full width
  python3 scripts/torch_pod_probe.py --device cpu --rows 2000 --d 32
                                                      # a CPU rehearsal
  python3 scripts/torch_pod_probe.py --startup        # only where a worker
                                                      # process's start goes

--startup times, in fresh processes, what a pod worker pays before its
first request: the interpreter with torch imported; plus a CUDA context;
plus the worker module and its kernel wrappers; the last alone and four
at once (a pod's spawn).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


STARTUP_STEPS = (
    ("python + import torch", "import torch"),
    ("+ CUDA context", "import torch; torch.zeros(1, device='cuda')"),
    ("+ pod worker module", "import torch; torch.zeros(1, device='cuda'); "
     "import tpusvm_torch.pod.worker as w; w.kernel_wrappers()"),
)


def startup(device: str) -> None:
    """Wall seconds of each STARTUP_STEPS stage in a fresh process, and of
    the last stage in four processes started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    steps = [(name, code.replace("'cuda'", repr(device)))
             for name, code in STARTUP_STEPS]

    def run(code, k):
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env)
                 for _ in range(k)]
        rcs = [p.wait() for p in procs]
        cs.check(rcs == [0] * k, f"startup probe exit codes {rcs}")
        return time.perf_counter() - t

    secs = {name: round(run(code, 1), 3) for name, code in steps}
    secs["the same x4 at once"] = round(run(steps[-1][1], 4), 3)
    cs.log(f"[startup] seconds in fresh processes: {cs.json.dumps(secs)}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", type=int, default=60000,
                    help="training rows (chip_smoke.py: 60000)")
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--startup", action="store_true",
                    help="only time a worker process's start")
    args = ap.parse_args()

    import torch

    from tpusvm_torch.config import CascadeConfig
    from tpusvm_torch.data.synthetic import mnist_like
    from tpusvm_torch.ops.cuda.fused_fupdate import rbf_cross_matvec_kernel
    from tpusvm_torch.ops.cuda.inner_smo import inner_smo_kernel
    from tpusvm_torch.stream import ingest_arrays, open_dataset

    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        from tpusvm_torch.ops.cuda import _build

        cs.log(f"built {cs.json.dumps(_build.build_all())} s")
    else:
        smi = "cpu"
    cs.log(f"torch {torch.__version__}; {smi}")
    if args.startup:
        startup(args.device)
        return 0
    # chip_smoke.py's gamma is d-scaled only by its own data (d = 784)
    cs.GAMMA = 0.00125 * 784 / args.d
    # chip_smoke.py's draw: 10,000 held-out rows after the training rows
    X, Y = mnist_like(n=args.rows + 10000, d=args.d, noise=30.0,
                      label_noise=0.005, seed=587)
    X, Y = X[:args.rows], Y[:args.rows]
    out = tempfile.mkdtemp(dir=ROOT / "build") if (ROOT / "build").is_dir() \
        else tempfile.mkdtemp()
    t = time.perf_counter()
    ingest_arrays(os.path.join(out, "train"), X, Y,
                  rows_per_shard=cs.STREAM_ROWS_PER_SHARD)
    ds = open_dataset(os.path.join(out, "train"))
    cs.log(f"[17a] ingested {ds.n_rows} rows into {ds.n_shards} shards in "
           f"{time.perf_counter() - t:.2f} s")
    cc = CascadeConfig(n_shards=cs.CASCADE_P, sv_capacity=cs.CASCADE_SV_CAP,
                       topology="star")
    cs.sync(args.device)
    t = time.perf_counter()
    m17d = cs._cascade_model("blocked", args.device).fit_cascade_stream(ds, cc)
    cs.sync(args.device)
    cs.log(f"[17d] fit_cascade_stream: {time.perf_counter() - t:.3f} s, "
           f"{m17d.cascade_rounds_} rounds, SV count {m17d.n_support_}, b "
           f"{m17d.b_:.15f}")
    counters = {"fused_fupdate": rbf_cross_matvec_kernel,
                "inner_smo": inner_smo_kernel}
    launches = {}
    t = time.perf_counter()
    cs.phase_pod(ds, m17d, args.device, counters, launches, smi)
    cs.log(f"[19] {time.perf_counter() - t:.1f} s; launches "
           f"{cs.json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
