"""The benchmark of tpusvm_torch on one cell: see perfbench/core/runner.py.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, CHECKOUT)
# every build and kernel cache at a fixed path inside the checkout (the
# port's nvcc libraries are built under build/tpusvm_torch by the port)
_CACHE = os.path.join(CHECKOUT, "build", "perfbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["USE_FLAX"] = "0"

from perfbench.core.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
