"""The controls of a cell's check, at the cell's own size, judged by the
same comparison as the program's runs (reference/check.py): the
bfloat16 control's numbers are the upper readings the cell's limits are
set below, and a sound check reads it as not correct.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --control bf16

--control bf16: the plain reference put in the program's place, its
float32 features in bfloat16: one step below what the configuration
states (float32 at TF32 grade; reference/svm.py). It loads nothing of
the program and judges the lanes the check re-solves (drawn from the
seed). Two readings beside it, of what that stated precision admits:
--control tf32, the reference with TF32 operands in its products (TF32
off otherwise), and --control accum32, the program's own path with
float32 alpha and f, the cell's unit of work once with accum_dtype
float32.

One line of JSON a seed on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.core import registry  # noqa: E402
from perfbench.core.generate import make_data  # noqa: E402
from perfbench.reference import check  # noqa: E402


def control_answers(cfg, traffic, data, entry, prob, seed, lanes=None,
                    precision="bf16"):
    """The reference's answers, in `precision`, for the lanes the check
    re-solves."""
    specs = entry.lane_specs(cfg, traffic, data)
    k = int(traffic.get("check", {}).get("reference_lanes", 1))
    names = lanes or check.reference_lanes([s[0] for s in sorted(specs)],
                                           k, seed)
    out = []
    for lane, C, gamma, labels in specs:
        if lane not in names:
            continue
        y = check.labels_of(data, labels)
        ctl = check.solve_lane(cfg, prob, y, C, gamma, precision=precision)
        out.append({"lane": lane, "C": C, "gamma": gamma, "labels": labels,
                    "alpha": ctl["alpha"], "b": ctl["b"],
                    "status": ctl["status"]})
    return out


def program_answers(cfg, traffic, data, entry, device):
    """The program's answers from one unit of work with float32
    accumulators."""
    from perfbench.core.spans import Spans

    low = json.loads(json.dumps(cfg))
    low["svm"]["accum_dtype"] = "float32"
    if device == "cuda":
        from tpusvm_torch.ops.cuda import _build

        _build.build_all(entry.LIBRARIES)
    state = entry.setup(low, traffic, data, device)
    record = entry.unit(state, Spans(enabled=False))
    return entry.answers(low, traffic, data, record)


def main(argv=None, device=None, search=(), bench=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", choices=("bf16", "tf32", "accum32"),
                   default="bf16")
    args = p.parse_args(argv)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("the control runs on the card", file=sys.stderr)
            return 2
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = bench or registry.benchmark()
    w = registry.cell(bench, args.workload)
    cfg = registry.load_json("configs", w["config"], search)
    traffic = registry.load_json("traffic", w["traffic"], search)
    limits = registry.load_json("limits", w["name"], search)
    entry = registry.load_module("entries", traffic["entry"], search)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        data = make_data(cfg, seed)
        data["seed"] = seed
        prob = check.problem(cfg, data, device)
        if args.control != "accum32":
            answers = control_answers(cfg, traffic, data, entry, prob, seed,
                                      precision=args.control)
        else:
            answers = program_answers(cfg, traffic, data, entry, device)
        numbers = check.compare(cfg, traffic, data, [answers], seed, device,
                                prob=prob,
                                log=lambda m: print(m, file=sys.stderr))
        numbers.pop("lanes")
        fails = sorted(k for k in limits if numbers[k] > limits[k])
        print(json.dumps({"workload": w["name"], "seed": seed,
                          "control": args.control,
                          "numbers": numbers, "fails": fails,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
