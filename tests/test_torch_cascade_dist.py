"""The cascade's process-group engine: gloo ranks spawned on the CPU.

Band: bit for bit inside the port. Worlds 2 (tree and star) and 4 (tree),
pair leaves in f64, equal the one-process engine on the same data: SV IDs,
alpha bits, b, rounds and every history entry (SV IDs, b, iterations,
statuses), on every rank. A resume where one rank lacks the checkpoint
raises on every rank, and a world size other than n_shards raises. The
command line's --distributed ranks print and save what the one-process
command prints and saves, bit for bit.

Every rank is a subprocess joined with its own deadline (DEADLINE_S); on
expiry all are killed and the test fails, so a deadlocked collective
cannot stall the suite. The ranks need free local ports.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 120.0

# one rank: joins the group, fits, and writes its result (and, on rank 0
# with "compare", the one-process engine's result) or its traceback
_WORKER = r"""
import json, sys, traceback
import numpy as np
import torch
torch.set_num_threads(1)
spec, rank = json.loads(sys.argv[1]), int(sys.argv[2])
out = f"{spec['out']}.{rank}"
try:
    import torch.distributed as dist
    from tpusvm_torch.config import CascadeConfig, SVMConfig
    from tpusvm_torch.data import MinMaxScaler, rings
    from tpusvm_torch.parallel import cascade_fit, init_group

    group = init_group(spec["addr"], spec["world"], rank, timeout_s=60)
    X, Y = rings(n=320, seed=13)
    Xs = MinMaxScaler().fit_transform(X)
    cfg = SVMConfig(C=10.0, gamma=10.0)
    cc = CascadeConfig(n_shards=spec["shards"], sv_capacity=256,
                       topology=spec["topology"])
    kw = dict(dtype=torch.float64, device="cpu")

    def save(path, res):
        h = {}
        for i, e in enumerate(res.history):
            for k in ("sv_ids", "iters", "status", "b"):
                h[f"h{i}_{k}"] = np.asarray(e[k])
        np.savez(path, sv_ids=res.sv_ids, sv_alpha=res.sv_alpha,
                 sv_X=res.sv_X, b=res.b, rounds=res.rounds,
                 converged=res.converged, n_hist=len(res.history), **h)

    ckpt = spec.get("ckpt", {}).get(str(rank))
    res = cascade_fit(Xs, Y, cfg, cc, group=group, checkpoint_path=ckpt,
                      resume=ckpt is not None, **kw)
    save(out + ".npz", res)
    dist.destroy_process_group()
    if rank == 0 and spec.get("compare"):
        save(out + ".ref.npz", cascade_fit(Xs, Y, cfg, cc, **kw))
except BaseException:
    with open(out + ".err", "w") as f:
        f.write(traceback.format_exc())
    sys.exit(1)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _popen(argv, cwd, name):
    """A process whose stdout and stderr go to cwd/name.out and .err (files,
    so no pipe can fill and block it)."""
    with open(cwd / f"{name}.out", "w") as out, \
            open(cwd / f"{name}.err", "w") as err:
        return subprocess.Popen(argv, cwd=cwd, env=_env(), stdout=out,
                                stderr=err, text=True)


def _join(procs, deadline_s=DEADLINE_S):
    """Wait for every process until the deadline; kill all and fail on
    expiry. Returns the exit codes."""
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"ranks did not finish within {deadline_s} s (killed)")
    return [p.returncode for p in procs]


def _ranks(tmp_path, world, shards, topology, **spec):
    out = str(tmp_path / "rank")
    spec = dict(addr=f"127.0.0.1:{_free_port()}", world=world, shards=shards,
                topology=topology, out=out, **spec)
    procs = [_popen([sys.executable, "-c", _WORKER, json.dumps(spec), str(r)],
                    tmp_path, f"rank{r}") for r in range(world)]
    rcs = _join(procs)
    errs = {}
    for r in range(world):
        err = Path(f"{out}.{r}.err")
        if err.exists():
            errs[r] = err.read_text()
    return out, rcs, errs


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) if a.dtype.kind == "f" else a


def _equal(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
        assert bool(a["converged"])
        return int(a["rounds"])


@pytest.mark.parametrize("world,topology", [(2, "tree"), (2, "star"),
                                            (4, "tree")])
def test_group_engine_equals_one_process_engine(tmp_path, world, topology):
    out, rcs, errs = _ranks(tmp_path, world, world, topology, compare=True)
    assert rcs == [0] * world, errs
    rounds = _equal(f"{out}.0.npz", f"{out}.0.ref.npz")
    assert rounds >= 2
    # every rank holds rank 0's model and the same history
    for r in range(1, world):
        _equal(f"{out}.{r}.npz", f"{out}.0.npz")


def test_resume_with_a_rank_lacking_the_checkpoint_raises_everywhere(tmp_path):
    import torch

    from tpusvm_torch.parallel import cascade as tc
    from tpusvm_torch.parallel import svbuffer as tsb

    path = str(tmp_path / "c.npz")
    tc.save_round_state(path, tsb.empty(256, 2, torch.float64), {1, 2}, 1,
                        0.5, n_shards=2, topology="tree")
    _, rcs, errs = _ranks(tmp_path, 2, 2, "tree",
                          ckpt={"0": path, "1": str(tmp_path / "gone.npz")})
    assert rcs == [1, 1]
    for r in (0, 1):
        assert "missing on processes [1]" in errs[r], errs[r]


def test_world_size_other_than_n_shards_raises(tmp_path):
    _, rcs, errs = _ranks(tmp_path, 2, 4, "tree")
    assert rcs == [1, 1]
    for r in (0, 1):
        assert "the process group has 2 ranks but cascade_config.n_shards " \
               "is 4" in errs[r], errs[r]


def test_cli_ranks_match_the_one_process_command(tmp_path):
    from tpusvm_torch.data import rings, write_csv

    X, Y = rings(n=420, seed=13)
    write_csv(str(tmp_path / "a.csv"), X[:320], Y[:320])
    write_csv(str(tmp_path / "b.csv"), X[320:], Y[320:])
    flags = ["train", "--train", "a.csv", "--test", "b.csv", "--C", "10",
             "--gamma", "10", "--mode", "cascade", "--shards", "2",
             "--topology", "star", "--sv-capacity", "256", "--solver", "pair",
             "--device", "cpu"]
    cmd = [sys.executable, "-m", "tpusvm_torch", *flags]
    addr = f"127.0.0.1:{_free_port()}"
    procs = [_popen(cmd + ["--save", f"m{r}.npz", "--distributed",
                           "--coordinator-address", addr, "--num-processes",
                           "2", "--process-id", str(r)], tmp_path, f"cli{r}")
             for r in range(2)] + [_popen(cmd + ["--save", "one.npz"],
                                          tmp_path, "one")]
    rcs = _join(procs)
    outs = [(tmp_path / f"{n}.out").read_text() for n in ("cli0", "cli1", "one")]
    errs = [(tmp_path / f"{n}.err").read_text() for n in ("cli0", "cli1", "one")]
    assert rcs == [0, 0, 0], (outs, errs)
    one = outs[2]

    def lines(text):
        keep = r"^(=== Round \d+ === SV count = \d+, b = \S+,|cascade:|" \
               r"iterations|b =|SV count|status|accuracy)"
        return [re.sub(r", [\d.]+s$", "", ln) for ln in text.splitlines()
                if re.match(keep, ln)]

    assert lines(outs[0]) == lines(one)
    assert "converged = True" in outs[0]
    # rank 1 prints nothing and writes no artifact
    assert outs[1].strip() == ""
    assert not (tmp_path / "m1.npz").exists()
    with np.load(tmp_path / "m0.npz") as a, np.load(tmp_path / "one.npz") as b:
        for k in ("sv_ids", "sv_alpha", "b", "cascade_rounds"):
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def test_cli_geometry_without_distributed_is_refused():
    from tpusvm_torch.cli import main

    for extra in (["--num-processes", "2"], ["--process-id", "0"],
                  ["--coordinator-address", "127.0.0.1:1"]):
        with pytest.raises(SystemExit, match="require --distributed"):
            main(["train", "--synthetic", "rings", "--mode", "cascade",
                  "--device", "cpu", *extra])
    with pytest.raises(SystemExit, match="needs --mode cascade"):
        main(["train", "--synthetic", "rings", "--device", "cpu",
              "--distributed", "--coordinator-address", "127.0.0.1:1",
              "--num-processes", "2", "--process-id", "0"])
    with pytest.raises(SystemExit, match="needs --coordinator-address"):
        main(["train", "--synthetic", "rings", "--mode", "cascade",
              "--device", "cpu", "--distributed"])
