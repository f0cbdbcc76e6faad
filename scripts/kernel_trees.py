"""Another checkout's CUDA kernels, for comparing them with this one's.

`load_tree(tree, names)` builds the named kernel libraries of `tree` (such
as a parent commit unpacked with `git archive` under build/) with that
tree's own _build.py and nvcc flags, into that tree's own build/ directory.
`pair_rows_of(tree)` returns that tree's pair_rows as a callable with the
signature of `tpusvm_torch.ops.cuda.pair_rows.pair_rows_kernel` and the
same checks on the host (so CUDA-event timings of the two carry the same
host work); its launches are not counted by this checkout's wrapper. Used by
scripts/torch_pair_bench.py, scripts/torch_inner_bench.py and the
parent-bits card test in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
from pathlib import Path
from typing import Dict, Iterable

_P = ctypes.c_void_p


def load_tree(tree, names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """The named kernel libraries of the checkout `tree`, built in parallel."""
    path = Path(tree).resolve() / "tpusvm_torch" / "ops" / "cuda" / "_build.py"
    spec = importlib.util.spec_from_file_location(
        f"_build_of_{hashlib.sha1(str(path).encode()).hexdigest()[:12]}", path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    names = list(names)
    build.build_all(names)
    return {n: build.load(n) for n in names}


def pair_rows_of(tree):
    """The pair_rows kernel of `tree`, on CUDA tensors."""
    import torch

    from tpusvm_torch.ops.cuda.pair_rows import _operands

    fn = load_tree(tree, ["pair_rows"])["pair_rows"].tpusvm_pair_rows
    fn.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P,
                   _P, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, _P]
    fn.restype = ctypes.c_int

    def run(X, idx, need, rows, *, family="rbf", gamma=0.00125, coef0=0.0,
            degree=3, sn=None):
        rc = fn(*_operands(X, idx, need, rows, family=family, gamma=gamma,
                           coef0=coef0, degree=degree, sn=sn),
                torch.cuda.current_stream(X.device).cuda_stream)
        if rc:
            raise RuntimeError(f"pair_rows of {tree}: error {rc}")
        return rows

    return run
