"""Build and bind the port's CUDA kernels.

Each source in tpusvm_torch/csrc/ is compiled by nvcc for sm_90a into a
shared library with a plain C interface, under build/tpusvm_torch/ at the
root of the checkout, and loaded with ctypes. Nothing is built when the
package is imported: the first call that needs a kernel builds it (or
`build_all` builds every source at once, one nvcc process per source, all
started together). The library name carries a hash of the source, the
shared headers and the flags, so an edited source is rebuilt and a stale
one is never loaded. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from tpusvm_torch.utils.durable import fsync_replace

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpusvm_torch"

# No link flags: the f-update's tensor maps are encoded through
# cuTensorMapEncodeTiled, which csrc/rbf_tile.cuh looks up at run time with
# cudaGetDriverEntryPointByVersion (cudart), so nothing links -lcuda.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per-source extra flags: the inner subproblems follow the reference's f32
# rounding step by step, and pair_rows keeps one order of operations per
# (row, query row), so no multiply-add contraction there
SOURCES = {
    "fused_fupdate": ("fused_fupdate.cu", ()),
    "fused_select": ("fused_select.cu", ()),
    "inner_smo": ("inner_smo.cu", ("-fmad=false",)),
    "inner_smo_multipair": ("inner_smo_multipair.cu", ("-fmad=false",)),
    "pair_rows": ("pair_rows.cu", ("-fmad=false",)),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from tpusvm_torch/csrc at first use"
        )
    return path


def _lib_path(name: str) -> Path:
    src, extra = SOURCES[name]
    h = hashlib.sha1((CSRC / src).read_bytes())
    # the shared headers too: an edited header rebuilds every source
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _staged(out: Path) -> Path:
    """The file nvcc writes: beside its library, so the commit is a rename
    within one directory."""
    return out.with_suffix(f".{os.getpid()}.tmp")


def _start(name: str):
    src, extra = SOURCES[name]
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o",
           str(_staged(_lib_path(name))), str(CSRC / src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named kernels (default: all) in parallel; returns the
    seconds each build took (0.0 when its library was already there).
    nvcc's resource report (registers, shared memory, spills) is kept in
    build/tpusvm_torch/<name>.log. Each library built is one compile
    record (obs/prof.py) whose compile_s is its nvcc seconds."""
    from tpusvm_torch.obs import prof

    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {n: _start(n) for n in names if not _lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    errors = []
    for n, proc in running.items():
        out = _lib_path(n)
        tmp = _staged(out)
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        # tpusvm: durable-by=diagnostic log rewritten by every build; nothing reads it back as state
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {SOURCES[n][0]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        fsync_replace(str(tmp), str(out))
        prof.record_compile(f"nvcc:{n}", 0.0, secs[n], kind="nvcc",
                            source=SOURCES[n][0])
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero code returned by a C entry point: a cudaError_t,
    or one of csrc/rbf_tile.cuh's tensor-map codes (negative)."""
    if rc == 0:
        return
    if rc == -1000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled not found through "
                           "cudaGetDriverEntryPointByVersion")
    if -3000 < rc <= -2000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused the "
                           f"layout (CUresult {-2000 - rc})")
    if rc == -4000:
        raise RuntimeError(f"{what}: the row count k must be in [1, 256]")
    if rc == -4002:
        raise RuntimeError(f"{what}: X and sn must start 16-byte aligned")
    if rc == -3000:
        raise RuntimeError(f"{what}: TMA operands need a row pitch that is a "
                           "multiple of 16 bytes and 16-byte aligned bases")
    raise RuntimeError(f"{what}: CUDA error {rc} at launch")
