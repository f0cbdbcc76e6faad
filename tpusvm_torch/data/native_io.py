"""The native CSV reader: native/csv_reader.cpp over ctypes.

The port of tpusvm/data/native_io.py, with read_csv_fast's signature and
contract: the reference's read_CSV semantics (header skipped, last column
= label, rows with fewer than 2 fields skipped, n_limit caps the rows,
binary mode maps label != positive_label -> -1), parsed by a
multi-threaded C++ parser behind a plain C interface. strtod and Python's
float both round correctly, so X and Y are the pure-Python reader's
(data/csv_reader.py:read_csv) bit for bit; that reader stays as the
reference the tests hold this one to.

The library is built at first use, with g++, from the checkout's
native/csv_reader.cpp into build/tpusvm_torch/ (a name that carries a hash
of the source and the flags, so an edited source is rebuilt). A file lock
serialises the build across processes: rank processes and pod workers may
start together on a fresh tree. Unlike the JAX package's bridge, nothing
falls back to the Python reader: a library that does not build raises
with the compiler's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpusvm_torch.utils.durable import fsync_replace

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "csv_reader.cpp"
BUILD_DIR = _ROOT / "build" / "tpusvm_torch"
# no -march=native: the library must load on whatever host built it
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")


class _CsvData(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("d", ctypes.c_int64),
        ("X", ctypes.POINTER(ctypes.c_double)),
        ("Y", ctypes.POINTER(ctypes.c_int32)),
        ("error", ctypes.c_int64),
    ]


_lock = threading.Lock()
_libs = {}


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the reader's library is (or will be) built."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native CSV reader's source {SOURCE} is "
                           "missing from this checkout")
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libtpusvm_io-{h.hexdigest()[:12]}.so"


def build_library(build_dir: Optional[Path] = None) -> Path:
    """Build the library into build_dir (default build/tpusvm_torch/) unless
    it is there; returns its path. Holds an exclusive file lock on
    build_dir/tpusvm_io.lock while it looks and builds, so concurrent
    processes build once. A failed build raises with g++'s output."""
    out = library_path(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    # tpusvm: durable-by=lock file opened only to hold flock; it carries no bytes
    with open(out.parent / "tpusvm_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the native CSV reader "
                               f"is built from {SOURCE} at first use")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed to build the native CSV reader from {SOURCE} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        fsync_replace(str(tmp), str(out))
    return out


def _load(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    key = str(build_dir or BUILD_DIR)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(build_dir)))
            lib.tpusvm_read_csv.restype = ctypes.POINTER(_CsvData)
            lib.tpusvm_read_csv.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int]
            lib.tpusvm_free_csv.restype = None
            lib.tpusvm_free_csv.argtypes = [ctypes.POINTER(_CsvData)]
            _libs[key] = lib
        return lib


def read_csv_fast(
    filename: str,
    n_limit: Optional[int] = None,
    binary_labels: bool = True,
    n_threads: int = 0,
    positive_label: int = 1,
    build_dir: Optional[Path] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """read_csv through the native multi-threaded parser.

    Same contract as data.read_csv (header skipped, last column = label,
    binary mode maps label != positive_label -> -1, rows with < 2 fields
    skipped, n_limit caps rows, a malformed field or a row whose field
    count differs from the header's raises ValueError); binary_labels=False
    keeps raw integer labels. n_threads=0 = one per hardware thread.
    Returns X float64 (n, d) and Y int32 (n,).

    The C interface knows only the reference's `1 vs rest` mapping, so a
    non-default positive_label reads raw labels and remaps them on the
    host: the Python reader's bytes, still one native parse. build_dir:
    where the library is built (default build/tpusvm_torch/).
    """
    lib = _load(build_dir)
    remap = binary_labels and positive_label != 1
    ptr = lib.tpusvm_read_csv(
        os.fsencode(filename), -1 if n_limit is None else int(n_limit),
        0 if remap else int(binary_labels), int(n_threads))
    if not ptr:
        raise OSError(f"native CSV reader failed to open {filename!r}")
    try:
        data = ptr.contents
        if int(data.error) == 2:
            raise MemoryError(f"{filename!r}: native CSV reader ran out of "
                              "memory")
        if int(data.error):
            raise ValueError(
                f"{filename!r}: malformed CSV (unparsable field or row whose "
                "field count differs from the header)")
        n, d = int(data.n), int(data.d)
        if n == 0:
            return (np.zeros((0, max(d, 0)), np.float64),
                    np.zeros((0,), np.int32))
        X = np.ctypeslib.as_array(data.X, shape=(n, d)).copy()
        Y = np.ctypeslib.as_array(data.Y, shape=(n,)).copy()
    finally:
        lib.tpusvm_free_csv(ptr)
    if remap:
        Y = np.where(Y == positive_label, 1, -1).astype(np.int32)
    return X, Y
