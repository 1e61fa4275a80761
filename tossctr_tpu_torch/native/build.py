"""Build and bind the threaded row gather (``fastgather.cpp``).

Port of ``tossctr_tpu/native/build.py``, built from this package's own
copy of the source.  ``g++ -O3 -shared -fPIC -std=c++17 ... -lpthread``
runs at first use, never at import, into ``build/native/`` at the root
of the checkout (git-ignored); the library's file name carries a hash
of the source and the flags, so an edited source is rebuilt, and
nothing is written next to the source.  A failed build or load raises:
the loader does not quietly take the NumPy gather instead
(``TOSSCTR_NATIVE_GATHER=0`` asks for NumPy, ``data/dataset.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "fastgather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# calls of gather_rows_multi in this process (reset_gather_counts)
_counts = {"gather_rows_multi": 0}


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastgather-{h.hexdigest()[:12]}.so"


def load_fastgather() -> ctypes.CDLL:
    """The loaded library, built first if its file is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SRC.name} failed (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.gather_rows_multi.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ]
        lib.gather_rows_multi.restype = None
        _lib = lib
        return lib


def gather_rows_multi(srcs: Sequence[np.ndarray], idx: np.ndarray, n_threads: int = 8):
    """[src[idx] for src in srcs], each row copied by the native threads:
    the same bytes as NumPy's ``src[idx]``.  Each ``src`` is read as
    C-contiguous rows (an mmap'd .npy is; another is copied first)."""
    lib = load_fastgather()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = idx.shape[0]
    k = len(srcs)
    outs = [np.empty((n,) + s.shape[1:], dtype=s.dtype) for s in srcs]
    src_ptrs = (ctypes.c_void_p * k)()
    dst_ptrs = (ctypes.c_void_p * k)()
    row_bytes = (ctypes.c_int64 * k)()
    keep = []
    for a, (src, out) in enumerate(zip(srcs, outs)):
        if not src.flags.c_contiguous:
            src = np.ascontiguousarray(src)
        keep.append(src)
        src_ptrs[a] = src.ctypes.data
        dst_ptrs[a] = out.ctypes.data
        row_bytes[a] = src.itemsize * int(np.prod(src.shape[1:]))
        if n and (idx.min() < 0 or idx.max() >= src.shape[0]):
            raise IndexError(f"row index out of range for {src.shape[0]} rows")
    if n and k:
        lib.gather_rows_multi(src_ptrs, dst_ptrs, row_bytes, ctypes.c_int(k),
                              idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              ctypes.c_int64(n), ctypes.c_int(n_threads))
    _counts["gather_rows_multi"] += 1
    return outs


def gather_counts() -> Dict[str, int]:
    return dict(_counts)


def reset_gather_counts() -> None:
    _counts["gather_rows_multi"] = 0
