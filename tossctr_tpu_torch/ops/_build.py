"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes).  Builds run at
first use, never at import, into ``build/kernels/`` at the root of the
checkout; a library's file name carries a hash of its sources and flags,
so an edited source is rebuilt.  A failed build raises: there is no
fallback to the plain PyTorch versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("fused_mha_qkv", "fused_block_tail", "fused_mha_qkv_bwd", "fused_block_tail_bwd",
           "fm_cross", "fm_cross_bwd", "fused_mha", "fused_mha_bwd", "fused_ffn", "fused_ffn_bwd",
           "sweep_rows_add", "table_sweep", "dropout_dump")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the C entry points' dtype argument: the storage type T of the kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# dropout arguments of every entry point: keep threshold, keep scale, seed
_DROP = [_U, _F, _U]
# each library's C entry point and its argument types: pointers and the
# stream as c_void_p (ctypes would otherwise pass them as 32-bit ints),
# sizes as c_int; each returns a cudaError_t code.  The persistent
# kernels take the most blocks their grid may have (the attention
# forwards: 0 for as many as fit on the SMs, then whether to run the
# warp-unit kernel)
SIGNATURES = {
    "fused_mha_qkv": ("tossctr_fused_mha_qkv_fwd",
                      [_P] * 5 + [_I] * 4 + [_F] + _DROP + [_I] * 4 + [_P]),
    "fused_block_tail": ("tossctr_fused_block_tail_fwd",
                         [_P] * 11 + [_I] * 3 + _DROP + [_I, _I, _P]),
    "fused_mha_qkv_bwd": ("tossctr_fused_mha_qkv_bwd",
                          [_P] * 8 + [_I] * 5 + [_F] + _DROP + [_I, _I, _I, _P]),
    "fused_block_tail_bwd": ("tossctr_fused_block_tail_bwd",
                             [_P] * 15 + [_I] * 4 + _DROP + [_I, _I, _P]),
    # the FM pair: blocks (forward) and whether to run the tensor-core kernel
    "fm_cross": ("tossctr_fm_cross_fwd", [_P] * 4 + [_I] * 6 + [_I, _I] + [_I, _I, _P]),
    "fm_cross_bwd": ("tossctr_fm_cross_bwd", [_P] * 9 + [_I] * 8 + [_I] + [_I, _I, _P]),
    "fused_mha": ("tossctr_fused_mha_fwd", [_P] * 5 + [_I] * 4 + [_F] + _DROP + [_I] * 4 + [_P]),
    "fused_mha_bwd": ("tossctr_fused_mha_bwd",
                      [_P] * 10 + [_I] * 5 + [_F] + _DROP + [_I, _I, _P]),
    "fused_ffn": ("tossctr_fused_ffn_fwd", [_P] * 6 + [_I] * 3 + _DROP + [_I, _I, _P]),
    "fused_ffn_bwd": ("tossctr_fused_ffn_bwd", [_P] * 8 + [_I] * 4 + _DROP + [_I, _I, _P]),
    # the tables and the deltas as host arrays of device pointers
    "sweep_rows_add": ("tossctr_sweep_rows_add", [_P, _P, _I] + [_P] * 5 + [_I] * 6 + [_P]),
    # a NULL block list sweeps every block
    "table_sweep": ("tossctr_table_sweep", [_P, _L, _I, _F, _P, _I, _I, _P]),
    "dropout_dump": ("tossctr_dropout_dump", [_P] + [_I] * 4 + _DROP + [_I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  -> {name: library path}.  ptxas's register and spill
    report for each build lands beside the library as ``<name>.ptxas.txt``."""
    names = list(names)
    for n in names:
        if n not in KERNELS:
            raise ValueError(f"unknown kernel {n!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    errors = []
    for n, tmp, proc in procs:
        out, err = proc.communicate()
        (BUILD_DIR / f"{n}.ptxas.txt").write_text(out + err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use and cached per process,
    with its entry point's argument types declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.tossctr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tossctr_cuda_error_string.restype = ctypes.c_char_p
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def build_variant(name: str, subs, tag: str, source: Optional[Path] = None):
    """``name``'s library built from a copy of the sources with ``subs``
    applied ([(file, text, replacement)]: the first match of each text is
    replaced, a text not found raises), under ``build/kernels/<tag>/``: a
    probe times a kernel with a part changed or taken out against the
    kernel as built; ptxas's report lands beside it as
    ``<name>.ptxas.txt``.  ``source``, where given, takes the place of
    ``<name>.cu`` in the copy (another design with the same entry point)
    before the subs.  -> its C entry point, with the argument types
    declared."""
    d = BUILD_DIR / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    if source is not None:
        shutil.copyfile(source, d / f"{name}.cu")
    for f, old, new in subs:
        src = (d / f).read_text()
        if old not in src:
            raise RuntimeError(f"{tag}: {f} does not hold the source the variant replaces")
        (d / f).write_text(src.replace(old, new, 1))
    so = d / f"{name}.so"
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(d / f"{name}.cu")],
                          check=True, capture_output=True, text=True)
    (d / f"{name}.ptxas.txt").write_text(done.stdout + done.stderr)
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(so)), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def persistent_blocks(t: torch.Tensor, per_sm: int = 1, blocks=None) -> int:
    """The grid of a persistent kernel on ``t``'s device: ``per_sm`` blocks
    an SM (a bound: the attention backwards launch as many as fit, at most
    this many), or ``blocks`` where the caller names it (a grid of a few
    blocks, to show that a kernel's results do not depend on its grid)."""
    if blocks is not None:
        if blocks < 1:
            raise ValueError(f"a grid needs at least one block, got {blocks}")
        return int(blocks)
    return per_sm * torch.cuda.get_device_properties(t.device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.tossctr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_TENSOR_CORE_OPS = ("HMMA", "HGMMA")  # mma.sync and wgmma in SASS


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """ptxas ``-v`` output -> {kernel (mangled): {registers, smem (static
    bytes; the kernels' dynamic shared memory is not in it), spill_stores,
    spill_loads}}."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            fn = m.group(1)
            out[fn] = dict(registers=0, smem=0, spill_stores=0, spill_loads=0)
            continue
        if fn is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = _PTXAS_USED.search(line)
        if m:
            out[fn].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """``parse_ptxas`` of the report the last build of ``name`` wrote ({}
    where there is none)."""
    path = BUILD_DIR / f"{name}.ptxas.txt"
    return parse_ptxas(path.read_text()) if path.exists() else {}


def parse_sass_counts(text: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -sass`` output -> {kernel (mangled): {HMMA: n, HGMMA: n}},
    its tensor-core instructions."""
    pats = {op: re.compile(rf"\b{op}\b") for op in _TENSOR_CORE_OPS}
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(_TENSOR_CORE_OPS, 0)
        elif fn is not None:
            for op, pat in pats.items():
                out[fn][op] += bool(pat.search(line))
    return out


def sass_counts(name: str) -> Optional[Dict[str, Dict[str, int]]]:
    """``parse_sass_counts`` of the built library ``name`` (None where the
    toolkit has no ``cuobjdump``)."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
        if not os.path.exists(tool):
            return None
    path = build([name])[name]
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True)
    return parse_sass_counts(res.stdout)
