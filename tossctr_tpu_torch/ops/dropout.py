"""Counter-hash dropout masks of the fused encoder kernels.

Port of the hash masks of ``tossctr_tpu/ops/pallas_attention.py``
(``_dropout_keep``, ``dropout_keep_reference``) and
``tossctr_tpu/ops/pallas_ffn.py`` (``_ffn_keep``, ``ffn_keep_reference``).
A keep mask is a pure function of absolute coordinates and a seed:

* attention: (batch row, query, key, head, seed) -> (B, H, Kq, Kk);
* FFN hidden: (flattened row b*K+q, hidden column, seed) -> (N, F);

hashed with a murmur3-style finaliser and kept where the 32-bit hash is
at least ``int(p * 2**32)``, scaled by 1/(1-p) in fp32.  Forward and
backward regenerate the same mask, so it is never stored; the CUDA
kernels compute the same hash in ``csrc/common.cuh``.

The JAX package's schema default ``dropout_impl: hw`` draws from the TPU's
hardware PRNG, which has no counterpart on the card; the JAX package
itself falls back to this hash on every non-TPU backend
(``_resolve_dropout_impl``), and the port always runs the hash.

The torch versions hash in int64 and mask with ``& 0xFFFFFFFF`` after
each multiply: the low 32 bits stay right even where the int64 product
wraps, and torch's uint32 arithmetic is incomplete on the CPU.

``dump_attention_keep`` / ``dump_ffn_keep`` write the masks on the card
through kernel ``csrc/dropout_dump.cu`` (the port of
``exp/hw_dropout_device_check.py``'s two mask dumps), which forms the
same 32-bit hash as the eight dropping encoder kernels (``common.cuh``'s
mixing constants and ``fmix32``) over tiles the grid indexes directly;
their plain versions are ``attention_keep`` / ``ffn_keep``, bit-equal at
every shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check_launch, load_library, stream_of

# murmur3-style mixing constants of pallas_attention.py
MIX_R = 0x9E3779B1
MIX_Q = 0x85EBCA77
MIX_K = 0xC2B2AE3D
MIX_H = 0x27D4EB2F
MIX_S = 0x165667B1
FMIX_C1 = 0x7FEB352D
FMIX_C2 = 0x846CA68B
_M32 = 0xFFFFFFFF


def keep_threshold(p: float) -> int:
    """The 32-bit hash value at and above which an element is kept."""
    return int(p * (2**32))


def keep_scale(p: float) -> float:
    """1/(1-p) as the fp32 value the reference multiplies kept elements by."""
    return float(np.float32(1.0) / np.float32(1.0 - p))


def kernel_args(p: float, seed: int):
    """(keep threshold, keep scale, seed) as the CUDA entry points take
    them; threshold 0 turns dropout off."""
    if p <= 0.0:
        return 0, 1.0, 0
    return keep_threshold(p), keep_scale(p), int(seed) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * FMIX_C1) & _M32
    x = x ^ (x >> 15)
    x = (x * FMIX_C2) & _M32
    return x ^ (x >> 16)


def _term(idx: torch.Tensor, mix: int) -> torch.Tensor:
    return (idx * mix) & _M32


def _keep(h: torch.Tensor, p: float) -> torch.Tensor:
    keep = (_fmix32(h) >= keep_threshold(p)).to(torch.float32)
    return keep * keep_scale(p)


def attention_keep(B: int, K: int, n_heads: int, p: float, seed: int,
                   device=None, row0: int = 0) -> torch.Tensor:
    """Scaled keep mask of the attention probabilities -> (B, H, K, K) fp32
    for batch rows row0 .. row0+B-1."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    r = _term(ar(B) + row0, MIX_R)[:, None, None, None]
    h = _term(ar(n_heads), MIX_H)[None, :, None, None]
    q = _term(ar(K), MIX_Q)[None, None, :, None]
    k = _term(ar(K), MIX_K)[None, None, None, :]
    s = (int(seed) & _M32) * MIX_S & _M32
    return _keep((r + q + k + h + s) & _M32, p)


def ffn_keep(N: int, F: int, p: float, seed: int, device=None, row0: int = 0) -> torch.Tensor:
    """Scaled keep mask of the FFN hidden units -> (N, F) fp32 for rows
    row0 .. row0+N-1 of the flattened (B*K, F) hidden."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    r = _term(ar(N) + row0, MIX_R)[:, None]
    c = _term(ar(F), MIX_Q)[None, :]
    s = (int(seed) & _M32) * MIX_S & _M32
    return _keep((r + c + s) & _M32, p)


def _dump(kind: int, rows: int, K: int, H: int, p: float, seed: int, device):
    if not 0.0 < p < 1.0:
        raise ValueError(f"a mask dump needs 0 < p < 1, got {p}")
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"dropout_dump: unsupported device {device}")
    shape = (rows, H, K, K) if kind == 0 else (rows, K)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    lib = load_library("dropout_dump")
    rc = lib.tossctr_dropout_dump(out.data_ptr(), kind, rows, K, H, *kernel_args(p, seed),
                                  out.device.index, stream_of(out))
    check_launch(lib, rc, "dropout_dump")
    return out


def dump_attention_keep(B: int, K: int, n_heads: int, p: float, seed: int,
                        device) -> torch.Tensor:
    """The attention mask the kernels draw, written by the dump kernel ->
    (B, H, K, K) fp32 scaled keep (0 < p < 1).  On the CPU the plain
    version ``attention_keep``; on the card the kernel, or it raises."""
    if torch.device(device).type == "cpu":
        return attention_keep(B, K, n_heads, p, seed)
    out = _dump(0, B, K, n_heads, p, seed, device)
    dump_attention_keep.launches += 1
    return out


def dump_ffn_keep(N: int, F: int, p: float, seed: int, device) -> torch.Tensor:
    """The FFN hidden mask the kernels draw, written by the dump kernel ->
    (N, F) fp32 scaled keep over the flattened rows (0 < p < 1).  On the
    CPU the plain version ``ffn_keep``; on the card the kernel, or it
    raises."""
    if torch.device(device).type == "cpu":
        return ffn_keep(N, F, p, seed)
    out = _dump(1, N, F, 1, p, seed, device)
    dump_ffn_keep.launches += 1
    return out


dump_attention_keep.launches = 0
dump_ffn_keep.launches = 0


def _np_fmix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(FMIX_C1)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(FMIX_C2)
    return x ^ (x >> np.uint32(16))


def dropout_keep_reference(B: int, Kq: int, Kk: int, n_heads: int, p: float, seed: int):
    """Numpy oracle of the attention mask -> (H, B, Kq, Kk) scaled keep
    (the layout of the JAX package's oracle)."""
    r = np.arange(B, dtype=np.uint32)[None, :, None, None]
    qi = np.arange(Kq, dtype=np.uint32)[None, None, :, None]
    kj = np.arange(Kk, dtype=np.uint32)[None, None, None, :]
    h = np.arange(n_heads, dtype=np.uint32)[:, None, None, None]
    with np.errstate(over="ignore"):
        x = (r * np.uint32(MIX_R) + qi * np.uint32(MIX_Q) + kj * np.uint32(MIX_K)
             + h * np.uint32(MIX_H) + np.uint32(int(seed) & _M32) * np.uint32(MIX_S))
        x = _np_fmix32(x)
    keep = (x >= np.uint32(keep_threshold(p))).astype(np.float32)
    return keep / np.float32(1.0 - p)


def ffn_keep_reference(N: int, F: int, p: float, seed: int):
    """Numpy oracle of the FFN hidden mask -> (N, F) scaled keep."""
    r = np.arange(N, dtype=np.uint32)[:, None]
    c = np.arange(F, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        x = (r * np.uint32(MIX_R) + c * np.uint32(MIX_Q)
             + np.uint32(int(seed) & _M32) * np.uint32(MIX_S))
        x = _np_fmix32(x)
    keep = (x >= np.uint32(keep_threshold(p))).astype(np.float32)
    return keep / np.float32(1.0 - p)
