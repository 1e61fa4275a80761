"""Multi-head attention over the K selected tokens: with the qkv
projection fused in (``fused_mha_qkv``) and on already-projected q, k, v
(``fused_mha``).

Port of ``tossctr_tpu/ops/pallas_attention.py``:

* ``fused_mha_qkv``: the forward (``_fwd_call_qkv``) and its backward
  (``_bwd_call_qkv``); kernels ``csrc/fused_mha_qkv.cu`` and
  ``csrc/fused_mha_qkv_bwd.cu``, plain versions
  ``fused_mha_qkv_reference`` / ``fused_mha_qkv_bwd_reference``.  Every
  kernel-path encoder layer runs it.
* ``fused_mha``: the forward (``_fwd_call``) and its backward
  (``_bwd_call``); kernels ``csrc/fused_mha.cu`` and
  ``csrc/fused_mha_bwd.cu``, plain versions ``fused_mha_reference`` /
  ``fused_mha_bwd_reference``.  ``MultiHeadSelfAttention`` with
  ``fuse_qkv`` off runs it.

The kernels take any K.  In bf16 both forwards run their warp-unit
kernels (``csrc/mha_mma.cuh``: a warp a (16-query tile, head) unit, the
scores and the softmax in registers) at K <= 160 (the flagship's 64, the
K = 120 and K = 152 configs) with a head width D / H of 4, 8, 12 or 16
and the H heads, each padded to 8 or 16 columns, at most 64 columns
wide: ``fused_mha``'s on the tensor cores (mma.sync on bf16 tiles),
``fused_mha_qkv``'s on FFMA chains in the plain version's order, bit-equal
to the tiled CUDA-core kernel, since the bf16 training step it runs in is
held to its plain version's bits (``csrc/fused_mha_qkv.cu``).  Both
backwards run on the tensor cores at K <= 128 with a head width of 4, 8,
12 or 16.  The other shapes, and fp32, run on the CUDA cores
(``csrc/mha_core.cuh``): the forwards walk a row's queries in tiles that
fit a block's shared memory, ``fused_mha``'s backward is key-tiled (one
head at a time, its queries in tiles), ``fused_mha_qkv``'s row-resident
for K <= 64 and key-tiled above.  The choice is by dtype and shape only.
A shape whose layout fits no block, or that a kernel does not take, is
refused before any launch.

Both drop attention probabilities with the counter-hash mask of the
absolute (batch row, query, key, head) coordinates (``ops/dropout.py``
``attention_keep``).  The plain versions keep the Pallas kernels'
rounding points; they run for CPU tensors and check the kernels on the
card.  Both public functions are differentiable: their backwards are the
backward kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import DTYPE_CODES, check_launch, load_library, persistent_blocks, stream_of
from .dropout import attention_keep, kernel_args


# the bf16 forwards run their warp-unit kernels for K <= MMA_FWD_MAX_K, a
# head width _mma_head_ok takes and the heads' padded width at most
# _MMA_FWD_MAX_NQ (csrc/mha_mma.cuh kMaxKPFwd, head_ok, kMaxFwdNQ), the
# tiled CUDA-core ones at every other shape; the bf16 backwards run their
# tensor-core kernels for K <= MMA_MAX_K and the key-tiled CUDA-core ones
# above; fused_mha_qkv_bwd's fp32 row-resident kernel takes K <=
# ROW_RESIDENT_MAX_K.  The backwards launch
# as many persistent blocks as fit, at most BWD_BLOCKS_PER_SM an SM (the
# partials' rows): two fit for fused_mha_bwd's tensor-core kernel at K <=
# 64 (8 warps, 90 KB) and the key-tiled ones, one for its tensor-core
# kernel at K <= 128 (192 KB), for fused_mha_qkv_bwd's tensor-core kernel
# (16 warps and 223 KB at K <= 64, 8 warps and 208 KB at K <= 128) and
# for its row-resident one
MMA_FWD_MAX_K = 160
_MMA_FWD_MAX_NQ = 64
MMA_MAX_K = 128
ROW_RESIDENT_MAX_K = 64
BWD_BLOCKS_PER_SM = 2
# the qkv tensor-core kernel's dWqkv, head-padded, in at most this many
# 16 x 16 units (csrc/fused_mha_qkv_bwd.cu kWUnits)
_MMA_WGRAD_UNITS = 48


def _mma_head_ok(head_dim: int) -> bool:
    """The tensor-core backwards' head widths: 4, 8, 12 or 16 (each head
    padded to 8 or 16 columns)."""
    return 4 <= head_dim <= 16 and head_dim % 4 == 0


def _padded_heads(D: int, n_heads: int) -> int:
    """The H heads' width in the warp-unit kernels' slabs: each head
    padded to 8 or 16 columns."""
    return n_heads * (8 if D // n_heads <= 8 else 16)


def fwd_unit_kernel(dtype, K: int, D: int, n_heads: int) -> bool:
    """Whether a forward of this dtype and shape runs its warp-unit kernel
    on the card: bf16, K <= MMA_FWD_MAX_K, a head width of 4, 8, 12 or 16
    and the padded heads at most _MMA_FWD_MAX_NQ columns wide (D <= 64 at
    the flagship's 8-column heads).  Every other shape runs the tiled
    CUDA-core kernel."""
    return (dtype == torch.bfloat16 and K <= MMA_FWD_MAX_K
            and _mma_head_ok(D // n_heads) and _padded_heads(D, n_heads) <= _MMA_FWD_MAX_NQ)


def _mma_qkv_ok(D: int, n_heads: int) -> bool:
    """fused_mha_qkv_bwd's tensor-core kernel also holds dWqkv, (D, 3D)
    with each head padded, in at most _MMA_WGRAD_UNITS 16 x 16 units."""
    nq = -(-_padded_heads(D, n_heads) // 16) * 16
    return _mma_head_ok(D // n_heads) and (-(-D // 16)) * (3 * nq // 16) <= _MMA_WGRAD_UNITS


def attention_scale(head_dim: int) -> float:
    """1/sqrt(dh) as the fp32 the reference multiplies by."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _heads(t, H):
    B, K, D = t.shape
    return t.reshape(B, K, H, D // H).transpose(1, 2).float()  # (B, H, K, dh)


def _merge(t):
    B, H, K, dh = t.shape
    return t.transpose(1, 2).reshape(B, K, H * dh)


def _softmax(q, k, bias):
    """q, k (B, H, K, dh) fp32 -> the fp32 softmax P (B, H, K, K) of
    q k^T / sqrt(dh) + bias."""
    s = q @ k.transpose(-1, -2) * attention_scale(q.shape[-1])
    s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _probs(x, wqkv, bqkv, bias, H):
    """-> q, k, v (B, H, K, dh) fp32 of x's dtype values, and the fp32
    softmax P (B, H, K, K)."""
    D = x.shape[-1]
    qkv = (x.float() @ wqkv.float() + bqkv.float()).to(x.dtype)
    q, k, v = (_heads(t, H) for t in qkv.split(D, dim=-1))
    return q, k, v, _softmax(q, k, bias)


def _attend_bwd(q, k, v, p, dout, keep, dt):
    """The attention core's backward with the Pallas rounding points
    (pallas_attention.py:250-330, 456-510): P stays fp32 for
    ds = p*(dp - sum(dp*p)); dv uses the rounded dropped P; dp is
    multiplied by the keep mask; dbias sums the unscaled fp32 ds, then
    ds*scale is rounded to ``dt`` before dq and dk.  q, k, v, dout (B, H,
    K, dh) fp32 -> (dq, dk, dv (B, H, K, dh) fp32, dbias (K, K) fp32)."""
    pd = p * keep if keep is not None else p
    dv = pd.to(dt).float().transpose(-1, -2) @ dout
    dp = dout @ v.transpose(-1, -2)
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=(0, 1))
    ds = (ds * attention_scale(q.shape[-1])).to(dt).float()
    return ds @ k, ds.transpose(-1, -2) @ q, dv, dbias


def fused_mha_qkv_reference(x, wqkv, bqkv, bias, n_heads: int,
                            dropout_p: float = 0.0, seed: int = 0):
    """x (B, K, D); wqkv (D, 3D) in x's dtype; bqkv (3D,) fp32; bias (K, K)
    head-shared, in x's dtype.  q, k, v are rounded to x's dtype, the
    softmax is fp32, P is multiplied by the keep mask in fp32 and then
    rounded to x's dtype before P·V, the output is x's dtype
    (pallas_attention.py:369-428, 709-757)."""
    B, K, _ = x.shape
    _, _, v, p = _probs(x, wqkv, bqkv, bias, n_heads)
    if dropout_p > 0.0:
        p = p * attention_keep(B, K, n_heads, dropout_p, seed, device=x.device)
    o = p.to(x.dtype).float() @ v
    return _merge(o).to(x.dtype)


def fused_mha_qkv_bwd_reference(x, wqkv, bqkv, bias, do, n_heads: int,
                                dropout_p: float = 0.0, seed: int = 0):
    """Gradients of ``fused_mha_qkv_reference`` w.r.t. x, wqkv, bqkv and
    bias, with the rounding points of the Pallas backward
    (pallas_attention.py:456-510, 760-845): P stays fp32 for
    ds = p*(dp - sum(dp*p)); dv uses the rounded dropped P; dp is
    multiplied by the keep mask; dbias sums the unscaled fp32 ds, then
    ds*scale is rounded before dq and dk; dq, dk, dv are rounded before dx
    and dW; db sums the fp32 dq, dk, dv.  -> (dx in x's dtype, dwqkv (D, 3D),
    dbqkv (3D,), dbias (K, K)), the last three fp32 sums over the batch."""
    B, K, D = x.shape
    H = n_heads
    dt = x.dtype
    q, k, v, p = _probs(x, wqkv, bqkv, bias, H)
    keep = (attention_keep(B, K, H, dropout_p, seed, device=x.device)
            if dropout_p > 0.0 else None)
    dq, dk, dv, dbias = _attend_bwd(q, k, v, p, _heads(do, H), keep, dt)
    dqkv = torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).reshape(B * K, 3 * D)
    dqkv_t = dqkv.to(dt).float()
    dx = (dqkv_t @ wqkv.float().t()).reshape(B, K, D).to(dt)
    dw = x.float().reshape(B * K, D).t() @ dqkv_t
    return dx, dw, dqkv.sum(dim=0), dbias


def _check(x, wqkv, bqkv, bias, n_heads, dropout_p):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, K, D), got {tuple(x.shape)}")
    B, K, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if n_heads < 1 or D % n_heads:
        raise ValueError(f"D={D} must divide by n_heads={n_heads}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    want = {"wqkv": ((D, 3 * D), x.dtype), "bqkv": ((3 * D,), torch.float32),
            "bias": ((K, K), x.dtype)}
    for name, t in (("wqkv", wqkv), ("bqkv", bqkv), ("bias", bias)):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _cuda_args(name, tensors):
    if tensors[0].device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def fused_mha_qkv_fwd(x, wqkv, bqkv, bias, n_heads: int, dropout_p: float = 0.0,
                      seed: int = 0, blocks=None):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  On the card the warp-unit kernel where
    ``fwd_unit_kernel`` says so (bf16, K <= 160, head widths 4, 8, 12, 16;
    x and the output aligned for its 16- or 8-byte copies, or refused),
    the tiled CUDA-core kernel at every other shape; the two give the same
    bits.  ``blocks`` caps the kernel's persistent grid
    (default: as many blocks as fit on the SMs); the output does not
    depend on it."""
    _check(x, wqkv, bqkv, bias, n_heads, dropout_p)
    if x.device.type == "cpu":
        return fused_mha_qkv_reference(x, wqkv, bqkv, bias, n_heads, dropout_p, seed)
    tensors = (x, wqkv, bqkv, bias)
    _cuda_args("fused_mha_qkv", tensors)
    B, K, D = x.shape
    out = torch.empty_like(x)
    lib = load_library("fused_mha_qkv")
    rc = lib.tossctr_fused_mha_qkv_fwd(
        *(t.data_ptr() for t in tensors), out.data_ptr(), B, K, D, n_heads,
        attention_scale(D // n_heads), *kernel_args(dropout_p, seed),
        int(blocks or 0), int(fwd_unit_kernel(x.dtype, K, D, n_heads)), DTYPE_CODES[x.dtype],
        x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_mha_qkv")
    fused_mha_qkv.launches += 1
    return out


def fused_mha_qkv_bwd(x, wqkv, bqkv, bias, do, n_heads: int, dropout_p: float = 0.0,
                      seed: int = 0, tiled: bool = False, blocks=None):
    """-> (dx, dwqkv, dbqkv, dbias), the last three fp32 sums over the
    batch: the kernel on a CUDA tensor (per-block fp32 partials reduced in
    a fixed order, so the result repeats bit for bit), the plain version on
    a CPU tensor.  In bf16 the card runs the tensor-core kernel for K <=
    128 (a head width of 4, 8, 12 or 16) and the key-tiled one above; in
    fp32 the row-resident kernel for K <= 64 and the key-tiled one above.
    ``tiled`` asks for the fp32 key-tiled kernel at any K (bf16 ignores
    it); the model never passes it, the card tests do, to hold the
    key-tiled kernel at small K.  ``blocks`` caps the persistent grid
    (default: as many as fit, at most BWD_BLOCKS_PER_SM an SM); dx does
    not depend on it, the weight gradients' partials regroup."""
    _check(x, wqkv, bqkv, bias, n_heads, dropout_p)
    if do.shape != x.shape or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(f"do must match x: {tuple(do.shape)} {do.dtype} {do.device}")
    if x.device.type == "cpu":
        return fused_mha_qkv_bwd_reference(x, wqkv, bqkv, bias, do, n_heads, dropout_p, seed)
    tensors = (x, wqkv, bqkv, bias, do)
    _cuda_args("fused_mha_qkv_bwd", tensors)
    B, K, D = x.shape
    if D > 64 or D % 4:
        raise ValueError(f"fused_mha_qkv_bwd kernel takes D <= 64, D % 4 == 0; got D={D}")
    if x.dtype == torch.bfloat16 and K <= MMA_MAX_K:
        if not _mma_qkv_ok(D, n_heads):
            raise ValueError(f"the tensor-core fused_mha_qkv_bwd kernel takes a head width "
                             f"D / n_heads of 4, 8, 12 or 16 (with dWqkv in "
                             f"{_MMA_WGRAD_UNITS} units); got D={D}, n_heads={n_heads}")
    elif (tiled or K > ROW_RESIDENT_MAX_K) and (D // n_heads) % 4:
        raise ValueError(f"the key-tiled fused_mha_qkv_bwd kernel takes a head width "
                         f"D / n_heads divisible by 4; got {D // n_heads}")
    lib = load_library("fused_mha_qkv_bwd")
    blocks = persistent_blocks(x, per_sm=BWD_BLOCKS_PER_SM, blocks=blocks)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    n_part = D * 3 * D + 3 * D + K * K
    partials = torch.empty(blocks, n_part, **f32)
    grads = torch.empty(n_part, **f32)
    rc = lib.tossctr_fused_mha_qkv_bwd(
        *(t.data_ptr() for t in tensors), dx.data_ptr(), partials.data_ptr(),
        grads.data_ptr(), blocks, B, K, D, n_heads, attention_scale(D // n_heads),
        *kernel_args(dropout_p, seed), int(tiled), DTYPE_CODES[x.dtype], x.device.index,
        stream_of(x),
    )
    check_launch(lib, rc, "fused_mha_qkv_bwd")
    fused_mha_qkv_bwd.launches += 1
    dw, db, dbias = grads.split([D * 3 * D, 3 * D, K * K])
    return dx, dw.view(D, 3 * D), db, dbias.view(K, K)


class _FusedMHAQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, bias, n_heads, dropout_p, seed):
        ctx.save_for_backward(x, wqkv, bqkv, bias)
        ctx.cfg = (n_heads, dropout_p, seed)
        return fused_mha_qkv_fwd(x, wqkv, bqkv, bias, n_heads, dropout_p, seed)

    @staticmethod
    def backward(ctx, do):
        x, wqkv, bqkv, bias = ctx.saved_tensors
        dx, dw, db, dbias = fused_mha_qkv_bwd(x, wqkv, bqkv, bias, do.contiguous(), *ctx.cfg)
        # the weight grads leave in the dtypes of the weights received, as
        # the Pallas custom_vjp returns them (pallas_attention.py:1133-1141)
        return dx, dw.to(wqkv.dtype), db.to(bqkv.dtype), dbias.to(bias.dtype), None, None, None


def fused_mha_qkv(x, wqkv, bqkv, bias, n_heads: int, dropout_p: float = 0.0,
                  seed: int = 0):
    """softmax((x Wq + bq)(x Wk + bk)^T / sqrt(dh) + bias)(x Wv + bv) for
    all heads, with dropout ``dropout_p`` on the probabilities from the
    counter hash of ``seed`` -> (B, K, D) in x's dtype.  Differentiable in
    x, wqkv, bqkv and bias.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    or raise."""
    return _FusedMHAQKV.apply(x, wqkv, bqkv, bias, n_heads, float(dropout_p), int(seed))


fused_mha_qkv.launches = 0
fused_mha_qkv_bwd.launches = 0


# ---- fused_mha: attention on already-projected q, k, v ----


def fused_mha_reference(q, k, v, bias, n_heads: int, dropout_p: float = 0.0, seed: int = 0):
    """q, k, v (B, K, D) and the head-shared bias (K, K) in one dtype.  The
    softmax is fp32 over the K key columns; P is multiplied by the keep
    mask in fp32 and rounded to q's dtype before P.V; the output is q's
    dtype (pallas_attention.py:211-247, 369-428)."""
    B, K, _ = q.shape
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    p = _softmax(qh, kh, bias)
    if dropout_p > 0.0:
        p = p * attention_keep(B, K, n_heads, dropout_p, seed, device=q.device)
    return _merge(p.to(q.dtype).float() @ vh).to(q.dtype)


def fused_mha_bwd_reference(q, k, v, bias, do, n_heads: int, dropout_p: float = 0.0,
                            seed: int = 0):
    """Gradients of ``fused_mha_reference`` w.r.t. q, k, v and bias, with
    the rounding points of the Pallas backward (``_attend_bwd``).  -> (dq,
    dk, dv in q's dtype, dbias (K, K) the fp32 sum over the batch and the
    heads)."""
    B, K, _ = q.shape
    H = n_heads
    qh, kh, vh = (_heads(t, H) for t in (q, k, v))
    p = _softmax(qh, kh, bias)
    keep = (attention_keep(B, K, H, dropout_p, seed, device=q.device)
            if dropout_p > 0.0 else None)
    dq, dk, dv, dbias = _attend_bwd(qh, kh, vh, p, _heads(do, H), keep, q.dtype)
    return (*(_merge(t).to(q.dtype) for t in (dq, dk, dv)), dbias)


def _check_mha(q, k, v, bias, n_heads, dropout_p):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, K, D), got {tuple(q.shape)}")
    B, K, D = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q dtype must be float32 or bfloat16, got {q.dtype}")
    if n_heads < 1 or D % n_heads:
        raise ValueError(f"D={D} must divide by n_heads={n_heads}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    for name, t, shape in (("k", k, (B, K, D)), ("v", v, (B, K, D)), ("bias", bias, (K, K))):
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must be {shape} {q.dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def fused_mha_fwd(q, k, v, bias, n_heads: int, dropout_p: float = 0.0, seed: int = 0,
                  blocks=None):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  On the card the warp-unit kernel (the
    tensor cores) where ``fwd_unit_kernel`` says so (q, k, v and the
    output aligned for its 16- or 8-byte copies, or refused), the tiled
    CUDA-core kernel at every other shape.  ``blocks`` caps the kernel's
    persistent grid (default: as many blocks as fit on the SMs); the
    output does not depend on it."""
    _check_mha(q, k, v, bias, n_heads, dropout_p)
    if q.device.type == "cpu":
        return fused_mha_reference(q, k, v, bias, n_heads, dropout_p, seed)
    tensors = (q, k, v, bias)
    _cuda_args("fused_mha", tensors)
    B, K, D = q.shape
    out = torch.empty_like(q)
    lib = load_library("fused_mha")
    rc = lib.tossctr_fused_mha_fwd(
        *(t.data_ptr() for t in tensors), out.data_ptr(), B, K, D, n_heads,
        attention_scale(D // n_heads), *kernel_args(dropout_p, seed),
        int(blocks or 0), int(fwd_unit_kernel(q.dtype, K, D, n_heads)), DTYPE_CODES[q.dtype],
        q.device.index, stream_of(q),
    )
    check_launch(lib, rc, "fused_mha")
    fused_mha.launches += 1
    return out


def fused_mha_bwd(q, k, v, bias, do, n_heads: int, dropout_p: float = 0.0, seed: int = 0,
                  blocks=None):
    """-> (dq, dk, dv, dbias), dbias the fp32 sum over the batch and the
    heads: on a CUDA tensor the tensor-core kernel in bf16 at K <= 128 (a
    head width of 4, 8, 12 or 16), else the key-tiled one (per-block fp32
    partials reduced in a fixed order, so the result repeats bit for
    bit); the plain version on a CPU tensor.  ``blocks`` caps the persistent grid
    (default: as many as fit, at most BWD_BLOCKS_PER_SM an SM); dq, dk, dv
    do not depend on it, dbias's partials regroup."""
    _check_mha(q, k, v, bias, n_heads, dropout_p)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype} {do.device}")
    if q.device.type == "cpu":
        return fused_mha_bwd_reference(q, k, v, bias, do, n_heads, dropout_p, seed)
    tensors = (q, k, v, bias, do)
    _cuda_args("fused_mha_bwd", tensors)
    B, K, D = q.shape
    if D > 64:
        raise ValueError(f"fused_mha_bwd kernel takes D <= 64; got D={D}")
    if q.dtype == torch.bfloat16 and K <= MMA_MAX_K and not _mma_head_ok(D // n_heads):
        raise ValueError(f"the tensor-core fused_mha_bwd kernel takes a head width D / n_heads "
                         f"of 4, 8, 12 or 16; got {D // n_heads}")
    lib = load_library("fused_mha_bwd")
    blocks = persistent_blocks(q, per_sm=BWD_BLOCKS_PER_SM, blocks=blocks)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    partials = torch.empty(blocks, K * K, dtype=torch.float32, device=q.device)
    dbias = torch.empty(K, K, dtype=torch.float32, device=q.device)
    rc = lib.tossctr_fused_mha_bwd(
        *(t.data_ptr() for t in tensors), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        partials.data_ptr(), dbias.data_ptr(), blocks, B, K, D, n_heads,
        attention_scale(D // n_heads), *kernel_args(dropout_p, seed),
        DTYPE_CODES[q.dtype], q.device.index, stream_of(q),
    )
    check_launch(lib, rc, "fused_mha_bwd")
    fused_mha_bwd.launches += 1
    return dq, dk, dv, dbias


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, n_heads, dropout_p, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.cfg = (n_heads, dropout_p, seed)
        return fused_mha_fwd(q, k, v, bias, n_heads, dropout_p, seed)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = fused_mha_bwd(q, k, v, bias, do.contiguous(), *ctx.cfg)
        # dq, dk, dv in q's dtype and dbias in the bias's, as the Pallas
        # custom_vjp returns them (pallas_attention.py:1010-1014)
        return dq, dk, dv, dbias.to(bias.dtype), None, None, None


def fused_mha(q, k, v, bias, n_heads: int, dropout_p: float = 0.0, seed: int = 0):
    """softmax(q k^T / sqrt(dh) + bias) v for all heads, q, k, v (B, K, D)
    head-major (D = n_heads * dh) and bias (K, K) shared by the heads and
    the batch, with dropout ``dropout_p`` on the probabilities from the
    counter hash of ``seed`` -> (B, K, D) in q's dtype.  Differentiable in
    q, k, v and bias.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    or raise.  The backward kernel takes D <= 64 and, in bf16 at K <= 128,
    a head width of 4, 8, 12 or 16."""
    return _FusedMHA.apply(q, k, v, bias, n_heads, float(dropout_p), int(seed))


fused_mha.launches = 0
fused_mha_bwd.launches = 0
