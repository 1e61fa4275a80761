"""Fused qkv projection + multi-head attention over the K selected tokens.

Port of ``tossctr_tpu/ops/pallas_attention.py`` ``fused_mha_qkv``: the
forward (``_fwd_call_qkv``) and its backward (``_bwd_call_qkv``), with the
counter-hash dropout on the attention probabilities (``ops/dropout.py``).
The kernels are ``csrc/fused_mha_qkv.cu`` (forward) and
``csrc/fused_mha_qkv_bwd.cu`` (backward); ``fused_mha_qkv_reference`` and
``fused_mha_qkv_bwd_reference`` are the plain PyTorch versions with the
same rounding points, used for CPU tensors and to check the kernels on
the card.  ``fused_mha_qkv`` is differentiable: its backward is
``fused_mha_qkv_bwd``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import DTYPE_CODES, check_launch, load_library, persistent_blocks, stream_of
from .dropout import attention_keep, kernel_args


def attention_scale(head_dim: int) -> float:
    """1/sqrt(dh) as the fp32 the reference multiplies by."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _heads(t, H):
    B, K, D = t.shape
    return t.reshape(B, K, H, D // H).transpose(1, 2).float()  # (B, H, K, dh)


def _merge(t):
    B, H, K, dh = t.shape
    return t.transpose(1, 2).reshape(B, K, H * dh)


def _probs(x, wqkv, bqkv, bias, H):
    """-> q, k, v (B, H, K, dh) fp32 of x's dtype values, and the fp32
    softmax P (B, H, K, K)."""
    D = x.shape[-1]
    dt = x.dtype
    qkv = (x.float() @ wqkv.float() + bqkv.float()).to(dt)
    q, k, v = (_heads(t, H) for t in qkv.split(D, dim=-1))
    s = q @ k.transpose(-1, -2) * attention_scale(D // H)
    s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return q, k, v, e / e.sum(dim=-1, keepdim=True)


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
    scale = attention_scale(D // H)
    q, k, v, p = _probs(x, wqkv, bqkv, bias, H)
    dout = _heads(do, H)
    keep = (attention_keep(B, K, H, dropout_p, seed, device=x.device)
            if dropout_p > 0.0 else None)
    pd = p * keep if keep is not None else p
    dv = pd.to(dt).float().transpose(-1, -2) @ dout
    dp = dout @ v.transpose(-1, -2)
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=(0, 1))
    ds = (ds * scale).to(dt).float()
    dk = ds.transpose(-1, -2) @ q
    dq = ds @ k
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
                      seed: int = 0):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
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
        DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_mha_qkv")
    fused_mha_qkv.launches += 1
    return out


def fused_mha_qkv_bwd(x, wqkv, bqkv, bias, do, n_heads: int, dropout_p: float = 0.0,
                      seed: int = 0):
    """-> (dx, dwqkv, dbqkv, dbias), the last three fp32 sums over the
    batch: the kernel on a CUDA tensor (per-block fp32 partials reduced in
    a fixed order, so the result repeats bit for bit), the plain version on
    a CPU tensor."""
    _check(x, wqkv, bqkv, bias, n_heads, dropout_p)
    if do.shape != x.shape or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(f"do must match x: {tuple(do.shape)} {do.dtype} {do.device}")
    if x.device.type == "cpu":
        return fused_mha_qkv_bwd_reference(x, wqkv, bqkv, bias, do, n_heads, dropout_p, seed)
    tensors = (x, wqkv, bqkv, bias, do)
    _cuda_args("fused_mha_qkv_bwd", tensors)
    B, K, D = x.shape
    if D > 64 or K > 64:
        raise ValueError(f"fused_mha_qkv_bwd kernel takes D <= 64 and K <= 64; got D={D} K={K}")
    lib = load_library("fused_mha_qkv_bwd")
    blocks = persistent_blocks(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    n_part = D * 3 * D + 3 * D + K * K
    partials = torch.empty(blocks, n_part, **f32)
    grads = torch.empty(n_part, **f32)
    rc = lib.tossctr_fused_mha_qkv_bwd(
        *(t.data_ptr() for t in tensors), dx.data_ptr(), partials.data_ptr(),
        grads.data_ptr(), blocks, B, K, D, n_heads, attention_scale(D // n_heads),
        *kernel_args(dropout_p, seed), DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
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
