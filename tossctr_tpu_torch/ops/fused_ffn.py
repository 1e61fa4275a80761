"""Fused encoder-block tail: out-projection, residual, RMSNorm, GELU FFN
with hidden dropout, residual, RMSNorm.

Port of ``tossctr_tpu/ops/pallas_ffn.py`` ``fused_block_tail``: the
forward (``_tail_fwd_call``) and its backward (``_tail_bwd_call``), with
the counter-hash dropout on the FFN hidden units (``ops/dropout.py``).
The kernels are ``csrc/fused_block_tail.cu`` (forward) and
``csrc/fused_block_tail_bwd.cu`` (backward); ``fused_block_tail_reference``
and ``fused_block_tail_bwd_reference`` are the plain PyTorch versions with
the same rounding points, used for CPU tensors and to check the kernels
on the card.  ``fused_block_tail`` is differentiable: its backward is
``fused_block_tail_bwd``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import DTYPE_CODES, check_launch, load_library, persistent_blocks, stream_of
from .dropout import ffn_keep, kernel_args

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2.0 / np.pi)))
_GELU_C = float(np.float32(0.044715))
_GELU_3C = float(np.float32(3.0) * np.float32(0.044715))
RMS_EPS = 1e-6


def gelu_tanh(h):
    """Tanh-approximate GELU in the reference's operation order
    (pallas_ffn.py:61-63; flax ``nn.gelu``'s default)."""
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(u))


def gelu_tanh_grad(h):
    """d gelu_tanh / dh in the reference's operation order (pallas_ffn.py:66-70)."""
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + _GELU_3C * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def _rms_parts(r, w, eps: float = RMS_EPS):
    """-> (y in r's dtype, inv fp32, y_hat fp32) (pallas_ffn._rms_fwd)."""
    rf = r.float()
    inv = torch.rsqrt((rf * rf).mean(dim=-1, keepdim=True) + eps)
    y_hat = rf * inv
    return (w.float() * y_hat).to(r.dtype), inv, y_hat


def rms_norm(r, w, eps: float = RMS_EPS):
    """w * r * rsqrt(mean(r^2) + eps) with fp32 statistics, cast back to
    r's dtype (models/layers.RMSNorm, pallas_ffn._rms_fwd)."""
    return _rms_parts(r, w, eps)[0]


def _rms_bwd(dy, w, inv, y_hat):
    """-> (dr fp32, dw fp32) (pallas_ffn._rms_bwd)."""
    dyf = dy.float()
    g = dyf * w.float()
    dr = inv * (g - y_hat * (g * y_hat).mean(dim=-1, keepdim=True))
    return dr, (dyf * y_hat).sum(dim=0)


def _tail_fwd(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p, seed):
    """The forward with every intermediate the backward needs
    (pallas_ffn._block_tail_fwd_core)."""
    dt = x.dtype
    a = (o.float() @ wout.float() + bout.float()).to(dt)
    y1, inv1, y_hat1 = _rms_parts(x + a, wn1)
    h = y1.float() @ w1.float() + b1.float()
    g = gelu_tanh(h)
    keep = None
    if dropout_p > 0.0:
        keep = ffn_keep(x.shape[0], w1.shape[1], dropout_p, seed, device=x.device)
        g = g * keep
    ff = (g.to(dt).float() @ w2.float() + b2.float()).to(dt)
    y2, inv2, y_hat2 = _rms_parts(y1 + ff, wn2)
    return y1, inv1, y_hat1, h, g, keep, inv2, y_hat2, y2


def fused_block_tail_reference(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                               dropout_p: float = 0.0, seed: int = 0):
    """x, o (N, D); wout (D, D), w1 (D, F), w2 (F, D) in x's dtype; bout,
    b1, b2, wn1, wn2 fp32.  Rounds to x's dtype where the Pallas kernel
    does (pallas_ffn.py:367-392); the hidden h, GELU and the dropout
    product are fp32, rounded once before the second product."""
    return _tail_fwd(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p, seed)[-1]


def fused_block_tail_bwd_reference(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dy,
                                   dropout_p: float = 0.0, seed: int = 0):
    """Gradients of ``fused_block_tail_reference`` with the rounding points
    of the Pallas backward (pallas_ffn.py:411-496): dr2, dh and dr1 are
    rounded to x's dtype before their products, dy1 before the norm-1
    backward; dx is dr1 alone (the residual path).  -> (dx, do in x's
    dtype; dwout, dbout, dwn1, dw1, db1, dw2, db2, dwn2 fp32 sums over
    the rows)."""
    dt = x.dtype
    y1, inv1, y_hat1, h, g, keep, inv2, y_hat2, _ = _tail_fwd(
        x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p, seed)
    dr2, dwn2 = _rms_bwd(dy, wn2, inv2, y_hat2)
    dr2c = dr2.to(dt).float()
    dw2 = g.to(dt).float().t() @ dr2c
    dg = dr2c @ w2.float().t()
    if keep is not None:
        dg = dg * keep
    dh = dg * gelu_tanh_grad(h)
    dhc = dh.to(dt).float()
    dw1 = y1.float().t() @ dhc
    dy1 = dr2 + dhc @ w1.float().t()
    dr1, dwn1 = _rms_bwd(dy1.to(dt), wn1, inv1, y_hat1)
    dr1c = dr1.to(dt).float()
    dwout = o.float().t() @ dr1c
    do = (dr1c @ wout.float().t()).to(dt)
    return (dr1.to(dt), do, dwout, dr1.sum(dim=0), dwn1, dw1, dh.sum(dim=0), dw2,
            dr2.sum(dim=0), dwn2)


def _check(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p):
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    if w1.dim() != 2 or w1.shape[0] != D:
        raise ValueError(f"w1 must be (D={D}, F), got {tuple(w1.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    F = w1.shape[1]
    f32 = torch.float32
    want = {
        "o": (o, (N, D), x.dtype), "wout": (wout, (D, D), x.dtype),
        "bout": (bout, (D,), f32), "wn1": (wn1, (D,), f32),
        "w1": (w1, (D, F), x.dtype), "b1": (b1, (F,), f32),
        "w2": (w2, (F, D), x.dtype), "b2": (b2, (D,), f32),
        "wn2": (wn2, (D,), f32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _cuda_args(name, args):
    if args[0].device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {args[0].device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    D, F = args[5].shape
    if D > 64 or D % 4 or F % 4:
        raise ValueError(f"{name} kernel takes D <= 64, D and F % 4 == 0; got D={D} F={F}")


def fused_block_tail_fwd(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                         dropout_p: float = 0.0, seed: int = 0):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    args = (x, o, wout, bout, wn1, w1, b1, w2, b2, wn2)
    _check(*args, dropout_p)
    if x.device.type == "cpu":
        return fused_block_tail_reference(*args, dropout_p, seed)
    _cuda_args("fused_block_tail", args)
    N, D = x.shape
    F = w1.shape[1]
    y = torch.empty_like(x)
    lib = load_library("fused_block_tail")
    rc = lib.tossctr_fused_block_tail_fwd(
        *(t.data_ptr() for t in args), y.data_ptr(), N, D, F,
        *kernel_args(dropout_p, seed), DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_block_tail")
    fused_block_tail.launches += 1
    return y


def fused_block_tail_bwd(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dy,
                         dropout_p: float = 0.0, seed: int = 0):
    """-> (dx, do, dwout, dbout, dwn1, dw1, db1, dw2, db2, dwn2), the last
    eight fp32 sums over the rows: the kernel on a CUDA tensor (per-block
    fp32 partials reduced in a fixed order, so the result repeats bit for
    bit), the plain version on a CPU tensor."""
    args = (x, o, wout, bout, wn1, w1, b1, w2, b2, wn2)
    _check(*args, dropout_p)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} {dy.device}")
    if x.device.type == "cpu":
        return fused_block_tail_bwd_reference(*args, dy, dropout_p, seed)
    _cuda_args("fused_block_tail_bwd", args + (dy,))
    N, D = x.shape
    F = w1.shape[1]
    lib = load_library("fused_block_tail_bwd")
    blocks = persistent_blocks(x)
    sizes = [D * D, D, D, D * F, F, F * D, D, D]  # dwout dbout dwn1 dw1 db1 dw2 db2 dwn2
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, do = torch.empty_like(x), torch.empty_like(x)
    partials = torch.empty(blocks, sum(sizes), **f32)
    grads = torch.empty(sum(sizes), **f32)
    rc = lib.tossctr_fused_block_tail_bwd(
        *(t.data_ptr() for t in args), dy.data_ptr(), dx.data_ptr(), do.data_ptr(),
        partials.data_ptr(), grads.data_ptr(), blocks, N, D, F,
        *kernel_args(dropout_p, seed), DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_block_tail_bwd")
    fused_block_tail_bwd.launches += 1
    dwout, dbout, dwn1, dw1, db1, dw2, db2, dwn2 = grads.split(sizes)
    return (dx, do, dwout.view(D, D), dbout, dwn1, dw1.view(D, F), db1, dw2.view(F, D),
            db2, dwn2)


class _FusedBlockTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p, seed):
        args = (x, o, wout, bout, wn1, w1, b1, w2, b2, wn2)
        ctx.save_for_backward(*args)
        ctx.cfg = (dropout_p, seed)
        return fused_block_tail_fwd(*args, dropout_p, seed)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.saved_tensors
        grads = fused_block_tail_bwd(*args, dy.contiguous(), *ctx.cfg)
        # each grad leaves in the dtype of the input received, as the
        # Pallas custom_vjp returns them (pallas_ffn.py:636-641)
        return (*(g.to(a.dtype) for g, a in zip(grads, args)), None, None)


def fused_block_tail(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                     dropout_p: float = 0.0, seed: int = 0):
    """rmsnorm(y1 + ffn(y1)) * wn2 where y1 = rmsnorm(x + o@wout + bout) * wn1
    and the FFN drops hidden units with ``dropout_p`` from the counter hash
    of ``seed`` -> (N, D) in x's dtype.  Differentiable in every tensor
    argument.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.  The kernels take D <= 64 and D, F multiples of 4."""
    return _FusedBlockTail.apply(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                                 float(dropout_p), int(seed))


fused_block_tail.launches = 0
fused_block_tail_bwd.launches = 0
