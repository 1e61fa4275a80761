"""The encoder layer's FFN kernels: the fused block tail (out-projection,
residual, RMSNorm, GELU FFN with hidden dropout, residual, RMSNorm) and
the FFN alone (GELU FFN with hidden dropout).

Port of ``tossctr_tpu/ops/pallas_ffn.py``:

* ``fused_block_tail``: the forward (``_tail_fwd_call``) and its backward
  (``_tail_bwd_call``); kernels ``csrc/fused_block_tail.cu`` and
  ``csrc/fused_block_tail_bwd.cu`` (bf16 on the tensor cores with the
  stages of ``csrc/ffn_mma.cuh``; fp32 exact on the CUDA cores), plain
  versions ``fused_block_tail_reference`` /
  ``fused_block_tail_bwd_reference``.  The RMSNorm encoder layer with
  both kernel flags runs it.
* ``fused_ffn``: drop(gelu_tanh(x W1 + b1)) W2 + b2, the forward
  (``_fwd_call``) and its backward (``_bwd_call``); kernels
  ``csrc/fused_ffn.cu`` and ``csrc/fused_ffn_bwd.cu`` (bf16 on the tensor
  cores, ``csrc/ffn_mma.cuh``; fp32 exact on the CUDA cores), plain
  versions ``fused_ffn_reference`` / ``fused_ffn_bwd_reference``.  The
  encoder layer's separate-kernel branch (LayerNorm, or ``fuse_block``
  off) runs it.

Both drop hidden units with the counter-hash mask of the absolute row
(``ops/dropout.py`` ``ffn_keep``).  The plain versions keep the Pallas
kernels' rounding points; they run for CPU tensors and check the kernels
on the card.  Both public functions are differentiable: their backwards
are the backward kernels.
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


def _check(x, dropout_p, **named):
    """x (N, D) in float32 or bfloat16, dropout_p in [0, 1), and each named
    tensor of the FFN kernels on x's device with its shape and dtype: the
    activations and weights in x's dtype, biases and norm weights fp32,
    F the width of w1 (D, F)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x dtype must be float32 or bfloat16, got {x.dtype}")
    w1 = named["w1"]
    if w1.dim() != 2 or w1.shape[0] != D:
        raise ValueError(f"w1 must be (D={D}, F), got {tuple(w1.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    F = w1.shape[1]
    dt, f32 = x.dtype, torch.float32
    want = {"o": ((N, D), dt), "wout": ((D, D), dt), "bout": ((D,), f32), "wn1": ((D,), f32),
            "w1": ((D, F), dt), "b1": ((F,), f32), "w2": ((F, D), dt), "b2": ((D,), f32),
            "wn2": ((D,), f32)}
    for name, t in named.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _cuda_args(name, args, w1):
    """Refuse what the kernels do not take: a CPU tensor, non-contiguous
    inputs, D > 64, D or F (w1 is (D, F)) not a multiple of 4."""
    if args[0].device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {args[0].device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    D, F = w1.shape
    if D > 64 or D % 4 or F % 4:
        raise ValueError(f"{name} kernel takes D <= 64, D and F % 4 == 0; got D={D} F={F}")


def fused_block_tail_fwd(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                         dropout_p: float = 0.0, seed: int = 0):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    args = (x, o, wout, bout, wn1, w1, b1, w2, b2, wn2)
    _check(x, dropout_p, o=o, wout=wout, bout=bout, wn1=wn1, w1=w1, b1=b1, w2=w2, b2=b2,
           wn2=wn2)
    if x.device.type == "cpu":
        return fused_block_tail_reference(*args, dropout_p, seed)
    _cuda_args("fused_block_tail", args, w1)
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
                         dropout_p: float = 0.0, seed: int = 0, blocks=None):
    """-> (dx, do, dwout, dbout, dwn1, dw1, db1, dw2, db2, dwn2), the last
    eight fp32 sums over the rows: the kernel on a CUDA tensor (per-block
    fp32 partials reduced in a fixed order, so the result repeats bit for
    bit), the plain version on a CPU tensor.  ``blocks``: the persistent
    grid (default one block an SM); dx and do do not depend on it, the
    weight gradients' partials regroup."""
    args = (x, o, wout, bout, wn1, w1, b1, w2, b2, wn2)
    _check(x, dropout_p, o=o, wout=wout, bout=bout, wn1=wn1, w1=w1, b1=b1, w2=w2, b2=b2,
           wn2=wn2)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} {dy.device}")
    if x.device.type == "cpu":
        return fused_block_tail_bwd_reference(*args, dy, dropout_p, seed)
    _cuda_args("fused_block_tail_bwd", args + (dy,), w1)
    N, D = x.shape
    F = w1.shape[1]
    lib = load_library("fused_block_tail_bwd")
    blocks = persistent_blocks(x, blocks=blocks)
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


# ---- fused_ffn: drop(gelu_tanh(x W1 + b1)) W2 + b2 ----


def _ffn_hidden(x, w1, b1, dropout_p, seed):
    """-> (h fp32, the dropped GELU output fp32, keep or None)
    (pallas_ffn._hidden)."""
    h = x.float() @ w1.float() + b1.float()
    g = gelu_tanh(h)
    keep = None
    if dropout_p > 0.0:
        keep = ffn_keep(x.shape[0], w1.shape[1], dropout_p, seed, device=x.device)
        g = g * keep
    return h, g, keep


def fused_ffn_reference(x, w1, b1, w2, b2, dropout_p: float = 0.0, seed: int = 0):
    """x (N, D); w1 (D, F), w2 (F, D) in x's dtype; b1, b2 fp32.  h, GELU
    and the dropout product are fp32 from the inputs' values; the dropped
    GELU output is rounded to x's dtype before the W2 product; the output
    is x's dtype (pallas_ffn.py:110-138)."""
    _, gd, _ = _ffn_hidden(x, w1, b1, dropout_p, seed)
    return (gd.to(x.dtype).float() @ w2.float() + b2.float()).to(x.dtype)


def fused_ffn_bwd_reference(x, w1, b1, w2, dy, dropout_p: float = 0.0, seed: int = 0):
    """Gradients of ``fused_ffn_reference`` with the rounding points of the
    Pallas backward (pallas_ffn.py:141-199): h and the dropped GELU output
    recomputed, the latter rounded for dW2; dh rounded to x's dtype (dhc)
    before the dW1 and dx products; db1 sums the unrounded dh.  -> (dx in
    x's dtype; dw1 (D, F), db1 (F,), dw2 (F, D), db2 (D,) fp32 sums over
    the rows)."""
    dt = x.dtype
    h, gd, keep = _ffn_hidden(x, w1, b1, dropout_p, seed)
    dyf = dy.float()
    dw2 = gd.to(dt).float().t() @ dyf
    dgd = dyf @ w2.float().t()
    if keep is not None:
        dgd = dgd * keep
    dh = dgd * gelu_tanh_grad(h)
    dhc = dh.to(dt).float()
    dw1 = x.float().t() @ dhc
    dx = (dhc @ w1.float().t()).to(dt)
    return dx, dw1, dh.sum(dim=0), dw2, dyf.sum(dim=0)


def fused_ffn_fwd(x, w1, b1, w2, b2, dropout_p: float = 0.0, seed: int = 0):
    """The forward alone (no autograd): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    args = (x, w1, b1, w2, b2)
    _check(x, dropout_p, w1=w1, b1=b1, w2=w2, b2=b2)
    if x.device.type == "cpu":
        return fused_ffn_reference(*args, dropout_p, seed)
    _cuda_args("fused_ffn", args, w1)
    N, D = x.shape
    y = torch.empty_like(x)
    lib = load_library("fused_ffn")
    rc = lib.tossctr_fused_ffn_fwd(
        *(t.data_ptr() for t in args), y.data_ptr(), N, D, w1.shape[1],
        *kernel_args(dropout_p, seed), DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_ffn")
    fused_ffn.launches += 1
    return y


def fused_ffn_bwd(x, w1, b1, w2, dy, dropout_p: float = 0.0, seed: int = 0, blocks=None):
    """-> (dx, dw1, db1, dw2, db2), the last four fp32 sums over the rows:
    the kernel on a CUDA tensor (per-block fp32 partials reduced in a
    fixed order, so the result repeats bit for bit), the plain version on
    a CPU tensor.  ``blocks``: the persistent grid (default one block an
    SM); dx does not depend on it, the weight gradients' partials
    regroup."""
    args = (x, w1, b1, w2)
    _check(x, dropout_p, w1=w1, b1=b1, w2=w2)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} {dy.device}")
    if x.device.type == "cpu":
        return fused_ffn_bwd_reference(*args, dy, dropout_p, seed)
    _cuda_args("fused_ffn_bwd", args + (dy,), w1)
    N, D = x.shape
    F = w1.shape[1]
    lib = load_library("fused_ffn_bwd")
    blocks = persistent_blocks(x, blocks=blocks)
    sizes = [D * F, F, F * D, D]  # dw1 db1 dw2 db2
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    partials = torch.empty(blocks, sum(sizes), **f32)
    grads = torch.empty(sum(sizes), **f32)
    rc = lib.tossctr_fused_ffn_bwd(
        *(t.data_ptr() for t in args), dy.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        grads.data_ptr(), blocks, N, D, F,
        *kernel_args(dropout_p, seed), DTYPE_CODES[x.dtype], x.device.index, stream_of(x),
    )
    check_launch(lib, rc, "fused_ffn_bwd")
    fused_ffn_bwd.launches += 1
    dw1, db1, dw2, db2 = grads.split(sizes)
    return dx, dw1.view(D, F), db1, dw2.view(F, D), db2


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dropout_p, seed):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.cfg = (dropout_p, seed)
        return fused_ffn_fwd(x, w1, b1, w2, b2, dropout_p, seed)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ffn_bwd(x, w1, b1, w2, dy.contiguous(), *ctx.cfg)
        # dW in the weights' dtypes and db in b1's, as the Pallas custom_vjp
        # returns them (pallas_ffn.py:306-315): on the model path the
        # weights arrive as compute-dtype casts, so dW is rounded there
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b1.dtype),
                None, None)


def fused_ffn(x, w1, b1, w2, b2, dropout_p: float = 0.0, seed: int = 0):
    """drop(gelu_tanh(x @ w1 + b1)) @ w2 + b2, the hidden units dropped with
    ``dropout_p`` from the counter hash of ``seed`` and the absolute row
    -> (N, D) in x's dtype.  Differentiable in x, w1, b1, w2 and b2.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.  The kernels take D <= 64 and D, F multiples of 4."""
    return _FusedFFN.apply(x, w1, b1, w2, b2, float(dropout_p), int(seed))


fused_ffn.launches = 0
fused_ffn_bwd.launches = 0
