"""Shared building blocks: dense, norms, positional bias, multi-head
self-attention, the DARE encoder layer and squeeze-excite.

Port of ``tossctr_tpu/models/layers.py``.  Parameters keep the flax names
and layouts (``Dense.kernel`` is (in, out)), so a flax parameter tree maps
onto ``state_dict`` keys path for path (see ``convert.py``).  Parameters
are fp32 (the sequence table excepted); each forward casts them to the
compute dtype where the flax module does.

The encoder layer has the JAX module's three paths:

* fused (RMSNorm, both kernel flags, ``fuse_block``): ``fused_mha_qkv``
  then ``fused_block_tail`` (layers.py:288-312);
* separate kernels (LayerNorm, or ``fuse_block`` off): attention through
  ``fused_mha_qkv`` (or ``fused_mha`` with ``fuse_qkv`` off), residual,
  norm, ``fused_ffn``, residual, norm (layers.py:315-346);
* unfused (``use_pallas_attn`` / ``use_pallas_ffn`` off): the attention
  core and the FFN in plain PyTorch.

On a CUDA tensor the kernel paths run the hand-written kernels,
differentiable through their backward kernels.

A forward pass trains when it is given a ``DropoutRNG`` (the JAX
package's ``deterministic=False`` with a ``dropout`` rng stream) and is
deterministic without one.
"""

from __future__ import annotations

from typing import Optional

import os

import torch
from torch import nn

from ..ops.fused_attention import fused_mha, fused_mha_qkv
from ..ops.fused_ffn import fused_block_tail, fused_ffn, rms_norm


class DropoutRNG:
    """The randomness of one training forward pass.

    ``seed()`` draws the int32 seed of one kernel call's counter-hash
    dropout (``layers.dropout_seed``) from a CPU generator, so no draw
    waits on the card.  ``dropout(x, p)`` is flax ``nn.Dropout``:
    ``where(keep, x / (1 - p), 0)`` with ``keep`` drawn by ``bernoulli_``
    from a generator on x's device.  Both generators are seeded with
    ``seed``, which the trainer derives from (train seed, step)."""

    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        self.device = (self.host if device.type == "cpu"
                       else torch.Generator(device=device).manual_seed(int(seed)))

    def seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))

    def dropout(self, x, p: float):
        if p <= 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - p, generator=self.device)
        return torch.where(keep.bool(), x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def kernel_dropout(rng: Optional[DropoutRNG], p: float):
    """-> (effective p, seed) of one kernel call (``layers.dropout_seed``):
    a seed is drawn only when the pass trains and p > 0."""
    if rng is None or p <= 0.0:
        return 0.0, 0
    return float(p), rng.seed()


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (in, out) and bias (out,), fp32; the
    product and the bias add run in the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if use_bias else None

    def forward(self, x, dtype):
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class RMSNorm(nn.Module):
    """w * x * rsqrt(mean(x^2) + 1e-6), fp32 statistics, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.ones(dim))

    def forward(self, x, dtype):
        return rms_norm(x, self.w, self.eps).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """flax ``nn.LayerNorm`` (flax 0.12 ``_compute_stats`` / ``_normalize``):
    fp32 statistics with the fast variance mean(x^2) - mean(x)^2 clipped
    at 0, then (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32.
    ``F.layer_norm`` takes the two-pass variance instead, which rounds
    otherwise."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()


class _LayerNormParams(nn.Module):
    """flax ``nn.LayerNorm``'s parameters: scale (ones) and bias (zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """The repo's LayerNorm, eps 1e-5, output in ``dtype``.  flax's
    ``nn.LayerNorm`` sits inside the JAX package's named wrapper, so its
    parameters live under the auto-named child ``LayerNorm_0``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.LayerNorm_0 = _LayerNormParams(dim)

    def forward(self, x, dtype):
        p = self.LayerNorm_0
        return layer_norm(x, p.scale, p.bias, self.eps).to(dtype)


def make_norm(kind: str, dim: int) -> nn.Module:
    """'rms' -> RMSNorm, anything else LayerNorm (layers.make_norm)."""
    return RMSNorm(dim) if kind.lower() == "rms" else LayerNorm(dim)


class PositionalBias(nn.Module):
    """(2*max_len+1, n_heads) embedding of the clipped distance j-i over
    the K selected tokens -> (H, qlen, klen) in ``dtype``."""

    def __init__(self, max_len: int, n_heads: int):
        super().__init__()
        self.max_len = max_len
        self.rel = nn.Parameter(torch.empty(2 * max_len + 1, n_heads))

    def forward(self, qlen: int, klen: int, dtype):
        dev = self.rel.device
        i = torch.arange(qlen, device=dev)[:, None]
        j = torch.arange(klen, device=dev)[None, :]
        d = (j - i).clamp(-self.max_len, self.max_len) + self.max_len
        return self.rel[d].permute(2, 0, 1).to(dtype)


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention with a packed qkv projection and a (K, K)
    additive bias shared by the heads: softmax(q k^T / sqrt(dh) + bias) v
    with dropout on the probabilities, then the out projection.  The
    parameters (``qkv``, ``out``) are the same in every mode:

    * ``use_pallas`` and ``fuse_qkv``: ``fused_mha_qkv`` (the projection
      inside the kernel);
    * ``use_pallas`` alone: the qkv ``Dense``, a split, ``fused_mha``;
    * neither: the plain einsum path, the softmax in fp32, the dropout
      from ``DropoutRNG`` on the probabilities.

    ``raw_out`` (the JAX module's field, an argument of the call here,
    since the encoder layer picks its branch at each forward) returns the
    attention output before the out projection, with the projection's
    (kernel, bias), for the fused block tail."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0, *,
                 use_pallas: bool = True, fuse_qkv: bool = True):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide by n_heads")
        self.n_heads = n_heads
        self.dropout = float(dropout)
        self.use_pallas, self.fuse_qkv = use_pallas, fuse_qkv
        self.qkv = Dense(d_model, 3 * d_model)
        self.out = Dense(d_model, d_model)

    def forward(self, x, bias, rng: Optional[DropoutRNG] = None, raw_out: bool = False):
        """x (B, K, D); bias (K, K) in x's dtype -> (B, K, D), or with
        ``raw_out`` (o, out kernel, out bias)."""
        B, K, D = x.shape
        dt, H = x.dtype, self.n_heads
        if raw_out and not (self.use_pallas and self.fuse_qkv):
            raise ValueError("raw_out requires the fused-qkv kernel path")
        if self.use_pallas and self.fuse_qkv:
            o = fused_mha_qkv(x.contiguous(), self.qkv.kernel.to(dt).contiguous(), self.qkv.bias,
                              bias, H, *kernel_dropout(rng, self.dropout))
            if raw_out:
                return o, self.out.kernel, self.out.bias
            return self.out(o, dt)
        q, k, v = self.qkv(x, dt).split(D, dim=-1)
        if self.use_pallas:
            o = fused_mha(q.contiguous(), k.contiguous(), v.contiguous(), bias, H,
                          *kernel_dropout(rng, self.dropout))
        else:
            dh = D // H
            qh, kh, vh = (t.reshape(B, K, H, dh).transpose(1, 2) for t in (q, k, v))
            logits = (qh @ kh.transpose(-1, -2)) / torch.sqrt(
                torch.tensor(float(dh), dtype=dt, device=x.device))
            logits = logits + bias.to(dt)
            w = torch.softmax(logits.float(), dim=-1).to(dt)
            if rng is not None:
                w = rng.dropout(w, self.dropout)
            o = (w @ vh).transpose(1, 2).reshape(B, K, D)
        return self.out(o, dt)


class DAREEncoderLayer(nn.Module):
    """Post-norm transformer block over the K selected tokens: attention
    + residual + norm, GELU FFN + residual + norm, with the head-averaged
    positional bias as one (K, K) additive mask.

    ``norm`` is rms or layer; ``use_pallas_attn`` / ``use_pallas_ffn``
    route the attention core and the FFN through the kernels; with RMSNorm,
    both flags and ``fuse_block`` (None: on unless
    ``TOSSCTR_DISABLE_FUSE_BLOCK=1``, read at each forward) the stretch
    after the attention core is one ``fused_block_tail`` kernel."""

    def __init__(self, d_model: int, n_heads: int, ffn_hidden: int, *,
                 mha_dropout: float = 0.0, ffn_dropout: float = 0.0, norm: str = "rms",
                 add_pos_bias: bool = True, max_len: int = 512, use_pallas_attn: bool = True,
                 use_pallas_ffn: bool = True, fuse_block: Optional[bool] = None):
        super().__init__()
        self.ffn_dropout = float(ffn_dropout)
        self.norm = norm.lower()
        self.use_pallas_attn, self.use_pallas_ffn = use_pallas_attn, use_pallas_ffn
        self.fuse_block = fuse_block
        self.pbias = PositionalBias(max_len, n_heads) if add_pos_bias else None
        self.mha = MultiHeadSelfAttention(d_model, n_heads, mha_dropout,
                                          use_pallas=use_pallas_attn)
        self.norm1 = make_norm(self.norm, d_model)
        self.Dense_0 = Dense(d_model, ffn_hidden)
        self.Dense_1 = Dense(ffn_hidden, d_model)
        self.norm2 = make_norm(self.norm, d_model)

    def attention_bias(self, K: int, valid_k: Optional[int], dtype, device):
        """(K, K) head-shared bias in ``dtype``: the head-averaged positional
        bias, plus -1e9 on key columns >= valid_k (tile padding)."""
        bias2d = None
        if self.pbias is not None:
            bias2d = self.pbias(K, K, dtype).mean(dim=0)  # head-average quirk
        if valid_k is not None and valid_k < K:
            cols = torch.arange(K, device=device) < valid_k
            colmask = torch.where(
                cols, torch.zeros((), dtype=dtype, device=device),
                torch.full((), -1e9, dtype=dtype, device=device),
            )[None, :]
            bias2d = colmask if bias2d is None else bias2d + colmask
        if bias2d is None:
            return torch.zeros(K, K, dtype=dtype, device=device)
        return bias2d.expand(K, K).contiguous()

    def fused_block(self) -> bool:
        """The fused branch: RMSNorm, both kernel flags and ``fuse_block``
        (None: on unless ``TOSSCTR_DISABLE_FUSE_BLOCK=1``, layers.py:260-265)."""
        fuse = self.fuse_block
        if fuse is None:
            fuse = os.environ.get("TOSSCTR_DISABLE_FUSE_BLOCK") != "1"
        return fuse and self.use_pallas_attn and self.use_pallas_ffn and self.norm == "rms"

    def forward(self, x, valid_k: Optional[int] = None, rng: Optional[DropoutRNG] = None):
        B, K, D = x.shape
        dt = x.dtype
        x = x.contiguous()
        bias = self.attention_bias(K, valid_k, dt, x.device)
        if self.fused_block():
            o, wout, bout = self.mha(x, bias, rng, raw_out=True)
            y = fused_block_tail(
                x.reshape(B * K, D), o.reshape(B * K, D), wout.to(dt).contiguous(), bout,
                self.norm1.w,
                self.Dense_0.kernel.to(dt).contiguous(), self.Dense_0.bias,
                self.Dense_1.kernel.to(dt).contiguous(), self.Dense_1.bias, self.norm2.w,
                *kernel_dropout(rng, self.ffn_dropout),
            )
            return y.reshape(B, K, D)

        x = self.norm1(x + self.mha(x, bias, rng), dt)
        if self.use_pallas_ffn:
            h2 = fused_ffn(
                x.reshape(B * K, D).contiguous(), self.Dense_0.kernel.to(dt).contiguous(),
                self.Dense_0.bias, self.Dense_1.kernel.to(dt).contiguous(), self.Dense_1.bias,
                *kernel_dropout(rng, self.ffn_dropout),
            ).reshape(B, K, D)
        else:
            h2 = nn.functional.gelu(self.Dense_0(x, dt), approximate="tanh")
            if rng is not None:
                h2 = rng.dropout(h2, self.ffn_dropout)
            h2 = self.Dense_1(h2, dt)
        return self.norm2(x + h2, dt)


class SEBlock(nn.Module):
    """Squeeze-excite over channels with BATCH-MEAN statistics (a reference
    quirk: the output depends on the rows that share the batch);
    ``batch_stats=False`` gates per row."""

    def __init__(self, channels: int, reduction: int = 8, batch_stats: bool = True):
        super().__init__()
        self.batch_stats = batch_stats
        hidden = max(1, channels // reduction)
        self.Dense_0 = Dense(channels, hidden)
        self.Dense_1 = Dense(hidden, channels)

    def forward(self, x):
        dt = x.dtype
        pooled = x.mean(dim=0, keepdim=True) if self.batch_stats else x
        h = torch.relu(self.Dense_0(pooled, dt))
        return x * torch.sigmoid(self.Dense_1(h, dt))
