"""Shared building blocks: dense, norms, positional bias, the DARE encoder
layer and squeeze-excite.

Port of ``tossctr_tpu/models/layers.py``.  Parameters keep the flax names
and layouts (``Dense.kernel`` is (in, out)), so a flax parameter tree maps
onto ``state_dict`` keys path for path (see ``convert.py``).  Parameters
are fp32 (the sequence table excepted); each forward casts them to the
compute dtype where the flax module does.

The encoder layer runs its fused RMSNorm path only: ``fused_mha_qkv``
then ``fused_block_tail`` (layers.py:288-312), the hand-written kernels
on a CUDA tensor, differentiable through their backward kernels.  The
unfused and LayerNorm paths wait for a later slice
(``models/ctr_model.build_model`` refuses configs that ask for them).

A forward pass trains when it is given a ``DropoutRNG`` (the JAX
package's ``deterministic=False`` with a ``dropout`` rng stream) and is
deterministic without one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_attention import fused_mha_qkv
from ..ops.fused_ffn import fused_block_tail, rms_norm


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


class FusedMHAParams(nn.Module):
    """The ``mha`` scope of the fused path: qkv (D, 3D) and out (D, D)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.qkv = Dense(d_model, 3 * d_model)
        self.out = Dense(d_model, d_model)


class DAREEncoderLayer(nn.Module):
    """Post-norm transformer block over the K selected tokens: attention
    + residual + RMSNorm, GELU FFN + residual + RMSNorm, with the
    head-averaged positional bias as one (K, K) additive mask."""

    def __init__(self, d_model: int, n_heads: int, ffn_hidden: int, *,
                 mha_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 add_pos_bias: bool = True, max_len: int = 512):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide by n_heads")
        self.n_heads = n_heads
        self.mha_dropout = float(mha_dropout)
        self.ffn_dropout = float(ffn_dropout)
        self.pbias = PositionalBias(max_len, n_heads) if add_pos_bias else None
        self.mha = FusedMHAParams(d_model)
        self.norm1 = RMSNorm(d_model)
        self.Dense_0 = Dense(d_model, ffn_hidden)
        self.Dense_1 = Dense(ffn_hidden, d_model)
        self.norm2 = RMSNorm(d_model)

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

    def forward(self, x, valid_k: Optional[int] = None, rng: Optional[DropoutRNG] = None):
        B, K, D = x.shape
        dt = x.dtype
        x = x.contiguous()
        bias = self.attention_bias(K, valid_k, dt, x.device)
        o = fused_mha_qkv(
            x, self.mha.qkv.kernel.to(dt).contiguous(), self.mha.qkv.bias, bias,
            self.n_heads, *kernel_dropout(rng, self.mha_dropout),
        )
        y = fused_block_tail(
            x.reshape(B * K, D), o.reshape(B * K, D),
            self.mha.out.kernel.to(dt).contiguous(), self.mha.out.bias, self.norm1.w,
            self.Dense_0.kernel.to(dt).contiguous(), self.Dense_0.bias,
            self.Dense_1.kernel.to(dt).contiguous(), self.Dense_1.bias, self.norm2.w,
            *kernel_dropout(rng, self.ffn_dropout),
        )
        return y.reshape(B, K, D)


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
