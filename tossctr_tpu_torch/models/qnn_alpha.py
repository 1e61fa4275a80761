"""QNN-alpha feature-interaction head.

Port of ``tossctr_tpu/models/qnn_alpha.py``: over the (B, F, D) token
stack, RMSNorm over the flattened F*D features (the flax auto-named
``RMSNorm_0``), multi-head low-rank FM crosses (per block of features
with ``pair_grouping: block``; else through the FM-cross kernels with
``use_pallas`` when F % 8 == 0, the JAX package's rule; else the plain
einsum path), squeeze-excite with the
batch-mean quirk, then an MLP over [flattened base | interactions], with
dropout on the interactions and after each hidden layer when training.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.fm_cross import fm_cross_blocked, fm_cross_multihead, fm_cross_pallas
from .layers import Dense, DropoutRNG, RMSNorm, SEBlock


class QNNAlpha(nn.Module):
    def __init__(self, in_feat: int, emb_dim: int, *, heads: int = 8, rank: int = 32,
                 proj_dim: int = 256, mlp_hidden: Sequence[int] = (512, 256),
                 dropout: float = 0.1, use_se: bool = True, se_reduction: int = 8,
                 se_batch_stats: bool = True, use_residual: bool = True,
                 pair_grouping: str = "all", block_slices: Optional[Dict[str, Tuple[int, int]]] = None,
                 use_pallas: bool = False):
        super().__init__()
        self.in_feat, self.emb_dim = in_feat, emb_dim
        self.pair_grouping = pair_grouping
        self.use_pallas = bool(use_pallas)
        self.dropout = float(dropout)
        self.use_residual = use_residual
        self.block_slices = dict(block_slices or {})
        self.RMSNorm_0 = RMSNorm(in_feat * emb_dim)
        self.U = nn.Parameter(torch.empty(heads, emb_dim, rank))
        self.V = nn.Parameter(torch.empty(heads, rank, proj_dim))
        self.se = SEBlock(heads * proj_dim, se_reduction, se_batch_stats) if use_se else None
        dims = [in_feat * emb_dim + heads * proj_dim, *mlp_hidden]
        self.n_mlp = len(mlp_hidden)
        for i in range(self.n_mlp):
            self.add_module(f"mlp_{i}", Dense(dims[i], dims[i + 1]))
        self.mlp_out = Dense(dims[-1], 1)

    def forward(self, feats, dtype, rng: Optional[DropoutRNG] = None):  # (B, F, D) -> (B,)
        B, F, D = feats.shape
        if (F, D) != (self.in_feat, self.emb_dim):
            raise ValueError(f"QNNAlpha expects (B, {self.in_feat}, {self.emb_dim}), got {tuple(feats.shape)}")
        z = self.RMSNorm_0(feats.reshape(B, F * D), dtype).reshape(B, F, D)
        U, V = self.U.to(dtype), self.V.to(dtype)
        if self.pair_grouping == "block" and self.block_slices:
            inter = fm_cross_blocked(z, U, V, self.block_slices)
        elif self.use_pallas and F % 8 == 0:
            inter = fm_cross_pallas(z.contiguous(), U.contiguous(), V.contiguous())
        else:
            inter = fm_cross_multihead(z, U, V)
        if self.se is not None:
            inter = self.se(inter)
        if rng is not None:
            inter = rng.dropout(inter, self.dropout)
        base = z.reshape(B, F * D)
        if not self.use_residual:  # the base features pass no gradient back
            base = base.detach()
        out = torch.cat([base, inter], dim=1)
        for i in range(self.n_mlp):
            out = torch.relu(getattr(self, f"mlp_{i}")(out, dtype))
            if rng is not None:
                out = rng.dropout(out, self.dropout)
        return self.mlp_out(out, dtype)[:, 0]
