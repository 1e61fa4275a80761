"""DARE sequence encoder.

Port of ``tossctr_tpu/models/dare.py`` with the lane-fused (V, 2D)
sequence table (``emb_tables``: the att half scores, the rep half
represents): dense top-k selection, ``pad_topk`` to the 8-row tile, the
fused encoder layers, softmax or relu gating, the dropout on ``u_seq``
and the aux head.  The reference-shaped split tables wait for a later
slice.

The table never takes a gradient.  A training pass given a ``taps`` dict
records the selected ids and makes the gathered, pad-masked (B, K, 2D)
rows a leaf of the autograd graph (the JAX package's
``perturb("table_rows")``): the trainer reads the rows' gradient there
and updates the touched table rows itself (``train/sparse_embed.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.topk_select import dare_select_ids, log_decay_at
from .layers import DAREEncoderLayer, Dense, DropoutRNG


class DARE(nn.Module):
    def __init__(self, seq_vocab: int, emb_dim: int, *, top_k: int = 80,
                 recency_tau: float = 256.0, pad_id: int = 0, pad_topk: bool = True,
                 transformer_block: bool = True, n_layers: int = 2, n_heads: int = 4,
                 ffn_hidden: int = 256, gating: str = "softmax",
                 add_positional_bias: bool = True, table_dtype=torch.float32,
                 dropout: float = 0.0, mha_dropout: float = 0.0, ffn_dropout: float = 0.0):
        super().__init__()
        if gating not in ("softmax", "relu"):
            raise ValueError(f"gating must be softmax|relu, got {gating!r}")
        self.emb_dim = emb_dim
        self.top_k = top_k
        self.recency_tau = float(recency_tau)
        self.pad_id = pad_id
        self.pad_topk = pad_topk
        self.gating = gating
        self.dropout = float(dropout)
        self.n_layers = n_layers if transformer_block else 0
        self.emb_tables = nn.Parameter(
            torch.empty(seq_vocab, 2 * emb_dim, dtype=table_dtype), requires_grad=False
        )
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", DAREEncoderLayer(
                emb_dim, n_heads, ffn_hidden, mha_dropout=mha_dropout, ffn_dropout=ffn_dropout,
                add_pos_bias=add_positional_bias, max_len=top_k,
            ))
        self.aux_head = Dense(emb_dim, 1)

    def forward(self, seq_ids, query_vec, dtype, rng: Optional[DropoutRNG] = None,
                taps: Optional[dict] = None):
        """seq_ids (B, L) int, query_vec (B, D) -> (u_seq (B, D), aux_logit (B,)).
        ``rng``: train (dropout on); ``taps``: receives ``sel_ids`` (B, K)
        and the rows leaf ``table_rows`` (B, K, 2D)."""
        D = self.emb_dim
        L = seq_ids.shape[1]
        query = query_vec.to(dtype)
        idx, sel_ids, _ = dare_select_ids(
            self.emb_tables[:, :D], seq_ids, query,
            top_k=self.top_k, tau=self.recency_tau, pad_id=self.pad_id,
        )
        K_logical = sel_ids.shape[1]
        if self.pad_topk:
            # appended slots carry pad_id: -1e9 score, zero rows, zero
            # gating weight, masked key columns -- u_seq is unchanged
            K_pad = -(-K_logical // 8) * 8
            if K_pad != K_logical:
                sel_ids = nn.functional.pad(sel_ids, (0, K_pad - K_logical), value=self.pad_id)
                idx = nn.functional.pad(idx, (0, K_pad - K_logical))
        sel_nonpad = (sel_ids != self.pad_id).to(dtype)[..., None]
        rows = self.emb_tables[sel_ids].to(dtype) * sel_nonpad  # one (B, K, 2D) gather
        if taps is not None:
            rows = rows.detach().requires_grad_()
            taps["sel_ids"] = sel_ids
            taps["table_rows"] = rows
        att_sel, sel_rep = rows[..., :D], rows[..., D:]
        vals = torch.bmm(att_sel, query[:, :, None])[..., 0]
        vals = vals + log_decay_at(idx, L, self.recency_tau, dtype)
        vals = torch.where(sel_ids == self.pad_id, torch.full_like(vals, -1e9), vals)

        x = sel_rep.contiguous()
        valid_k = K_logical if sel_ids.shape[1] != K_logical else None
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid_k=valid_k, rng=rng)

        if self.gating == "relu":
            w = torch.relu(vals)
            w = w / (w.sum(dim=1, keepdim=True) + 1e-12)
        else:
            w = torch.softmax(vals.float(), dim=1).to(dtype)
        u_seq = (x * w[..., None]).sum(dim=1)
        if rng is not None:
            u_seq = rng.dropout(u_seq, self.dropout)
        aux_logit = self.aux_head(u_seq, dtype)[:, 0]
        return u_seq, aux_logit
