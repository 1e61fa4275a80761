"""DARE sequence encoder.

Port of ``tossctr_tpu/models/dare.py``: top-k selection (dense, streaming
with ``select_chunk`` or the proxy prefilter with ``select_proxy_*``),
``pad_topk`` to the 8-row tile, the encoder layers (RMSNorm or LayerNorm, kernel or
plain paths), softmax or relu gating, the dropout on ``u_seq`` and the
aux head.  The sequence tables come in the JAX package's two layouts: the
lane-fused (V, 2D) ``emb_tables`` (``model.fused_seq_tables``, the
default: the att half scores, the rep half represents), or the
reference-shaped pair of (V, D) tables ``emb_att`` (scores) and
``emb_rep`` (represents).

With ``sparse_tables`` (the sparse-table train modes) the tables take no
gradient.  A training pass given a ``taps`` dict records the selected ids
and makes the gathered, pad-masked rows leaves of the autograd graph (the
JAX package's ``perturb``): ``table_rows`` (B, K, 2D) of the fused table,
or ``att_rows`` and ``rep_rows`` (B, K, D) of the split pair; the trainer
reads their gradients there and updates the touched table rows itself
(``train/sparse_embed.py``).  Without it (the dense-mode table
optimizers) the tables are trainable parameters whose gradient flows
through the gathers.
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
                 dropout: float = 0.0, mha_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 norm: str = "rms", use_pallas_attn: bool = True, use_pallas_ffn: bool = True,
                 fused_tables: bool = True, sparse_tables: bool = True,
                 select_chunk: Optional[int] = None, select_proxy_block: int = 64,
                 select_proxy_candidates: int = 0):
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
        self.fused_tables = fused_tables
        self.select_chunk = select_chunk
        # 0 candidates: no proxy prefilter
        self.select_proxy = ({"block": int(select_proxy_block),
                              "candidates": int(select_proxy_candidates)}
                             if select_proxy_candidates else None)
        shapes = ({"emb_tables": 2 * emb_dim} if fused_tables else
                  {"emb_att": emb_dim, "emb_rep": emb_dim})
        for name, width in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(seq_vocab, width, dtype=table_dtype), requires_grad=not sparse_tables))
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", DAREEncoderLayer(
                emb_dim, n_heads, ffn_hidden, mha_dropout=mha_dropout, ffn_dropout=ffn_dropout,
                norm=norm, add_pos_bias=add_positional_bias, max_len=top_k,
                use_pallas_attn=use_pallas_attn, use_pallas_ffn=use_pallas_ffn,
            ))
        self.aux_head = Dense(emb_dim, 1)

    def forward(self, seq_ids, query_vec, dtype, rng: Optional[DropoutRNG] = None,
                taps: Optional[dict] = None):
        """seq_ids (B, L) int, query_vec (B, D) -> (u_seq (B, D), aux_logit (B,)).
        ``rng``: train (dropout on); ``taps``: receives ``sel_ids`` (B, K)
        and the rows leaves, ``table_rows`` (B, K, 2D) or ``att_rows`` and
        ``rep_rows`` (B, K, D)."""
        D = self.emb_dim
        L = seq_ids.shape[1]
        query = query_vec.to(dtype)
        # every pass (the proxy's block means among them) reads the att
        # half of the fused table, as the JAX package's att_lookup does
        idx, sel_ids, _ = dare_select_ids(
            self.emb_tables[:, :D] if self.fused_tables else self.emb_att, seq_ids, query,
            top_k=self.top_k, tau=self.recency_tau, pad_id=self.pad_id,
            select_chunk=self.select_chunk, select_proxy=self.select_proxy,
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

        def gathered(table, tap):
            # a trainable table's gradient through embedding's backward
            rows = nn.functional.embedding(sel_ids, table).to(dtype) * sel_nonpad
            if taps is not None:
                rows = rows.detach().requires_grad_()
                taps[tap] = rows
            return rows

        if taps is not None:
            taps["sel_ids"] = sel_ids
        if self.fused_tables:
            rows = gathered(self.emb_tables, "table_rows")  # one (B, K, 2D) gather
            att_sel, sel_rep = rows[..., :D], rows[..., D:]
        else:
            att_sel = gathered(self.emb_att, "att_rows")
            sel_rep = gathered(self.emb_rep, "rep_rows")
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
