"""CTRModel: full model assembly.

Port of ``tossctr_tpu/models/ctr_model.py``: width-grouped categorical
embeddings, numeric / mask feature embeddings, the context vector and
the S1 / S2 / concat query, the DARE sequence encoder, and the QNN-alpha
head or the fallback MLP head.  Returns ``(logits, sigmoid(logits),
aux_logit)`` in fp32.  ``build_model`` (the counterpart of
``tossctr_tpu/train/trainer.py`` ``build_model``) and the seeded
``init_params`` live here too, since serving needs them without a
trainer.

``CTRModel.forward(batch, rng=None, taps=None)``: without ``rng`` the
pass is deterministic (serving, evaluation); with a ``layers.DropoutRNG``
it trains, with every dropout of the config (``model.embedding_dropout``
on the QNN's categorical stack, the encoder kernels' ``mha_dropout`` and
``ffn_dropout``, ``model.dare_dropout`` on ``u_seq``, the QNN's dropouts,
0.1 in the fallback MLP head).  ``taps``: see ``dare.DARE``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .dare import DARE
from .feature_embed import BinaryFeatureEmbedding, NumericFeatureEmbedding
from .layers import Dense, DropoutRNG
from .qnn_alpha import QNNAlpha


@dataclass(frozen=True)
class CatGroup:
    d_in: int
    cols: Tuple[str, ...]
    col_idx: Tuple[int, ...]  # positions in X_cat
    cards: Tuple[int, ...]  # cardinalities (bucket + margin)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for c in self.cards:
            out.append(acc)
            acc += c
        return tuple(out)

    @property
    def total_rows(self) -> int:
        return int(sum(self.cards))


@dataclass(frozen=True)
class ModelSpec:
    """Static model configuration resolved from (Config, cache dims)."""

    emb_dim: int
    f_embed: int
    num_dim: int
    mask_dim: int
    cat_cols: Tuple[str, ...]
    cat_groups: Tuple[CatGroup, ...]
    seq_vocab: int
    top_k: int
    recency_tau: float
    pad_id: int
    query_mode: str
    query_key: str
    transformer_block: bool
    tfm_n_layers: int
    tfm_n_heads: int
    tfm_ffn_hidden: int
    tfm_gating: str
    tfm_add_pos_bias: bool
    qnn_enabled: bool
    tfm_mha_dropout: float = 0.0
    tfm_ffn_dropout: float = 0.0
    dare_dropout: float = 0.0
    embedding_dropout: float = 0.0
    pad_topk: bool = True
    table_dtype: str = "float32"
    qnn: Dict[str, Any] = field(default_factory=dict)
    block_slices: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def n_feat(self) -> int:
        return 1 + self.num_dim + self.mask_dim + len(self.cat_cols)


def build_model_spec(cfg, dims: Dict[str, int]) -> ModelSpec:
    """cfg: Config; dims: ShardCache.dims."""
    D = cfg.model.emb_dim
    qa = cfg.model.qnn_alpha
    cat_cols = tuple(cfg.data.cat_cols)
    dims_map = cfg.model.cat_embedding_dims or {}
    by_width: Dict[int, List[int]] = {}
    for i, c in enumerate(cat_cols):
        by_width.setdefault(int(dims_map.get(c, D)), []).append(i)
    groups = tuple(
        CatGroup(
            d_in=w,
            cols=tuple(cat_cols[i] for i in idxs),
            col_idx=tuple(idxs),
            cards=tuple(cfg.data.bucket_for(cat_cols[i]) for i in idxs),
        )
        for w, idxs in sorted(by_width.items())
    )
    num_dim, mask_dim = int(dims["X_num"]), int(dims["X_mask"])
    block: Dict[str, Tuple[int, int]] = {"seq": (0, 1)}
    ofs = 1
    if num_dim > 0:
        block["num"] = (ofs, ofs + num_dim)
        ofs += num_dim
    if mask_dim > 0:
        block["mask"] = (ofs, ofs + mask_dim)
        ofs += mask_dim
    block["cat"] = (ofs, ofs + len(cat_cols))
    s = cfg.sequence
    return ModelSpec(
        emb_dim=D,
        f_embed=int(qa.feature_embed_dim or max(8, D // 4)),
        num_dim=num_dim,
        mask_dim=mask_dim,
        cat_cols=cat_cols,
        cat_groups=groups,
        seq_vocab=int(cfg.model.seq_vocab),
        top_k=int(s.top_k),
        recency_tau=float(s.recency_tau),
        pad_id=int(s.pad_id),
        query_mode=s.query_mode,
        query_key=s.query_key,
        transformer_block=bool(s.transformer_block),
        tfm_n_layers=int(s.tfm.n_layers),
        tfm_n_heads=int(s.tfm.n_heads),
        tfm_ffn_hidden=int(s.tfm.ffn_hidden),
        tfm_gating=s.tfm.gating,
        tfm_add_pos_bias=bool(s.tfm.add_positional_bias),
        qnn_enabled=bool(qa.enabled),
        tfm_mha_dropout=float(s.tfm.mha_dropout),
        tfm_ffn_dropout=float(s.tfm.ffn_dropout),
        dare_dropout=float(cfg.model.dare_dropout),
        embedding_dropout=float(cfg.model.embedding_dropout),
        pad_topk=bool(s.pad_topk_to_tile),
        table_dtype=str(cfg.model.table_dtype),
        qnn=dict(
            heads=int(qa.heads),
            rank=int(qa.rank),
            proj_dim=int(qa.proj_dim),
            mlp_hidden=tuple(qa.mlp_hidden),
            dropout=float(qa.dropout),
            use_residual=bool(qa.use_residual),
            use_se=bool(qa.use_se),
            se_reduction=int(qa.se_reduction),
            pair_grouping=qa.pair_grouping,
        ),
        block_slices=block,
    )


class GroupedCatEmbedding(nn.Module):
    """Width-grouped categorical embeddings: one flat table ``table_{d}``
    and one stacked projection ``proj_{d}`` per distinct width ->
    (B, Fc, D) in the original column order."""

    def __init__(self, groups: Tuple[CatGroup, ...], out_dim: int):
        super().__init__()
        self.groups = groups
        for g in groups:
            self.register_parameter(
                f"table_{g.d_in}", nn.Parameter(torch.empty(g.total_rows, g.d_in))
            )
            self.register_parameter(
                f"proj_{g.d_in}", nn.Parameter(torch.empty(len(g.col_idx), g.d_in, out_dim))
            )
        order = [i for g in groups for i in g.col_idx]
        inv = np.empty(len(order), np.int64)
        inv[np.array(order, np.int64)] = np.arange(len(order))
        self.register_buffer("inv_order", torch.tensor(inv.tolist()), persistent=False)
        for g in groups:
            self.register_buffer(f"cols_{g.d_in}", torch.tensor(g.col_idx), persistent=False)
            self.register_buffer(f"offsets_{g.d_in}", torch.tensor(g.offsets), persistent=False)

    def forward(self, X_cat, dtype):  # (B, Fc) int -> (B, Fc, D)
        parts = []
        for g in self.groups:
            d = g.d_in
            ids = X_cat[:, getattr(self, f"cols_{d}")] + getattr(self, f"offsets_{d}")[None, :]
            e = getattr(self, f"table_{d}")[ids].to(dtype)  # (B, n_g, d_in)
            parts.append(torch.einsum("bgd,gdo->bgo", e, getattr(self, f"proj_{d}").to(dtype)))
        return torch.cat(parts, dim=1)[:, self.inv_order, :]


class CTRModel(nn.Module):
    def __init__(self, spec: ModelSpec, dtype=torch.float32, *, se_batch_stats: bool = True,
                 use_pallas_fm: bool = False):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        sp, D = spec, spec.emb_dim
        self.num_embed = (NumericFeatureEmbedding(sp.num_dim, sp.f_embed, D)
                          if sp.num_dim > 0 else None)
        self.mask_embed = (BinaryFeatureEmbedding(sp.mask_dim, sp.f_embed, D)
                           if sp.mask_dim > 0 else None)
        self.cat_embed = GroupedCatEmbedding(sp.cat_groups, D) if sp.cat_cols else None
        n_ctx = (sp.num_dim > 0) + (sp.mask_dim > 0) + 1
        self.ctx_mlp = Dense(n_ctx * D, D) if sp.query_mode in ("S2", "concat") else None
        self.dare = DARE(
            sp.seq_vocab, D, top_k=sp.top_k, recency_tau=sp.recency_tau,
            pad_id=sp.pad_id, pad_topk=sp.pad_topk,
            transformer_block=sp.transformer_block, n_layers=sp.tfm_n_layers,
            n_heads=sp.tfm_n_heads, ffn_hidden=sp.tfm_ffn_hidden,
            gating=sp.tfm_gating, add_positional_bias=sp.tfm_add_pos_bias,
            table_dtype=torch.bfloat16 if sp.table_dtype == "bfloat16" else torch.float32,
            dropout=sp.dare_dropout, mha_dropout=sp.tfm_mha_dropout,
            ffn_dropout=sp.tfm_ffn_dropout,
        )
        if sp.qnn_enabled:
            self.qnn = QNNAlpha(sp.n_feat, D, se_batch_stats=se_batch_stats,
                                block_slices=sp.block_slices, use_pallas=use_pallas_fm,
                                **sp.qnn)
        else:
            feats = D * (1 + (sp.num_dim > 0) + (sp.mask_dim > 0) + len(sp.cat_cols))
            self.fc_0 = Dense(feats, 512)
            self.fc_1 = Dense(512, 1)

    def forward(self, batch: Dict[str, torch.Tensor], rng: Optional[DropoutRNG] = None,
                taps: Optional[dict] = None):
        sp, dt = self.spec, self.dtype
        X_num = batch["X_num"].to(dt)
        X_mask = batch["X_mask"].to(dt)
        num_e = self.num_embed(X_num, dt) if self.num_embed is not None else None
        mask_e = self.mask_embed(X_mask, dt) if self.mask_embed is not None else None
        cat_e = self.cat_embed(batch["X_cat"], dt) if self.cat_embed is not None else None

        ctx_parts = [e.mean(dim=1) for e in (num_e, mask_e) if e is not None]
        ctx_parts.append(cat_e.mean(dim=1) if cat_e is not None
                         else torch.zeros(X_num.shape[0], sp.emb_dim, dtype=dt,
                                          device=X_num.device))
        if sp.query_mode == "S1":
            query = cat_e[:, sp.cat_cols.index(sp.query_key), :]
        else:
            s2 = torch.relu(self.ctx_mlp(torch.cat(ctx_parts, dim=1), dt))
            if sp.query_mode == "S2":
                query = s2
            else:  # concat = 0.5 * (S1 + S2)
                query = 0.5 * (cat_e[:, sp.cat_cols.index(sp.query_key), :] + s2)

        u_seq, aux_logit = self.dare(batch["seq"], query, dt, rng=rng, taps=taps)

        if sp.qnn_enabled:
            # the categorical stack is dropped after the query used it
            cat_stack = (rng.dropout(cat_e, sp.embedding_dropout)
                         if rng is not None and cat_e is not None else cat_e)
            feats = [u_seq[:, None, :]] + [e for e in (num_e, mask_e, cat_stack) if e is not None]
            logits = self.qnn(torch.cat(feats, dim=1), dt, rng=rng)
        else:
            feats = [u_seq] + [e.mean(dim=1) for e in (num_e, mask_e) if e is not None]
            if cat_e is not None:
                feats += list(cat_e.unbind(dim=1))
            h = torch.relu(self.fc_0(torch.cat(feats, dim=1), dt))
            if rng is not None:
                h = rng.dropout(h, 0.1)
            logits = self.fc_1(h, dt)[:, 0]
        logits = logits.float()
        return logits, torch.sigmoid(logits), aux_logit.float()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def build_model(cfg, dims: Dict[str, int], device="cuda") -> CTRModel:
    """CTRModel for ``cfg`` and the cache ``dims``, with uninitialised
    parameters allocated on ``device``: the dense parameters trainable,
    the sequence table without grad (the trainer updates its rows).
    ``model.use_pallas_attention`` / ``use_pallas_ffn`` None or true
    select the encoder's kernel path, the only one ported;
    ``model.extra.use_pallas_fm`` selects the FM-cross kernels of the
    QNN-alpha head.  A config that asks for an unported path raises."""
    m, s = cfg.model, cfg.sequence
    unported = {
        "model.use_pallas_attention: false (the unfused encoder)": m.use_pallas_attention is False,
        "model.use_pallas_ffn: false (the unfused encoder)": m.use_pallas_ffn is False,
        "sequence.tfm.norm other than rms": s.tfm.norm.lower() != "rms",
        "model.qnn_alpha.norm other than rms": m.qnn_alpha.norm.lower() != "rms",
        "model.fused_seq_tables: false (split tables)": not m.fused_seq_tables,
        "sequence.select_chunk / select_proxy": bool(s.select_chunk or s.select_proxy),
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported to tossctr_tpu_torch yet: {', '.join(asked)}")
    with torch.device(resolve_device(device)):
        return CTRModel(build_model_spec(cfg, dims), cfg.compute_dtype,
                        se_batch_stats=bool(m.qnn_alpha.se_batch_stats),
                        use_pallas_fm=bool(m.extra.get("use_pallas_fm", False)))


@torch.no_grad()
def init_params(model: CTRModel, seed: int) -> CTRModel:
    """Seeded random parameters with the flax initializers' scales: tables
    and the positional bias N(0, 1); dense kernels and projections
    lecun-normal; U, V and feature slopes N(0, 0.02); biases 0; norm
    weights 1.  Draws on the parameters' device from a torch.Generator."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf in ("U", "V", "weight"):
            p.normal_(0.0, 0.02, generator=gen)
        elif leaf == "kernel" or leaf.startswith("proj_"):
            fan_in = math.prod(p.shape[:-1])
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        else:  # emb_tables, table_{d}, rel
            p.normal_(0.0, 1.0, generator=gen)
    return model
