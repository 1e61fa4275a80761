"""Typed, validated configuration schema.

Port of ``tossctr_tpu/config/schema.py``: the same dataclasses, defaults,
``Config.from_dict`` validation, ``deep_merge`` and ``base:`` resolution,
so every config file of ``cfgs/`` loads unchanged.  Differences:
``compute_dtype`` is a torch dtype, and PyYAML is imported by
``load_yaml_with_base`` alone, so a config built in code with
``Config.from_dict`` needs no YAML package.  Sections and knobs that
only the JAX package reads (``mesh``, ``attn_impl``, ``dropout_impl``)
are kept so configs round-trip.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple



def _build(cls, d: Optional[Dict[str, Any]]):
    """Construct dataclass ``cls`` from dict ``d``, tolerating unknown keys."""
    d = dict(d or {})
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in d.items() if k in names and k != "extra"}
    extra = {k: v for k, v in d.items() if k not in names}
    # an EXPLICIT `extra:` mapping in the YAML merges with (and is
    # overridden by) unknown top-level keys — previously it was
    # silently dropped, so `mesh: {extra: {a2a_grad_cap_factor: ...}}`
    # never reached the trainer
    explicit = d.get("extra")
    if isinstance(explicit, dict):
        extra = {**explicit, **extra}
    obj = cls(**known)
    if hasattr(obj, "extra"):
        obj.extra = extra
    return obj


@dataclass
class DataConfig:
    train_path: str = ""
    test_path: str = ""
    cache_dir: str = "./cache/default"
    use_cache: bool = True
    chunked_build: bool = True
    shard_rows: int = 2_000_000
    stream_batch_rows: int = 200_000
    add_isna_mask: bool = True
    impute_strategy: str = "median"
    cat_cols: List[str] = field(default_factory=list)
    num_cols_explicit: Optional[List[str]] = None
    num_patterns: List[str] = field(default_factory=list)
    hash_buckets: Dict[str, int] = field(default_factory=dict)
    hash_buckets_margin: int = 0
    default_hash_bucket: int = 1_000_003
    remove_cols: Optional[List[str]] = None
    manifest_train: Optional[str] = None
    manifest_test: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def bucket_for(self, col: str) -> int:
        """Cardinality of a hashed categorical column (bucket + margin),
        matching reference src/train.py:119."""
        return int(self.hash_buckets.get(col, self.default_hash_bucket)) + int(
            self.hash_buckets_margin
        )


@dataclass
class TfmConfig:
    n_layers: int = 2
    n_heads: int = 4
    mha_dropout: float = 0.1
    ffn_hidden: int = 256
    ffn_dropout: float = 0.1
    norm: str = "rms"
    gating: str = "softmax"
    add_positional_bias: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SequenceConfig:
    col: str = "seq"
    max_len: int = 400
    pad_id: int = 0
    top_k: int = 80
    recency_tau: int = 256
    query_mode: str = "S1"  # S1 | S2 | concat
    query_key: str = "inventory_id"
    transformer_block: bool = True
    # L-chunked streaming selection: gather/score/merge top-k in chunks
    # of this many positions so the (B, L, D) att-embedding tensor never
    # materializes in HBM (ops/topk_select._streaming_topk_ids);
    # null = one dense pass
    select_chunk: Optional[int] = None
    # Hierarchical (proxy-prefilter) selection (VERDICT r4 #8 /
    # exp/hier_select_probe.py): score all L positions against a small
    # block-mean PROXY of the att table (operand fits VMEM -> ~3x
    # cheaper per index), keep the top `select_proxy_candidates`
    # positions, and run the exact gather+score only on those.
    # Measured -13.4 ms/step at flagship shapes on v5e.  CHANGES MODEL
    # SEMANTICS (the exact top-k is taken within the prefiltered
    # candidate set — identical whenever the true top-k survives the
    # proxy stage); opt-in, quality delta measured by
    # tools/parity_vs_reference.py --select-proxy legs.
    select_proxy: bool = False
    select_proxy_block: int = 64        # table rows per proxy cluster
    select_proxy_candidates: int = 128  # positions kept by the prefilter
    # Pad the selected top-k to the next 8-sublane multiple (pads use
    # pad_id -> -1e9 score -> zero weight; u_seq math unchanged).  Kills
    # the relayout copies around the fused kernels when top_k isn't a
    # multiple of 8 (e.g. K=60 -> 64).
    pad_topk_to_tile: bool = True
    tfm: TfmConfig = field(default_factory=TfmConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.tfm, dict):
            self.tfm = _build(TfmConfig, self.tfm)


@dataclass
class QnnAlphaConfig:
    enabled: bool = True
    feature_embed_dim: Optional[int] = None  # default max(8, emb_dim//4)
    heads: int = 8
    rank: int = 32
    proj_dim: int = 256
    mlp_hidden: Sequence[int] = (512, 256)
    dropout: float = 0.1
    use_se: bool = True
    se_reduction: int = 8
    # Reference quirk: SE gates are computed from the BATCH mean
    # (qnn_alpha.py:25), so inference depends on batch composition.
    # False gates per-row instead.
    se_batch_stats: bool = True
    use_residual: bool = True
    norm: str = "rms"
    pair_grouping: str = "block"  # all | block
    aux_head_weight: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    emb_dim: int = 64
    dare_dropout: float = 0.2
    embedding_dropout: float = 0.0
    cat_embedding_dims: Dict[str, int] = field(default_factory=dict)
    qnn_alpha: QnnAlphaConfig = field(default_factory=QnnAlphaConfig)
    # Reference hard-codes the sequence vocab at src/train.py:116; here it is
    # a first-class knob (pod-scale configs raise it to 100M+).
    seq_vocab: int = 10_000_000
    # Storage dtype of the two giant sequence tables.  bfloat16 halves both
    # HBM footprint and the (B,L,D) gather traffic of the selection pass;
    # optimizer math stays fp32 (rows are upcast in the sparse update).
    table_dtype: str = "float32"  # float32 | bfloat16
    # Fused Pallas attention over the K selected tokens (ops/pallas_attention).
    # None = auto: on for TPU backends, off elsewhere.
    use_pallas_attention: Optional[bool] = None
    # Fused Pallas FFN inside the DARE transformer (ops/pallas_ffn): the
    # (B*K, ffn_hidden) hidden activation never hits HBM.  Same auto rule.
    use_pallas_ffn: Optional[bool] = None
    # Store att/rep lane-fused as ONE (V, 2*emb_dim) param: at D=64 a
    # row is exactly one native 128-lane TPU tile, so table gathers and
    # scatters run layout-native (XLA otherwise relayouts the whole
    # (V, 64) table per step — measured 2.56 GB of step temps at 10M
    # rows, zero when fused; scripts/tpu_layout_probe.py).  False =
    # reference-shaped split tables (parity oracle).
    fused_seq_tables: bool = True
    # fused-attention kernel geometry: "packed" (heads in the matmul
    # row dim) | "wide" (heads in the matmul column dim — fewer, wider
    # dots) | "loop" (per-head; the round-1 oracle)
    attn_impl: str = "packed"
    # in-kernel dropout mask generator: "hw" (TPU hardware PRNG, ~7x
    # fewer VPU ops per score/hidden element — the production default)
    # | "hash" (counter-based, numpy-reproducible, bit-identical across
    # kernel geometries and backends — the testing oracle).  Interpret
    # mode (CPU) always uses "hash"; the Bernoulli distribution is the
    # same either way, only the sampled mask differs.
    dropout_impl: str = "hw"
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if isinstance(self.qnn_alpha, dict):
            self.qnn_alpha = _build(QnnAlphaConfig, self.qnn_alpha)


@dataclass
class TrainConfig:
    batch_size: int = 8192
    epochs: int = 8
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 1e-4
    warmup_epochs: int = 1
    cosine: bool = True
    early_stop_patience: int = 3
    grad_clip_norm: float = 0.5
    monitor: str = "score"
    # TPU-only: optimizer family for the giant embedding tables.  "adamw"
    # matches the reference (dense AdamW over nn.Embedding); "adafactor"
    # keeps the second moment factored (O(rows+cols) state instead of
    # O(rows*cols)), the standard memory-safe choice for 10M+-row tables.
    # "rowwise_adagrad" / "sparse_sgd" switch to row-sparse updates
    # (train/sparse_embed.py) — the fast path.
    embedding_optimizer: str = "adamw"
    # PRNG implementation for dropout keys.  threefry matches JAX defaults;
    # "rbg" is the TPU-fast generator (~20 ms/step cheaper at B=4096).
    rng_impl: str = "threefry"
    # Epoch-granular in-fold resume (params+optimizer+EMA+counters saved
    # after every epoch).  The reference can only resume at fold
    # boundaries (SURVEY.md §5 failure detection).
    step_checkpointing: bool = False
    # With step_checkpointing: also save the full train state every N
    # steps (0 = epoch end only).  Resume re-enters mid-epoch at the
    # saved step — samplers are pure functions of (seed, fold, epoch),
    # so the continued loss trajectory is bit-identical.
    step_checkpoint_interval: int = 0
    # Final partial train batch per epoch: the reference TRAINS on it
    # (torch DataLoader default drop_last=False, src/train.py:106-110).
    # Static XLA shapes forbid a smaller batch, so the partial batch is
    # padded to batch_size and the loss masks the padded rows (the
    # `valid` mask) — same loss value and gradients as the reference's
    # smaller batch.  True restores the old drop behaviour.
    drop_partial_batch: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CVConfig:
    n_splits: int = 5
    group_key: str = "inventory_id"
    stratify_target: str = "clicked"
    time_key: Optional[str] = None
    composite_group: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EvalConfig:
    monitor: str = "score"
    maximize: bool = True
    # The reference literally maximizes 0.5*AP + 0.5*WLL even though WLL is
    # a loss (src/train.py:262-263, src/utils/metrics.py:26-29).  "reference"
    # reproduces that; "competition" uses 0.5*AP + 0.5*(1/(1+WLL)).
    score_formula: str = "reference"
    # Device-side AP/WLL (sorted cumulative-precision impl) instead of
    # host sklearn — for pod-scale validation sets (SURVEY.md §7).
    # None = auto: enabled on TPU backends, host sklearn elsewhere.
    device_metrics: Optional[bool] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CalibrationConfig:
    enabled: bool = False
    method: str = "temperature"  # temperature | isotonic | temperature+isotonic
    lr: float = 0.05
    iters: int = 200
    clamp_T: Tuple[float, float] = (0.2, 5.0)
    l2_reg: float = 1e-3
    min_iso_nodes: int = 8
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LoggingConfig:
    log_dir: str = "./runs"
    tb: bool = True
    csv_log: bool = True
    verbose_steps: int = 100
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EnsembleConfig:
    method: str = "logit_mean"
    trim_ratio: float = 0.0
    weights: List[float] = field(default_factory=list)
    val_weight_temperature: float = 10.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SamplerConfig:
    type: Optional[str] = None  # None | "balanced"
    pos_fraction: float = 0.5
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def balanced(self) -> bool:
        return str(self.type or "").lower() == "balanced"


@dataclass
class EmaConfig:
    enabled: bool = False
    decay: float = 0.999
    eval_with_ema: bool = True
    start_epoch: int = 1
    warmup_steps: int = 0
    warmup_type: str = "linear"  # linear | cosine | none
    update_after_step: int = 0
    update_interval: int = 1
    ema_on_buffers: str = "copy"
    offload_to_cpu: bool = False
    pin_memory: bool = False
    param_filter: List[str] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MeshConfig:
    """TPU-only: device mesh layout.

    ``data`` x ``model`` axes.  -1 means "use all remaining devices".
    Embedding tables are row-sharded over the ``model`` axis
    (PartitionSpec('model', None)); dense towers are replicated over
    ``model`` and data-parallel over ``data``.
    """

    data: int = -1
    model: int = 1
    embedding_sharding: str = "row"  # row | replicated
    # Lookup exchange for row-sharded tables (parallel/embedding.py):
    #   psum — mask-gather-psum (bytes independent of shard count;
    #          best at small model-axis sizes)
    #   a2a  — DLRM-style id exchange (all_to_all ids to owners, local
    #          gather, all_to_all rows back; the scalable form for
    #          large meshes)
    exchange: str = "psum"
    # Sparse-update gradient return for row-sharded tables:
    #   allgather (default) — every model shard all-gathers (ids,
    #              grads) over the data axis: exact under ANY id
    #              distribution, O(global B*K*D) ICI bytes/device
    #   a2a      — bucketed return (local exact dedup -> all_to_all to
    #              owning shards -> all_gather of the filtered buckets):
    #              ~4/model_axis of the all-gather bytes (fp32 deduped
    #              payloads vs bf16 cotangents — wins past model~4,
    #              loses at model=2; bench_scaling.py analytic table).
    #              Bucket caps are static (mesh.extra.
    #              a2a_grad_cap_factor, default 2.0) and presume
    #              HASH-UNIFORM unique-id owners: a frequency-sorted or
    #              clustered vocab can overflow a bucket and silently
    #              drop gradients — an explicit opt-in; see
    #              parallel/embedding.sharded_rowwise_adagrad_update_a2a
    grad_exchange: Optional[str] = None  # None = allgather
    # Grouped categorical tables: "replicate" (default — they are small,
    # reference bucket sizes are primes, and their grads ride the dense
    # psum) or "row" (row-shard + explicit exchange; requires every
    # group's row count divisible by the model axis).
    cat_sharding: str = "replicate"
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    exp_name: str = "exp"
    seed: int = 777
    device: str = "tpu"
    deterministic: bool = True
    amp: str = "none"  # none | bf16  (fp16 maps to bf16 on TPU)
    use_compile: bool = False  # everything is jitted; kept for config parity
    num_workers: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    sequence: SequenceConfig = field(default_factory=SequenceConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    cv: CVConfig = field(default_factory=CVConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    ema: EmaConfig = field(default_factory=EmaConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    loss: Dict[str, Any] = field(default_factory=dict)
    features: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ---- construction ----
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d or {})
        sections = {
            "data": DataConfig,
            "sequence": SequenceConfig,
            "model": ModelConfig,
            "train": TrainConfig,
            "cv": CVConfig,
            "eval": EvalConfig,
            "calibration": CalibrationConfig,
            "logging": LoggingConfig,
            "ensemble": EnsembleConfig,
            "sampler": SamplerConfig,
            "ema": EmaConfig,
            "mesh": MeshConfig,
        }
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in sections:
                kwargs[k] = _build(sections[k], v)
            elif k in names and k != "extra":
                kwargs[k] = v
            else:
                extra[k] = v
        cfg = cls(**kwargs)
        cfg.extra = extra
        cfg.validate()
        return cfg

    @classmethod
    def load(cls, path: str) -> "Config":
        return cls.from_dict(load_yaml_with_base(path))

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                out = {}
                for f in dataclasses.fields(obj):
                    v = getattr(obj, f.name)
                    if f.name == "extra":
                        out.update(unwrap(v))
                    else:
                        out[f.name] = unwrap(v)
                return out
            if isinstance(obj, dict):
                return {k: unwrap(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [unwrap(v) for v in obj]
            return obj

        return unwrap(self)

    # ---- validation ----
    def validate(self) -> None:
        s = self.sequence
        if s.query_mode not in ("S1", "S2", "concat"):
            raise ValueError(f"sequence.query_mode must be S1|S2|concat, got {s.query_mode}")
        if s.query_mode in ("S1", "concat") and self.data.cat_cols:
            if s.query_key not in self.data.cat_cols:
                raise ValueError(
                    f"sequence.query_key={s.query_key!r} not in data.cat_cols"
                )
        if self.model.qnn_alpha.pair_grouping not in ("all", "block"):
            raise ValueError("model.qnn_alpha.pair_grouping must be all|block")
        if self.amp not in ("none", "bf16", "fp16"):
            raise ValueError("amp must be none|bf16|fp16")
        if self.train.batch_size <= 0 or self.train.epochs <= 0:
            raise ValueError("train.batch_size and train.epochs must be positive")
        if s.top_k <= 0 or s.max_len <= 0:
            raise ValueError("sequence.top_k and sequence.max_len must be positive")
        if s.select_proxy:
            if s.select_chunk:
                raise ValueError(
                    "sequence.select_proxy and select_chunk are mutually "
                    "exclusive (speed vs HBM-pressure options)"
                )
            if s.select_proxy_candidates < s.top_k:
                raise ValueError(
                    "sequence.select_proxy_candidates must be >= top_k"
                )
            if self.model.seq_vocab % max(1, s.select_proxy_block):
                raise ValueError(
                    "model.seq_vocab must divide by sequence."
                    "select_proxy_block for the block-mean proxy"
                )
        if self.mesh.exchange not in ("psum", "a2a"):
            raise ValueError("mesh.exchange must be psum|a2a")
        if self.mesh.grad_exchange not in (None, "allgather", "a2a"):
            raise ValueError("mesh.grad_exchange must be allgather|a2a")
        if self.mesh.grad_exchange == "a2a":
            import warnings

            # VERDICT r4 #5: the bucketed return's static bucket cap
            # assumes unique ids hash ~uniformly over owner shards.
            # A clustered / frequency-sorted (non-hashed) vocab can
            # overflow buckets, and overflowed gradients are DROPPED
            # (counted per epoch as `a2a_grad_dropped` in the train
            # logs).  The ETL's hashed categorical ids satisfy the
            # assumption; raw sequential ids may not.
            warnings.warn(
                "mesh.grad_exchange=a2a drops bucket-overflow gradients; "
                "safe for hashed/uniform id streams — watch the "
                "a2a_grad_dropped counter in the train logs and raise "
                "mesh.extra.a2a_grad_cap_factor (default 2.0) or use "
                "allgather if it is ever nonzero.",
                stacklevel=2,
            )
        if self.mesh.cat_sharding not in ("replicate", "row"):
            raise ValueError("mesh.cat_sharding must be replicate|row")
        if self.model.attn_impl not in ("packed", "wide", "loop"):
            raise ValueError("model.attn_impl must be packed|wide|loop")
        if self.model.dropout_impl not in ("hw", "hash"):
            raise ValueError("model.dropout_impl must be hw|hash")

    # ---- convenience ----
    @property
    def compute_dtype(self):
        import torch

        # fp16 maps to bf16, as in the JAX package
        return torch.bfloat16 if self.amp in ("bf16", "fp16") else torch.float32

    def exp_dir(self) -> str:
        import os

        return os.path.join(self.logging.log_dir, self.exp_name)


def deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge: ``over`` wins; nested dicts merge key-wise;
    a ``None`` in ``over`` removes the key (YAML ``key:`` with no value),
    mirroring how reference experiments drop columns between revisions
    (e.g. v4 removes l_feat_20/23 buckets, reference cfgs/v4_k120_s1.yaml)."""
    out = dict(base)
    for k, v in over.items():
        if v is None and k in out:
            del out[k]
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_with_base(path: str) -> Dict[str, Any]:
    """Load a YAML (or JSON) config, resolving an optional top-level ``base:`` key
    (path relative to the file) whose dict the file deep-merges onto.
    Lets the experiment family (cfgs/dare_base_tpu.yaml …) stay compact
    deltas instead of near-identical 150-line copies."""
    import os

    with open(path, "r") as f:
        if path.endswith(".json"):  # no PyYAML needed
            import json

            d = json.load(f) or {}
        else:
            import yaml  # only the YAML entry point needs PyYAML

            d = yaml.safe_load(f) or {}
    base_rel = d.pop("base", None)
    if base_rel is None:
        return d
    base_path = os.path.join(os.path.dirname(os.path.abspath(path)), base_rel)
    return deep_merge(load_yaml_with_base(base_path), d)


def load_config(path: str) -> Config:
    return Config.load(path)
