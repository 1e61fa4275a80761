"""Ops of the port: the DARE top-k selection (dense, streaming and the
proxy prefilter) and the plain FM cross in PyTorch, the counter-hash
dropout masks, and the hand-written CUDA kernels of the encoder layer
(``fused_mha_qkv``, ``fused_block_tail``, ``fused_mha``, ``fused_ffn``
and their backwards) and of the QNN-alpha head (``fm_cross_pallas`` and its backward) and of the table update
(``sweep_rows_add``) with their plain versions; and the kernels of the
two card probes (the scatter probe's table sweeps, ``dense_sweep`` and
``sparse_sweep``; the dropout check's mask dumps,
``dump_attention_keep`` and ``dump_ffn_keep``).
Importing this package builds nothing; the kernels build at first use."""

from .dropout import (
    dropout_keep_reference,
    dump_attention_keep,
    dump_ffn_keep,
    ffn_keep_reference,
)
from .fm_cross import (
    fm_cross_blocked,
    fm_cross_multihead,
    fm_cross_pallas,
    fm_cross_pallas_bwd,
    fm_cross_pallas_bwd_reference,
    fm_cross_pallas_reference,
)
from .fused_attention import (
    fused_mha,
    fused_mha_bwd,
    fused_mha_bwd_reference,
    fused_mha_qkv,
    fused_mha_qkv_bwd,
    fused_mha_qkv_bwd_reference,
    fused_mha_qkv_reference,
    fused_mha_reference,
)
from .fused_ffn import (
    fused_block_tail,
    fused_block_tail_bwd,
    fused_block_tail_bwd_reference,
    fused_block_tail_reference,
    fused_ffn,
    fused_ffn_bwd,
    fused_ffn_bwd_reference,
    fused_ffn_reference,
)
from .sweep_scatter import sweep_rows_add, sweep_rows_add_reference
from .table_sweep import (
    dense_sweep,
    dense_sweep_reference,
    sparse_sweep,
    sparse_sweep_reference,
    touched_superblocks,
)
from .topk_select import dare_select_ids, log_decay_at, recency_log_decay

# every wrapper that launches a kernel and counts its launches
KERNEL_WRAPPERS = (fused_mha_qkv, fused_block_tail, fused_mha_qkv_bwd, fused_block_tail_bwd,
                   fm_cross_pallas, fm_cross_pallas_bwd, fused_mha, fused_mha_bwd, fused_ffn,
                   fused_ffn_bwd, sweep_rows_add, dense_sweep, sparse_sweep, dump_attention_keep,
                   dump_ffn_keep)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = [
    "KERNEL_WRAPPERS",
    "dare_select_ids",
    "dense_sweep",
    "dense_sweep_reference",
    "dropout_keep_reference",
    "dump_attention_keep",
    "dump_ffn_keep",
    "ffn_keep_reference",
    "fm_cross_blocked",
    "fm_cross_multihead",
    "fm_cross_pallas",
    "fm_cross_pallas_bwd",
    "fm_cross_pallas_bwd_reference",
    "fm_cross_pallas_reference",
    "fused_block_tail",
    "fused_block_tail_bwd",
    "fused_block_tail_bwd_reference",
    "fused_block_tail_reference",
    "fused_ffn",
    "fused_ffn_bwd",
    "fused_ffn_bwd_reference",
    "fused_ffn_reference",
    "fused_mha",
    "fused_mha_bwd",
    "fused_mha_bwd_reference",
    "fused_mha_qkv",
    "fused_mha_qkv_bwd",
    "fused_mha_qkv_bwd_reference",
    "fused_mha_qkv_reference",
    "fused_mha_reference",
    "launch_counts",
    "log_decay_at",
    "recency_log_decay",
    "reset_launch_counts",
    "sparse_sweep",
    "sparse_sweep_reference",
    "sweep_rows_add",
    "sweep_rows_add_reference",
    "touched_superblocks",
]
