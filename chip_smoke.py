"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without a CUDA card.
2. Builds the hand-written kernels from ``tossctr_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
3. Kernel phase, at the flagship shapes in bf16: the encoder forward
   kernels (``fused_mha_qkv``, ``fused_block_tail``, ``fused_mha``,
   ``fused_ffn``) with dropout off (serving) and on (training, p = 0.1),
   their backward kernels with dropout on, and the FM-cross pair at the
   QNN-alpha head's shapes (also in fp32), each against its plain PyTorch
   version (error and tolerance), its time from CUDA events beside the
   plain version's, a PyTorch yardstick where PyTorch computes the same
   function, and the least time the card could take; for the kernels
   with a bf16 tensor-core form (``fused_ffn`` and its backward,
   ``fused_mha``'s forward, the two attention backwards) also their
   TFLOP/s and share of the bound (``fused_mha_qkv``'s forward's too: its
   warp-unit kernel runs FFMA chains on the CUDA cores), the attention
   backwards' times with dropout off (their yardsticks have none), each
   kernel's registers, static shared memory and spills (ptxas's report of
   the build, ``fused_mha_qkv``'s forward's included) and,
   where the toolkit has ``cuobjdump``, the HMMA / HGMMA instructions in
   its SASS (a bf16 tensor-core kernel without them fails; the block
   tail pair's and the FM-cross pair's are on the tensor cores too; the
   FM pair's rows also give the plain einsum path's time beside their
   own).  Beside
   them: the four attention kernels at the larger-K configs' shapes (K =
   120 at B = 8192, K = 152 at B = 4096), with their PyTorch yardsticks
   at those shapes; and
   ``sweep_rows_add`` at the flagship's table update (the (10M, 128) bf16
   table, 8192 x 64 ids, fp32 deltas) with uniform, zipf:1.0 and hot-id
   ids, against its plain version and ``Tensor.index_add_``, with its
   wrapper's sort, search and kernels timed apart, and at the split
   tables' update (two (10M, 64) bf16 tables in one launch).
4. Serving phase: a synthetic flagship test cache (3.5 batches of 8192
   rows), two full-width fold checkpoints (10M-row bf16 sequence table)
   from a seeded init with temperature calibrators, then ``infer_main``
   through to ``submission.csv``.  Checks the submission, that every
   encoder layer went through both kernels (launches = folds x batches x
   layers), and one fold's card output against the plain PyTorch path on
   the CPU for a 512-row batch; reports examples/s and a profile.
5. Training phase: a synthetic flagship train cache of 8 batches of 8192
   rows and ``make_train_step`` at full width (every dropout on) over the
   rotating batches, as ``bench.py`` drives the JAX step.  Checks finite
   losses, 3 launches per step of each of the four encoder kernels, and
   that one step changes only table rows the batch selected (never the
   pad row); reports ms/step, examples/s, peak memory, the device's busy
   share and a profile of one step.  Then one step from one state on a
   512-row batch (kernel dropouts on, the other dropouts off), in bf16
   and in fp32, on the card against the CPU plain path and against the
   card with the kernels' plain versions: the selections, the loss, every
   dense gradient, the AdaGrad accumulator and the table's update agree
   within the bands of ``CHECK_BANDS`` (see ``train_reference_check`` for
   the rows each comparison holds and the gaps reported beside).  In
   bf16 the comparison with the plain versions runs both steps with every
   ReLU pinned to the plain step's signs (the unpinned pair and its ReLU
   sign flips reported beside), and its accumulator band is derived in
   the run from a perturbation witness: the plain step with one encoder
   kernel's bf16 outputs moved by one ulp on 0.05% of their elements.
   Then the negative controls: the same comparison with three wrong plain
   versions (the tail forward with the next seed's mask or with the kept
   units unscaled, the qkv forward without the positional bias) must
   each fail a band.  The serving and training phases run the QNN
   head's plain FM path.
6. Fold phase: the K-fold entry point at full width with the FM-cross
   kernels (``model.extra.use_pallas_fm``): ``train_main`` over a
   synthetic train cache of FOLD_ROWS rows, cut to one fold of five and
   FOLD_EPOCHS epochs (the cuts are printed), then the training CLI again
   (it must skip the finished fold) and ``infer_main`` on the fold's
   checkpoint.  Checks the train log, the checkpoint, the submission and
   every kernel's launches; reports wall time, ms/step and the FM
   kernels' share of the device time.
7. LayerNorm phase: the flagship with ``sequence.tfm.norm: layer`` and
   ``model.qnn_alpha.norm: layer`` at full width, whose encoder takes the
   separate-kernel branch (``fused_mha_qkv``, residual, LayerNorm,
   ``fused_ffn``, residual, LayerNorm): train steps with every dropout on
   (3 launches a step of each of ``fused_mha_qkv``, ``fused_ffn`` and
   their backwards, no block tail; only selected table rows change), the
   fp32 512-row step against the CPU (``train_reference_check``), the
   weights served from one fold checkpoint through ``infer_main`` and
   held against the CPU plain path, and the unfused encoder
   (``use_pallas_attention`` / ``use_pallas_ffn`` false) on the same
   weights: no kernel launch, probabilities within 0.02 of the kernels'.
8. Streaming-update phase: the flagship with ``train.exact_dedup:
   false`` (a scatter-add), with ``table_update: sweep`` (the
   ``sweep_rows_add`` kernel) and with ``embedding_optimizer:
   sparse_sgd``: timed steps with launch counts (the sweep kernel once a
   step in the sweep mode only), only selected rows changed and never the
   pad row, the sweep mode's step profiled, and each mode's fp32 512-row
   step against the CPU and against the plain versions on the card.
8b. Select phase (``select_phase``): the flagship with each selection
   pass at full width (B = 8192, L = 400, K = 60 padded to 64, the
   10M-row bf16 table): SELECT_STEPS timed train steps each of the dense
   pass, the proxy prefilter (``sequence.select_proxy``, block 64, 128
   candidates: ``bench.py``'s default) and the streaming pass
   (``select_chunk: 128``: 112 phantom positions), on the same seeded
   weights and batches, 3 launches a step of each RMS encoder kernel, a
   step of each profiled (the selection's device time; the proxy's by
   part: build, stage 1, stage 2), then the three modes' steps in turns;
   the three passes' ids on one batch (the proxy at block 1 bit-equal to the dense ids, the
   streaming ids equal to them on CHECK_BANDS' ``select`` share of rows,
   the proxy's recall at block 64 logged); the proxy's 512-row step in
   fp32 and in bf16, and the streaming pass's in fp32, against the CPU
   and the plain versions on the flagship check's batch and parameters
   with the table cut by whole blocks (``block_cut_check``: the block
   means are the full table's), held to the unchanged CHECK_BANDS (the
   bf16 proxy's ids shared with the CPU reported, not held); the
   native gather's host time
   against NumPy's; one fold of ``train_main`` with the proxy,
   ``eval.device_metrics: true``, ``temperature+isotonic`` and the native
   gather, its AP / WLL on the card within 1e-5 of the host's on the
   fold's replayed scores; the OOF replay (``python -m
   tossctr_tpu_torch.tools.run_calibration``) and ``infer_main`` serving
   the fold with the OOF calibrator.
9. Reference-tables phase (``reference_tables_phase``): the flagship
   with the split ``emb_att`` / ``emb_rep`` tables (two (10M, 64) bf16
   tables) in ``rowwise_adagrad`` + ``table_update: sweep`` (timed
   steps, one ``sweep_rows_add`` launch a step over both tables, only
   selected rows changed, the update's own time) and in the dense-table
   modes (``adamw``: timed steps, one profiled; ``adafactor``, ``sgd``:
   one checked step each), each mode's 512-row step held against the CPU
   and the plain versions (fp32; the dense modes also bf16 with the
   pinned witness and the negative controls) on the flagship check's
   batch and parameters, the tables cut to the rows it reads
   (``compact_check``); then ``cfgs/synth_small.yaml`` (fp32, D = 32,
   dense AdamW) through ``train_main`` for one fold and ``infer_main``.
10. K = 120 phase: ``cfgs/v3_k120_s1_tpu.yaml`` at full width (K = 120,
   4 layers, S1 query): timed steps through the encoder kernels at K =
   120, the fp32 512-row step against the CPU and the plain versions, the
   weights served from a fold checkpoint through ``infer_main``, held
   against the CPU plain path within 0.02.  Then the K = 148 phase:
   ``cfgs/v3_k148_s1_tpu.yaml`` at full width (K = 152 padded, B = 4096,
   4 layers): timed steps with their launch counts and profile, and the
   bf16 512-row step against the CPU and, with the ReLUs pinned and the
   witness's bands, against the plain versions on the card.
11. ``fused_mha`` module check: no config reaches ``fused_mha``, so the
   card runs it in its module: ``MultiHeadSelfAttention`` with
   ``fuse_qkv`` off (qkv Dense, ``fused_mha``) against ``fuse_qkv`` on
   (``fused_mha_qkv``) on the same parameters at the flagship shapes, the
   output and the gradients of x, the bias and every parameter, in bf16
   (one launch each of ``fused_mha`` and its backward) and in fp32.
12. Scatter-probe phase: ``python -m tossctr_tpu_torch.exp.scatter_probe``'s
   measurements on its three tables (the JAX probe's (10M, 64) bf16 with
   245,760 ids, the flagship's (10M, 128) with 524,288 uniform and with
   524,288 zipf:1.0 ids): ``index_add_``,
   the dense and the sparse table sweep at W = 1024, 4096, 16384, and
   ``sweep_rows_add``, timed with the launch counts read around them;
   then the two sweeps bit-equal to their plain versions on each table.
13. Dropout-check phase: ``python -m
   tossctr_tpu_torch.exp.hw_dropout_device_check`` at the flagship
   geometry: the mask dumps bit-equal to the plain masks, the eight
   dropping encoder kernels in fp32 against a float64 oracle on the
   dumped masks (outputs and every gradient), the keep rates and the
   independence of the decisions within 1e-3, and the persistent kernels'
   results against a grid of a few blocks; the dumps bit-equal to their
   plain versions at odd shapes too (K % 4 != 0, one and three heads, a
   single row, element counts not a multiple of 4), and timed.
14. Prints the ``kernels`` JSON line (the thirteen rows' kernels: the
   eleven ported kernels, the two table sweeps and the two mask dumps;
   each with its launches in every phase that counts them,
   ``launches_select`` the select phase's proxy steps'), then ``{"ok":
   true, "device": ...}``.

Every profiled train step (``profile_step``: the training, LayerNorm,
K = 148 and streaming sweep phases, the reference tables' sweep and
``adamw`` steps) is also broken down by class: its exported trace
(shapes recorded) folded by ``tossctr_tpu_torch/utils/trace.py`` into the
JAX package's device-time classes, printed as ``[breakdown]`` lines in
ms per step with the top ten kernels; the phase fails if the classes do
not sum to the kept events, if that total is more than BREAKDOWN_BAND
from the profiler's device time, if the trace lacks a kernel the step
launched, or if one of the port's kernels lands outside its class.

Any failure exits non-zero before the last line.  Scratch files live in a
temporary directory under ``build/`` that is removed at exit.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from tossctr_tpu_torch.exp._timing import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    PEAK_FP32_FLOPS,
    cuda_time_ms,
    log,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()
N_ROWS = 8192 * 3 + 4096  # 3.5 batches: the last one is partial
N_NUM = 82  # numeric features (and as many isna masks), as in bench.py
N_FOLDS = 2
P_DROP = 0.1  # the flagship's mha_dropout and ffn_dropout
DROP_SEED = 1234567
WGRAD_BAND = 1e-2  # bf16 weight gradients: relative to the largest magnitude
FP32_BAND = 1e-5  # fp32 outputs: relative to the largest magnitude
TRAIN_BATCHES = 8  # distinct batches rotating through the timed steps
TRAIN_STEPS = 8  # timed steps
CHECK_ROWS = 512  # the card-vs-CPU one-step check
FOLD_ROWS = 40960  # the fold phase's synthetic train rows: 5 folds of 8192
FOLD_EPOCHS = 2
LAYERNORM_STEPS = 4  # timed steps of the LayerNorm phase, after 2 warm ones
UNFUSED_BAND = 0.02  # the unfused encoder against the kernels: probability
# the kernels of the RMSNorm flagship's encoder, and of the LayerNorm one's
RMS_ENCODER = ("fused_mha_qkv", "fused_mha_qkv_bwd", "fused_block_tail", "fused_block_tail_bwd")
LAYER_ENCODER = ("fused_mha_qkv", "fused_mha_qkv_bwd", "fused_ffn", "fused_ffn_bwd")
# the one-step check, by compute dtype.  The table is stored in fp32, so
# that one step's row update is visible (at the flagship lr a first
# AdaGrad step moves a N(0, 1) bf16 row by under half an ulp: in bf16
# storage neither side would change it).  select: share of each row's
# selected ids found on the card and on the CPU; same_order: share of the
# rows whose ordered selection is the same on both; same_relu (fp32 only,
# None: not asked): share of those rows whose every ReLU input has the
# same sign on both sides in the step's forward.  vs_cpu, the card
# against the CPU on the rows with a history, the same ordered selection
# and (where asked) the same ReLU signs; vs_plain, the card's kernels
# against their plain versions on the card, on every row with a history
# (in bf16 with every ReLU pinned: ``PinnedPlain``): loss, relative;
# grads, norm of the difference over the norm for all dense gradients
# together; grad_tensor, the same for the worst single tensor (the
# positional biases among them); accum, delta: the same for the AdaGrad
# accumulator and the rows' update over the ids whose accumulator is >=
# ACCUM_FLOOR of the largest (the others carry a gradient below AdaGrad's
# eps).  A band of None is derived in the run from the perturbation
# witness (``PinnedPlain.witness``).
ACCUM_FLOOR = 1e-6
# the bf16 step's fp32 witness: the card's distance from the fp32 step may
# be at most this many times the CPU's (both are bf16 rounding; a card
# path that rounded more coarsely than the CPU's would exceed it)
FP32_WITNESS_RATIO = 1.5
# The bf16 vs_plain perturbation witness: the plain-versions step with one
# RMS encoder kernel's bf16 outputs moved by one ulp (up or down) on a
# seeded WITNESS_SHARE of their elements, about what a correct kernel that
# sums in another order does (a tensor-core qkv forward moved 0.041%),
# held against the plain-versions step, both with the ReLUs pinned.  A
# derived band is the largest of the four kernels' distances, at most
# WITNESS_CAP: the accumulator's (one forward rounding's cascade lands
# above any hand-set band a kernel would pass) and the worst tensor's
# (the witness of a forward lands above the 0.01 that was set by hand).
WITNESS_SHARE = 5e-4
WITNESS_SEED = 20261
WITNESS_CAP = 0.02
_HELD = ("loss", "grads", "grad_tensor", "accum", "delta")
CHECK_BANDS = {
    "bf16": dict(select=0.999, same_order=0.3, same_relu=None, pinned=True, witness="each",
                 vs_cpu=dict(zip(_HELD, (1e-3, 3e-2, 8e-2, 5e-2, 6e-2))),
                 vs_plain=dict(zip(_HELD, (5e-4, 6e-3, None, None, 2.5e-2)))),
    "none": dict(select=0.999, same_order=0.999, same_relu=0.99, pinned=False,
                 vs_cpu=dict(zip(_HELD, (1e-6, 2e-6, 1e-5, 1e-5, 1e-4))),
                 vs_plain=dict(zip(_HELD, (1e-6, 2e-6, 1e-5, 1e-5, 1e-4)))),
}
# The K = 148 phase's bf16 check.  A row's ordered selection has 148 slots
# there (the flagship's 60), so fewer rows keep their order on both sides
# (same_order).  And the step's distance from the plain step is that of
# its four RMS encoder kernels each summing in another order at once: at
# K = 148 the qkv forward alone on the card moves the accumulator past the
# largest one-kernel witness, with the qkv backward's tensor-core kernel
# or its key-tiled one alike (``exp/step_kernel_split.py``), so the
# witness with all four kernels' outputs nudged together joins the four
# one-kernel ones (witness "all").  The negative controls run on these
# bands too.
K148_BANDS = dict(CHECK_BANDS["bf16"], same_order=0.2, witness="all")


def bf16_tolerance(ref) -> float:
    """3 bf16 ulps of the output's largest magnitude: the kernel and the
    plain version sum in other orders, so each bf16 rounding point can
    land one ulp apart."""
    top = float(ref.float().abs().max())
    return 3.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def bound_ms(n_bytes: float, n_flops: float, peak_ops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qkv_bwd_flops(B, K, D):
    """fused_mha_qkv_bwd's operations: the projection recomputed, dx and
    dWqkv (three (K, D, 3D) products a row) and the five (K, K, dh)
    products of each head's backward."""
    return 2 * B * K * D * 3 * D * 3 + mha_bwd_flops(B, K, D)


def mha_bwd_flops(B, K, D):
    """fused_mha_bwd's operations: five (K, K, dh) products a row and head
    (the scores, dp, dq, dk, dv)."""
    return 10 * B * K * K * D


def tensor_core_rows(results, flops, need_mma=True, libs=None):
    """Log each named row's TFLOP/s and share of its bound, and attach the
    build report of its library (``tensor_core_report``; ``need_mma``
    False for a library whose bf16 kernel runs on the CUDA cores; ``libs``
    names a row's library where the row is named otherwise)."""
    for name, n in flops.items():
        r = results[name]
        log(f"[kernel] {name} bf16: {n / r['ms'] * 1e-9:.4f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.2%} of the bound ({r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); library call "
            + ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms") + ")")
        r["build"] = tensor_core_report((libs or {}).get(name, name), need_mma)


def check_close(name, got, want, band):
    """max |got - want| over one output, held to ``band``."""
    err = float((got.float() - want.float()).abs().max())
    if not err <= band:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {band}")
    return err


def spread(got, want) -> str:
    """How far an output lands from its plain version as a whole: the norm
    of the difference over the norm, and the share of elements that
    differ (an ulp flip at one rounding point against a rounding point
    that differs)."""
    diff = got.float() - want.float()
    return (f"norm-relative {float(diff.norm() / want.float().norm()):.3g}, "
            f"{float((diff != 0).float().mean()):.3%} of elements differ")


def kernel_phase(cfg, dev):
    import torch
    import torch.nn.functional as F

    from tossctr_tpu_torch.ops import (
        fused_block_tail,
        fused_block_tail_bwd,
        fused_block_tail_bwd_reference,
        fused_block_tail_reference,
        fused_mha_qkv,
        fused_mha_qkv_bwd,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    f32 = torch.float32
    B, K, D = cfg.train.batch_size, -(-cfg.sequence.top_k // 8) * 8, cfg.model.emb_dim
    H, Fh = cfg.sequence.tfm.n_heads, cfg.sequence.tfm.ffn_hidden
    valid_k = cfg.sequence.top_k
    N = B * K

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    results = {}
    # ---- fused_mha_qkv: x (B, K, D), bias with -1e9 on the pad columns ----
    x, wqkv = rnd(B, K, D), rnd(D, 3 * D, std=D ** -0.5)
    bqkv = rnd(3 * D, std=0.1, dtype=f32)
    bias = rnd(K, K, std=0.5, dtype=f32)
    bias[:, valid_k:] = -1e9
    bias = bias.to(bf)
    args = (x, wqkv, bqkv, bias, H)
    errs = {}
    for p in (0.0, P_DROP):
        got = fused_mha_qkv(*args, p, DROP_SEED)
        torch.cuda.synchronize()
        want = fused_mha_qkv_reference(*args, p, DROP_SEED)
        tol = bf16_tolerance(want)
        errs[p] = check_close(f"fused_mha_qkv p={p}", got, want, tol)
        log(f"[kernel] fused_mha_qkv B={B} K={K} D={D} H={H} bf16 p={p}: "
            f"max_abs_err={errs[p]:.6g} (tolerance {tol:.6g}); {spread(got, want)}")
    del got, want

    def sdpa_yardstick(x, wqkv, bqkv):
        qkv = torch.matmul(x, wqkv) + bqkv.to(bf)
        q, k, v = (t.reshape(B, K, H, D // H).transpose(1, 2) for t in qkv.split(D, -1))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return o.transpose(1, 2).reshape(B, K, D)

    b_ms, b_by = bound_ms(nbytes(x, wqkv, bqkv, bias) + nbytes(x),
                          2 * B * K * D * (3 * D + 2 * K))
    results["fused_mha_qkv"] = dict(
        name="fused_mha_qkv", route="cuda",
        source="tossctr_tpu_torch/csrc/fused_mha_qkv.cu",
        replaces="tossctr_tpu/ops/pallas_attention.py:1055",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_mha_qkv(*args, P_DROP, DROP_SEED)),
        plain_ms=cuda_time_ms(lambda: fused_mha_qkv_reference(*args, P_DROP, DROP_SEED)),
        ms_no_dropout=cuda_time_ms(lambda: fused_mha_qkv(*args)),
        plain_ms_no_dropout=cuda_time_ms(lambda: fused_mha_qkv_reference(*args)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(lambda: sdpa_yardstick(x, wqkv, bqkv)),
        library_call="torch.matmul projection + F.scaled_dot_product_attention(attn_mask=bias), "
                     "no dropout",
    )

    # ---- fused_mha_qkv backward, dropout on ----
    do = rnd(B, K, D)
    bw = (x, wqkv, bqkv, bias, do, H, P_DROP, DROP_SEED)
    got = fused_mha_qkv_bwd(*bw)
    torch.cuda.synchronize()
    want = fused_mha_qkv_bwd_reference(*bw)
    tol = bf16_tolerance(want[0])
    errs = [check_close("fused_mha_qkv_bwd dx", got[0], want[0], tol)]
    for name, a, b in zip(("dwqkv", "dbqkv", "dbias"), got[1:], want[1:]):
        errs.append(check_close(f"fused_mha_qkv_bwd {name}", a, b,
                                WGRAD_BAND * float(b.abs().max())))
    log(f"[kernel] fused_mha_qkv_bwd bf16 p={P_DROP}: max_abs_err dx={errs[0]:.6g} "
        f"(tolerance {tol:.6g}), dwqkv={errs[1]:.6g}, dbqkv={errs[2]:.6g}, dbias={errs[3]:.6g} "
        f"(band {WGRAD_BAND} of each one's largest magnitude); "
        + "; ".join(f"{n}: {spread(a, b)}"
                    for n, a, b in zip(("dx", "dwqkv", "dbqkv", "dbias"), got, want)))
    del got
    xg, wg, bg = (t.detach().requires_grad_() for t in (x, wqkv, bqkv))
    out = sdpa_yardstick(xg, wg, bg)
    grad_bytes = 4 * (D * 3 * D + 3 * D + K * K)
    b_ms, b_by = bound_ms(nbytes(x, wqkv, bqkv, bias, do) + nbytes(x) + grad_bytes,
                          qkv_bwd_flops(B, K, D))
    del want
    results["fused_mha_qkv_bwd"] = dict(
        name="fused_mha_qkv_bwd", route="cuda",
        source="tossctr_tpu_torch/csrc/fused_mha_qkv_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_attention.py:1101",
        max_abs_err=max(errs), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_mha_qkv_bwd(*bw)),
        ms_no_dropout=cuda_time_ms(lambda: fused_mha_qkv_bwd(*bw[:5], H)),
        plain_ms=cuda_time_ms(lambda: fused_mha_qkv_bwd_reference(*bw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(
            lambda: torch.autograd.grad(out, (xg, wg, bg), do, retain_graph=True)),
        library_call="backward of the torch.matmul projection + "
                     "F.scaled_dot_product_attention (retain_graph; no dropout, no dbias)",
    )
    del x, do, out, xg, wg, bg, bw
    # fused_mha_qkv's bf16 forward runs FFMA chains (mha_qkv_fwd_chain): its
    # registers and spills are reported, no tensor-core instruction is asked
    tensor_core_rows(results, {"fused_mha_qkv": 2 * B * K * D * (3 * D + 2 * K)}, need_mma=False)
    tensor_core_rows(results, {"fused_mha_qkv_bwd": qkv_bwd_flops(B, K, D)})

    # ---- fused_block_tail: x, o (B*K, D) ----
    targs = (rnd(N, D), rnd(N, D), rnd(D, D, std=D ** -0.5), rnd(D, std=0.1, dtype=f32),
             1 + rnd(D, std=0.1, dtype=f32), rnd(D, Fh, std=D ** -0.5),
             rnd(Fh, std=0.1, dtype=f32), rnd(Fh, D, std=Fh ** -0.5),
             rnd(D, std=0.1, dtype=f32), 1 + rnd(D, std=0.1, dtype=f32))
    errs = {}
    for p in (0.0, P_DROP):
        got = fused_block_tail(*targs, p, DROP_SEED)
        torch.cuda.synchronize()
        want = fused_block_tail_reference(*targs, p, DROP_SEED)
        tol = bf16_tolerance(want)
        errs[p] = check_close(f"fused_block_tail p={p}", got, want, tol)
        log(f"[kernel] fused_block_tail N={N} D={D} F={Fh} bf16 p={p}: "
            f"max_abs_err={errs[p]:.6g} (tolerance {tol:.6g}); {spread(got, want)}")
    del got, want
    tail_flops = 2 * N * (D * D + 2 * D * Fh)
    b_ms, b_by = bound_ms(nbytes(*targs) + N * D * 2, tail_flops)
    results["fused_block_tail"] = dict(
        name="fused_block_tail", route="cuda",
        source="tossctr_tpu_torch/csrc/fused_block_tail.cu",
        replaces="tossctr_tpu/ops/pallas_ffn.py:525",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_block_tail(*targs, P_DROP, DROP_SEED)),
        plain_ms=cuda_time_ms(lambda: fused_block_tail_reference(*targs, P_DROP, DROP_SEED)),
        ms_no_dropout=cuda_time_ms(lambda: fused_block_tail(*targs)),
        plain_ms_no_dropout=cuda_time_ms(lambda: fused_block_tail_reference(*targs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    # ---- fused_block_tail backward, dropout on ----
    dy = rnd(N, D)
    got = fused_block_tail_bwd(*targs, dy, P_DROP, DROP_SEED)
    torch.cuda.synchronize()
    want = fused_block_tail_bwd_reference(*targs, dy, P_DROP, DROP_SEED)
    names = ("dx", "do", "dwout", "dbout", "dwn1", "dw1", "db1", "dw2", "db2", "dwn2")
    errs = {}
    for i, name in enumerate(names):
        band = bf16_tolerance(want[i]) if i < 2 else WGRAD_BAND * float(want[i].abs().max())
        errs[name] = check_close(f"fused_block_tail_bwd {name}", got[i], want[i], band)
    log(f"[kernel] fused_block_tail_bwd bf16 p={P_DROP}: max_abs_err "
        + ", ".join(f"{n}={e:.6g}" for n, e in errs.items())
        + f" (dx, do: 3 bf16 ulps; the rest: {WGRAD_BAND} of each one's largest magnitude); "
        + "; ".join(f"{n}: {spread(got[i], want[i])}" for i, n in enumerate(names)))
    grad_bytes = 4 * (D * D + 2 * D * Fh + Fh + 5 * D)
    # the forward recomputed, then the backward's products
    tail_bwd_flops = tail_flops + 2 * N * (4 * D * Fh + 2 * D * D)
    b_ms, b_by = bound_ms(nbytes(*targs, dy) + 2 * N * D * 2 + grad_bytes, tail_bwd_flops)
    results["fused_block_tail_bwd"] = dict(
        name="fused_block_tail_bwd", route="cuda",
        source="tossctr_tpu_torch/csrc/fused_block_tail_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_ffn.py:557",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_block_tail_bwd(*targs, dy, P_DROP, DROP_SEED)),
        plain_ms=cuda_time_ms(
            lambda: fused_block_tail_bwd_reference(*targs, dy, P_DROP, DROP_SEED)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    del targs, dy, got, want
    tensor_core_rows(results, {"fused_block_tail": tail_flops,
                               "fused_block_tail_bwd": tail_bwd_flops})
    results.update(separate_kernel_rows(cfg, dev, g))
    results.update(fm_kernel_rows(cfg, dev, g))
    large_k_rows(cfg, dev, g, results)
    results["sweep_rows_add"] = sweep_kernel_row(cfg, dev)
    for r in results.values():
        extra = ""
        if "ms_no_dropout" in r:
            extra = f", dropout off {r['ms_no_dropout']:.4f} ms"
            if "plain_ms_no_dropout" in r:
                extra += f" (plain {r['plain_ms_no_dropout']:.4f})"
        if "multihead_ms" in r:
            extra = f", the plain einsum path (fm_cross_multihead) {r['multihead_ms']:.4f} ms"
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"yardstick {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms{extra}")
        for row in r.get("large_k", []):
            log(f"[kernel] {r['name']} K={row['K']} B={row['B']}: {row['ms']:.4f} ms"
                + f" (dropout off {row['ms_no_dropout']:.4f})"
                + f", plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), yardstick {row['library_ms']:.4f} ms, "
                f"max_abs_err {row['max_abs_err']:.6g}")
    return results


LARGE_K = ((120, 8192), (152, 4096))  # (K, B): v3_k120_s1_tpu and v3_k148_s1_tpu


def large_k_rows(cfg, dev, g, results):
    """The four attention kernels at the larger-K configs' shapes (K =
    120 at B = 8192, K = 152 at B = 4096; D = 64, 8 heads, bf16, the last
    4 key columns masked): each against its plain version with dropout
    off and on, in the flagship rows' bands, timed beside the plain
    version, the bound and the flagship row's PyTorch yardstick at this
    shape (``F.scaled_dot_product_attention`` with the bias as
    ``attn_mask``, after the ``torch.matmul`` projection for the qkv
    kernels; the backwards' by autograd, no dropout, no dbias).  Appends a
    ``large_k`` list to each kernel's row."""
    import torch
    import torch.nn.functional as F

    from tossctr_tpu_torch.ops import (
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_qkv,
        fused_mha_qkv_bwd,
        fused_mha_qkv_bwd_reference,
        fused_mha_qkv_reference,
        fused_mha_reference,
    )

    from tossctr_tpu_torch.ops._build import ptxas_report

    bf, f32 = torch.bfloat16, torch.float32
    D, H = cfg.model.emb_dim, cfg.sequence.tfm.n_heads

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def hold(name, got, want, act):
        got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) \
            else want
        return max(check_close(f"{name} {i}", a, b, bf16_tolerance(b) if i in act
                               else WGRAD_BAND * float(b.abs().max()))
                   for i, (a, b) in enumerate(zip(got, want)))

    for K, B in LARGE_K:
        bias = rnd(K, K, std=0.5, dtype=f32)
        bias[:, K - 4:] = -1e9
        bias = bias.to(bf)
        x, do = rnd(B, K, D), rnd(B, K, D)
        wqkv, bqkv = rnd(D, 3 * D, std=D ** -0.5), rnd(3 * D, std=0.1, dtype=f32)
        q, k, v = rnd(B, K, D), rnd(B, K, D), rnd(B, K, D)

        def heads(t, B=B, K=K):
            return t.view(B, K, H, D // H).transpose(1, 2)

        def sdpa(q, k, v, B=B, K=K, bias=bias):
            o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=bias)
            return o.transpose(1, 2).reshape(B, K, D)

        def sdpa_qkv(x, w, b):
            return sdpa(*(torch.matmul(x, w) + b.to(bf)).split(D, -1))

        leaves = [t.detach().requires_grad_() for t in (x, wqkv, bqkv, q, k, v)]
        outs = (sdpa_qkv(*leaves[:3]), sdpa(*leaves[3:]))
        # each kernel's PyTorch yardstick at this shape, as at the flagship's
        library = {
            "fused_mha_qkv": lambda: sdpa_qkv(x, wqkv, bqkv),
            "fused_mha_qkv_bwd": lambda: torch.autograd.grad(outs[0], leaves[:3], do,
                                                             retain_graph=True),
            "fused_mha": lambda: sdpa(q, k, v),
            "fused_mha_bwd": lambda: torch.autograd.grad(outs[1], leaves[3:], do,
                                                         retain_graph=True),
        }
        cases = (
            ("fused_mha_qkv", fused_mha_qkv, fused_mha_qkv_reference, (x, wqkv, bqkv, bias, H),
             (0,), nbytes(x, wqkv, bqkv, bias) + nbytes(x), 2 * B * K * D * (3 * D + 2 * K)),
            ("fused_mha_qkv_bwd", fused_mha_qkv_bwd, fused_mha_qkv_bwd_reference,
             (x, wqkv, bqkv, bias, do, H), (0,),
             nbytes(x, wqkv, bqkv, bias, do) + nbytes(x) + 4 * (D * 3 * D + 3 * D + K * K),
             2 * B * K * D * 3 * D * 3 + 10 * B * K * K * D),
            ("fused_mha", fused_mha, fused_mha_reference, (q, k, v, bias, H), (0,),
             nbytes(q, k, v, bias) + nbytes(q), 4 * B * K * K * D),
            ("fused_mha_bwd", fused_mha_bwd, fused_mha_bwd_reference, (q, k, v, bias, do, H),
             (0, 1, 2), nbytes(q, k, v, bias, do) + 3 * nbytes(q) + 4 * K * K,
             10 * B * K * K * D),
        )
        for name, fn, plain, args, act, n_bytes, n_flops in cases:
            fwd = not name.endswith("_bwd")
            errs = []
            for p in (0.0, P_DROP):
                got = fn(*args, p, DROP_SEED)
                torch.cuda.synchronize()
                errs.append(hold(f"{name} K={K} p={p}", got, plain(*args, p, DROP_SEED), act))
                del got
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            row = dict(K=K, B=B, max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
                       ms=cuda_time_ms(lambda: fn(*args, P_DROP, DROP_SEED), iters=10),
                       plain_ms=cuda_time_ms(lambda: plain(*args, P_DROP, DROP_SEED), iters=3,
                                             warmup=1),
                       library_ms=cuda_time_ms(library[name], iters=10))
            row["ms_no_dropout"] = cuda_time_ms(lambda: fn(*args), iters=10)
            if not fwd:
                row["tflops"] = n_flops / row["ms"] * 1e-9
                row["share_of_bound"] = b_ms / row["ms"]
                # ptxas's report of the instantiations at K's padding (KP = 160:
                # the tensor-core form with dbias in device memory)
                kp = -(-K // 16) * 16 if K > 128 else 128
                row["build"] = {fn_: r for fn_, r in ptxas_report(name).items()
                                if f"_mmaILi{kp}E" in fn_}
                for fn_, r in row["build"].items():
                    log(f"[kernel] {name} K={K} build {fn_}: {r['registers']} registers, spill "
                        f"stores {r['spill_stores']} / loads {r['spill_loads']} bytes")
                log(f"[kernel] {name} K={K} B={B}: {row['tflops']:.4f} TFLOP/s, "
                    f"{row['share_of_bound']:.2%} of the bound")
            results[name].setdefault("large_k", []).append(row)
            torch.cuda.empty_cache()
        del bias, x, do, wqkv, bqkv, q, k, v, leaves, outs, library
        torch.cuda.empty_cache()


SWEEP_HOT = 150_000  # occurrences of the hot id (the pad id) in the "hot" case


def sweep_ids(kind, V, N, dev):
    """N update ids over V rows: uniform; zipf:1.0 through bench.py's
    truncated-Pareto inverse CDF and multiplicative-hash shuffle (the
    same arithmetic, in torch); or uniform with the pad id 0 SWEEP_HOT
    times, as a batch's empty slots bring it."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8)
    if kind == "zipf":
        u = torch.rand(N, generator=g, device=dev, dtype=torch.float64)
        ranks = torch.clamp(torch.exp(u * np.log(float(V))).long(), max=V - 1)
        return (ranks * 2654435761) % V
    ids = torch.randint(0, V, (N,), generator=g, device=dev)
    if kind == "hot":
        ids[torch.randperm(N, generator=g, device=dev)[:SWEEP_HOT]] = 0
    return ids


def sweep_kernel_row(cfg, dev):
    """``sweep_rows_add`` at the flagship's update: the lane-fused (V, 2D)
    bf16 table, N = B x K ids, fp32 deltas (as the AdaGrad step makes
    them), with uniform, zipf:1.0 and hot-id ids.  Each case against the
    plain version on copies of one table (bf16: one ulp of each element
    plus 1e-5 of the largest, as tests/test_torch_cuda_kernels.py), a
    second run bit-equal to the first, untouched rows unchanged; timed
    beside the plain version, ``Tensor.index_add_`` of the bf16 deltas
    (atomics, table-dtype sums: not bit-equal) and the bound (ids and
    deltas read once, each touched row read and written once; the sort's
    int32 permutation, which the kernel also reads, is left out of it);
    the wrapper's parts timed apart: the sort (``sort_ids``), the search
    (``piece_ends``) and the two kernels (``launch_sorted``)."""
    import torch

    from tossctr_tpu_torch.ops import sweep_rows_add, sweep_rows_add_reference

    sw = importlib.import_module("tossctr_tpu_torch.ops.sweep_scatter")

    V, W = cfg.model.seq_vocab, 2 * cfg.model.emb_dim
    K = -(-cfg.sequence.top_k // 8) * 8
    N = cfg.train.batch_size * K
    gen = torch.Generator(device=dev).manual_seed(9)
    table = torch.randn(V, W, generator=gen, device=dev).to(torch.bfloat16)
    deltas = torch.randn(N, W, generator=gen, device=dev) * 1e-3
    d_bf = deltas.to(torch.bfloat16)
    cases = []
    for kind in ("uniform", "zipf", "hot"):
        ids = sweep_ids(kind, V, N, dev)
        touched = torch.unique(ids)
        got, again, want = table.clone(), table.clone(), table.clone()
        sweep_rows_add([got], ids, [deltas])
        sweep_rows_add([again], ids, [deltas])
        sweep_rows_add_reference([want], ids, [deltas])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"sweep_rows_add {kind}: two runs differ")
        mask = torch.ones(V, dtype=torch.bool, device=dev)
        mask[touched] = False
        if not torch.equal(got[mask], table[mask]):
            raise AssertionError(f"sweep_rows_add {kind}: an untouched row changed")
        g_t, w_t = got[touched].float(), want[touched].float()
        err = float((g_t - w_t).abs().max())
        excess = (g_t - w_t).abs() - (2.0 ** -7 * torch.maximum(g_t.abs(), w_t.abs())
                                      + 1e-5 * float(w_t.abs().max()))
        if float(excess.max()) > 0:
            raise AssertionError(f"sweep_rows_add {kind}: {err} beyond one bf16 ulp")
        diff = float((g_t != w_t).float().mean())
        del again, want, mask, g_t, w_t
        n_bytes = ids.numel() * ids.element_size() + deltas.numel() * 4 + touched.numel() * W * 4
        b_ms, b_by = bound_ms(n_bytes, 0)
        ids_s, order = sw.sort_ids(ids, V)
        seg_end = sw.piece_ends(ids_s)
        case = dict(ids=kind, N=N, unique=touched.numel(), max_abs_err=err,
                    rows_differing_elements=diff, bound_ms=b_ms, bound_by=b_by,
                    ms=cuda_time_ms(lambda: sweep_rows_add([got], ids, [deltas]), iters=10),
                    sort_ms=cuda_time_ms(lambda: sw.sort_ids(ids, V), iters=10),
                    search_ms=cuda_time_ms(lambda: sw.piece_ends(ids_s), iters=10),
                    kernels_ms=cuda_time_ms(lambda: sw.launch_sorted([got], [deltas], ids_s, order,
                                                                     seg_end, V, W), iters=10),
                    plain_ms=cuda_time_ms(lambda: sweep_rows_add_reference([got], ids, [deltas]),
                                          iters=3, warmup=1),
                    library_ms=cuda_time_ms(lambda: got.index_add_(0, ids, d_bf), iters=10))
        cases.append(case)
        log(f"[kernel] sweep_rows_add V={V} W={W} N={N} ids={kind}: {case['unique']} unique; "
            f"max_abs_err {err:.6g} ({diff:.3%} of the touched elements one ulp apart; band one "
            f"bf16 ulp), repeats bit for bit; {case['ms']:.4f} ms (sort {case['sort_ms']:.4f}, "
            f"search {case['search_ms']:.4f}, kernels {case['kernels_ms']:.4f}), plain "
            f"{case['plain_ms']:.4f} ms, index_add_ {case['library_ms']:.4f} ms (atomic bf16 "
            f"sums: not bit-equal), bound {b_ms:.4f} ms ({b_by}; the 2 MB permutation left out)")
        del got, ids, touched, ids_s, order, seg_end
        torch.cuda.empty_cache()
    del table, deltas, d_bf
    torch.cuda.empty_cache()
    split = split_sweep_case(cfg, dev)
    head = cases[0]  # uniform ids: the headline row; every case beside it
    return dict(name="sweep_rows_add", route="cuda",
                source="tossctr_tpu_torch/csrc/sweep_rows_add.cu",
                replaces="tossctr_tpu/ops/pallas_scatter.py:224",
                max_abs_err=max([c["max_abs_err"] for c in cases] + [split["max_abs_err"]]),
                ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                library_call="Tensor.index_add_ of the bf16 deltas (atomics, bf16 sums)",
                cases=cases, split_tables=split)


def split_sweep_case(cfg, dev):
    """``sweep_rows_add`` at the split tables' update (``model.
    fused_seq_tables: false``): both (V, D) bf16 tables in one launch, N =
    B x K uniform ids, one fp32 delta a table (the AdaGrad step's), held
    against the plain version within one bf16 ulp per element as the fused
    cases, untouched rows unchanged, a second run bit-equal; timed beside
    the plain version, two ``index_add_`` calls of the bf16 deltas and the
    bound (ids and both deltas read once, each touched row of both tables
    read and written once)."""
    import torch

    from tossctr_tpu_torch.ops import sweep_rows_add, sweep_rows_add_reference

    V, D = cfg.model.seq_vocab, cfg.model.emb_dim
    K = -(-cfg.sequence.top_k // 8) * 8
    N = cfg.train.batch_size * K
    gen = torch.Generator(device=dev).manual_seed(10)
    tables = [torch.randn(V, D, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    deltas = [torch.randn(N, D, generator=gen, device=dev) * 1e-3 for _ in range(2)]
    d_bf = [x.to(torch.bfloat16) for x in deltas]
    ids = sweep_ids("uniform", V, N, dev)
    touched = torch.unique(ids)
    got, again, want = ([t.clone() for t in tables] for _ in range(3))
    sweep_rows_add(got, ids, deltas)
    sweep_rows_add(again, ids, deltas)
    sweep_rows_add_reference(want, ids, deltas)
    torch.cuda.synchronize()
    mask = torch.ones(V, dtype=torch.bool, device=dev)
    mask[touched] = False
    err = 0.0
    for t, (g, a, w) in enumerate(zip(got, again, want)):
        if not torch.equal(g, a) or not torch.equal(g[mask], tables[t][mask]):
            raise AssertionError(f"sweep_rows_add split table {t}: two runs differ, or an "
                                 "untouched row changed")
        g_t, w_t = g[touched].float(), w[touched].float()
        err = max(err, float((g_t - w_t).abs().max()))
        excess = (g_t - w_t).abs() - (2.0 ** -7 * torch.maximum(g_t.abs(), w_t.abs())
                                      + 1e-5 * float(w_t.abs().max()))
        if float(excess.max()) > 0:
            raise AssertionError(f"sweep_rows_add split table {t}: beyond one bf16 ulp")
    del again, want, mask
    n_bytes = ids.numel() * ids.element_size() + 2 * N * D * 4 + 2 * touched.numel() * D * 4
    b_ms, b_by = bound_ms(n_bytes, 0)

    def library():
        for g, x in zip(got, d_bf):
            g.index_add_(0, ids, x)

    case = dict(tables=2, V=V, D=D, N=N, ids="uniform", unique=touched.numel(),
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=cuda_time_ms(lambda: sweep_rows_add(got, ids, deltas), iters=10),
                plain_ms=cuda_time_ms(lambda: sweep_rows_add_reference(got, ids, deltas),
                                      iters=3, warmup=1),
                library_ms=cuda_time_ms(library, iters=10))
    log(f"[kernel] sweep_rows_add split tables 2 x ({V}, {D}) bf16, N={N} uniform ids, fp32 "
        f"deltas, one launch: {case['unique']} unique; max_abs_err {err:.6g} (band one bf16 "
        f"ulp), repeats bit for bit; {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, two "
        f"index_add_ {case['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del tables, deltas, d_bf, got, ids, touched
    torch.cuda.empty_cache()
    return case


def separate_kernel_rows(cfg, dev, g):
    """``fused_mha`` (attention on q, k, v (B, K, D)) and ``fused_ffn`` (x
    (B*K, D), F hidden units), forward and backward, at the flagship
    shapes in bf16 against their plain versions, with their yardsticks:
    ``F.scaled_dot_product_attention`` with the bias as ``attn_mask`` and
    the three-call FFN composite (``F.linear``, tanh ``F.gelu``,
    ``F.linear``), dropout off, and their autograd backwards."""
    import torch
    import torch.nn.functional as F

    from tossctr_tpu_torch.ops import (
        fused_ffn,
        fused_ffn_bwd,
        fused_ffn_bwd_reference,
        fused_ffn_reference,
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_reference,
    )

    bf, f32 = torch.bfloat16, torch.float32
    B, K, D = cfg.train.batch_size, -(-cfg.sequence.top_k // 8) * 8, cfg.model.emb_dim
    H, Fh = cfg.sequence.tfm.n_heads, cfg.sequence.tfm.ffn_hidden
    N = B * K

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    results = {}
    # ---- fused_mha: q, k, v (B, K, D), bias with -1e9 on the pad columns ----
    q, k, v = rnd(B, K, D), rnd(B, K, D), rnd(B, K, D)
    bias = rnd(K, K, std=0.5, dtype=f32)
    bias[:, cfg.sequence.top_k:] = -1e9
    bias = bias.to(bf)
    args = (q, k, v, bias, H)
    errs = {}
    for p in (0.0, P_DROP):
        got = fused_mha(*args, p, DROP_SEED)
        torch.cuda.synchronize()
        want = fused_mha_reference(*args, p, DROP_SEED)
        tol = bf16_tolerance(want)
        errs[p] = check_close(f"fused_mha p={p}", got, want, tol)
        log(f"[kernel] fused_mha B={B} K={K} D={D} H={H} bf16 p={p}: "
            f"max_abs_err={errs[p]:.6g} (tolerance {tol:.6g}); {spread(got, want)}")
    del got, want

    def heads(t):
        return t.view(B, K, H, D // H).transpose(1, 2)

    def sdpa(q, k, v):
        o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=bias)
        return o.transpose(1, 2).reshape(B, K, D)

    b_ms, b_by = bound_ms(nbytes(q, k, v, bias) + nbytes(q), 4 * B * K * K * D)
    results["fused_mha"] = dict(
        name="fused_mha", route="cuda", source="tossctr_tpu_torch/csrc/fused_mha.cu",
        replaces="tossctr_tpu/ops/pallas_attention.py:937",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_mha(*args, P_DROP, DROP_SEED)),
        plain_ms=cuda_time_ms(lambda: fused_mha_reference(*args, P_DROP, DROP_SEED)),
        ms_no_dropout=cuda_time_ms(lambda: fused_mha(*args)),
        plain_ms_no_dropout=cuda_time_ms(lambda: fused_mha_reference(*args)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(lambda: sdpa(q, k, v)),
        library_call="F.scaled_dot_product_attention(attn_mask=bias) on head views of q, k, v "
                     "and the merge of its heads, no dropout",
    )

    # ---- fused_mha backward, dropout on ----
    do = rnd(B, K, D)
    bw = (q, k, v, bias, do, H, P_DROP, DROP_SEED)
    got = fused_mha_bwd(*bw)
    torch.cuda.synchronize()
    want = fused_mha_bwd_reference(*bw)
    names = ("dq", "dk", "dv", "dbias")
    errs = {}
    for i, name in enumerate(names):
        band = bf16_tolerance(want[i]) if i < 3 else WGRAD_BAND * float(want[i].abs().max())
        errs[name] = check_close(f"fused_mha_bwd {name}", got[i], want[i], band)
    log(f"[kernel] fused_mha_bwd bf16 p={P_DROP}: max_abs_err "
        + ", ".join(f"{n}={e:.6g}" for n, e in errs.items())
        + f" (dq, dk, dv: 3 bf16 ulps; dbias: {WGRAD_BAND} of its largest magnitude); "
        + "; ".join(f"{n}: {spread(got[i], want[i])}" for i, n in enumerate(names)))
    del got, want
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qg, kg, vg)
    b_ms, b_by = bound_ms(nbytes(q, k, v, bias, do) + 3 * nbytes(q) + 4 * K * K,
                          mha_bwd_flops(B, K, D))
    results["fused_mha_bwd"] = dict(
        name="fused_mha_bwd", route="cuda", source="tossctr_tpu_torch/csrc/fused_mha_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_attention.py:985",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_mha_bwd(*bw)),
        ms_no_dropout=cuda_time_ms(lambda: fused_mha_bwd(*bw[:5], H)),
        plain_ms=cuda_time_ms(lambda: fused_mha_bwd_reference(*bw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)),
        library_call="backward of the F.scaled_dot_product_attention yardstick "
                     "(retain_graph; no dropout, no dbias)",
    )
    del q, k, v, do, out, qg, kg, vg, bw

    # ---- fused_ffn: x (B*K, D) ----
    fargs = (rnd(N, D), rnd(D, Fh, std=D ** -0.5), rnd(Fh, std=0.1, dtype=f32),
             rnd(Fh, D, std=Fh ** -0.5), rnd(D, std=0.1, dtype=f32))
    x, w1, b1, w2, b2 = fargs
    errs = {}
    for p in (0.0, P_DROP):
        got = fused_ffn(*fargs, p, DROP_SEED)
        torch.cuda.synchronize()
        want = fused_ffn_reference(*fargs, p, DROP_SEED)
        tol = bf16_tolerance(want)
        errs[p] = check_close(f"fused_ffn p={p}", got, want, tol)
        log(f"[kernel] fused_ffn N={N} D={D} F={Fh} bf16 p={p}: "
            f"max_abs_err={errs[p]:.6g} (tolerance {tol:.6g}); {spread(got, want)}")
    del got, want

    def ffn_composite(x, w1, b1, w2, b2):
        h = F.gelu(F.linear(x, w1.t(), b1.to(bf)), approximate="tanh")
        return F.linear(h, w2.t(), b2.to(bf))

    b_ms, b_by = bound_ms(nbytes(*fargs) + nbytes(x), 4 * N * D * Fh)
    results["fused_ffn"] = dict(
        name="fused_ffn", route="cuda", source="tossctr_tpu_torch/csrc/fused_ffn.cu",
        replaces="tossctr_tpu/ops/pallas_ffn.py:216",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_ffn(*fargs, P_DROP, DROP_SEED)),
        plain_ms=cuda_time_ms(lambda: fused_ffn_reference(*fargs, P_DROP, DROP_SEED)),
        ms_no_dropout=cuda_time_ms(lambda: fused_ffn(*fargs)),
        plain_ms_no_dropout=cuda_time_ms(lambda: fused_ffn_reference(*fargs)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(lambda: ffn_composite(*fargs)),
        library_call="composite of three calls: F.linear, F.gelu(approximate='tanh'), "
                     "F.linear, bf16, no dropout",
    )

    # ---- fused_ffn backward, dropout on ----
    dy = rnd(N, D)
    bw = (x, w1, b1, w2, dy, P_DROP, DROP_SEED)
    got = fused_ffn_bwd(*bw)
    torch.cuda.synchronize()
    want = fused_ffn_bwd_reference(*bw)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    errs = {}
    for i, name in enumerate(names):
        band = bf16_tolerance(want[i]) if i == 0 else WGRAD_BAND * float(want[i].abs().max())
        errs[name] = check_close(f"fused_ffn_bwd {name}", got[i], want[i], band)
    log(f"[kernel] fused_ffn_bwd bf16 p={P_DROP}: max_abs_err "
        + ", ".join(f"{n}={e:.6g}" for n, e in errs.items())
        + f" (dx: 3 bf16 ulps; the rest: {WGRAD_BAND} of each one's largest magnitude); "
        + "; ".join(f"{n}: {spread(got[i], want[i])}" for i, n in enumerate(names)))
    del got, want
    leaves = [t.detach().requires_grad_() for t in fargs]
    out = ffn_composite(*leaves)
    grad_bytes = 4 * (2 * D * Fh + Fh + D)
    b_ms, b_by = bound_ms(nbytes(x, w1, b1, w2, dy) + nbytes(x) + grad_bytes, 10 * N * D * Fh)
    results["fused_ffn_bwd"] = dict(
        name="fused_ffn_bwd", route="cuda", source="tossctr_tpu_torch/csrc/fused_ffn_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_ffn.py:246",
        max_abs_err=max(errs.values()), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_ffn_bwd(*bw)),
        plain_ms=cuda_time_ms(lambda: fused_ffn_bwd_reference(*bw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)),
        library_call="backward of the three-call FFN composite (retain_graph; no dropout)",
    )
    del fargs, x, w1, b1, w2, b2, dy, bw, leaves, out
    tensor_core_rows(results, {"fused_mha": 4 * B * K * K * D,
                               "fused_mha_bwd": mha_bwd_flops(B, K, D),
                               "fused_ffn": 4 * N * D * Fh, "fused_ffn_bwd": 10 * N * D * Fh})
    return results


def tensor_core_report(name, need_mma=True):
    """Registers, static shared memory and spills of each kernel in the
    library ``name`` (ptxas's report of its build) and, where the toolkit
    has ``cuobjdump``, the HMMA / HGMMA instructions in each kernel's SASS.
    With ``need_mma``, fails if ``cuobjdump`` finds no tensor-core
    instruction in the bf16 tensor-core kernel (its name holds ``_mma``)."""
    from tossctr_tpu_torch.ops._build import ptxas_report, sass_counts

    ptxas, sass = ptxas_report(name), sass_counts(name)
    report = {}
    for fn, r in sorted(ptxas.items()):
        ops = (sass or {}).get(fn)
        report[fn] = dict(r, **(ops or {}))
        log(f"[kernel] {name} build {fn}: {r['registers']} registers, {r['smem']} bytes static "
            f"shared memory, spill stores {r['spill_stores']} / loads {r['spill_loads']} bytes; "
            + ("SASS " + ", ".join(f"{op} {n}" for op, n in ops.items()) if ops is not None
               else "SASS not read (no cuobjdump)"))
    if need_mma and sass is not None:
        mma = [fn for fn in sass if "_mma" in fn]
        if not mma or any(sum(sass[fn].values()) == 0 for fn in mma):
            raise AssertionError(f"{name}: no tensor-core instruction in the bf16 kernels {mma}")
    return report


def fm_kernel_rows(cfg, dev, g):
    """The FM-cross pair at the flagship's QNN shapes: z (B, F, D) with F =
    1 + 2 x N_NUM + the categorical columns tokens of width D = emb_dim,
    against the plain versions in bf16 (timed) and fp32."""
    import torch

    from tossctr_tpu_torch.ops import (
        fm_cross_multihead,
        fm_cross_pallas,
        fm_cross_pallas_bwd,
        fm_cross_pallas_bwd_reference,
        fm_cross_pallas_reference,
    )
    from tossctr_tpu_torch.ops.fm_cross import fm_cross_pallas_fwd, fm_mma_kernel

    qa = cfg.model.qnn_alpha
    B, D = cfg.train.batch_size, cfg.model.emb_dim
    F = 1 + 2 * N_NUM + len(cfg.data.cat_cols)
    H, R, P = qa.heads, qa.rank, qa.proj_dim
    if not fm_mma_kernel(torch.bfloat16, D, H, R, P):
        raise AssertionError(f"the flagship's QNN shape (D={D} H={H} R={R} P={P}) does not "
                             f"route to the FM tensor-core kernels")
    out, errs = {}, {}

    def inputs(dtype):
        z = torch.randn(B, F, D, generator=g, device=dev)
        U = torch.randn(H, D, R, generator=g, device=dev) * 0.02  # the init's scale
        V = torch.randn(H, R, P, generator=g, device=dev) * 0.02
        gr = torch.randn(B, H * P, generator=g, device=dev)
        return [t.to(dtype) for t in (z, U, V, gr)]

    for dtype in (torch.float32, torch.bfloat16):
        z, U, V, gr = inputs(dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        got = fm_cross_pallas_fwd(z, U, V)
        dgot = fm_cross_pallas_bwd(z, U, V, gr)
        torch.cuda.synchronize()
        want = fm_cross_pallas_reference(z, U, V)
        dwant = fm_cross_pallas_bwd_reference(z, U, V, gr)
        pairs = [("out", got, want, True), ("dz", dgot[0], dwant[0], True),
                 ("dU", dgot[1], dwant[1], False), ("dV", dgot[2], dwant[2], False)]
        for name, a, b, act in pairs:
            top = float(b.float().abs().max())
            band = (FP32_BAND * max(top, 1.0) if dtype == torch.float32
                    else bf16_tolerance(b) if act else WGRAD_BAND * top)
            errs[(tag, name)] = check_close(f"fm_cross {tag} {name}", a, b, band)
            log(f"[kernel] fm_cross {tag} {name} B={B} F={F} D={D} H={H} R={R} P={P}: "
                f"max_abs_err={errs[(tag, name)]:.6g} (band {band:.6g}); {spread(a, b)}")
        del got, dgot, want, dwant
    # z, U, V, gr are the bf16 inputs: time those
    zb = 2
    flops_a = 2 * B * F * D * H * R
    fwd_bytes = zb * (z.numel() + U.numel() + V.numel() + B * H * P)
    fwd_flops = flops_a + 3 * B * F * H * R + 2 * B * H * R * P
    b_ms, b_by = bound_ms(fwd_bytes, fwd_flops)
    out["fm_cross_pallas"] = dict(
        name="fm_cross_pallas", route="cuda", source="tossctr_tpu_torch/csrc/fm_cross.cu",
        replaces="tossctr_tpu/ops/pallas_kernels.py:147",
        max_abs_err=max(v for (t, n), v in errs.items() if t == "bf16" and n == "out"),
        max_abs_err_fp32=errs[("fp32", "out")],
        ms=cuda_time_ms(lambda: fm_cross_pallas_fwd(z, U, V)),
        plain_ms=cuda_time_ms(lambda: fm_cross_pallas_reference(z, U, V)),
        multihead_ms=cuda_time_ms(lambda: fm_cross_multihead(z, U, V)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    bwd_bytes = zb * (2 * z.numel() + U.numel() + V.numel() + gr.numel()) + 4 * (
        U.numel() + V.numel())
    bwd_flops = 3 * flops_a + 4 * B * H * R * P + 6 * B * F * H * R
    b_ms, b_by = bound_ms(bwd_bytes, bwd_flops)
    zl, Ul, Vl = (t.detach().requires_grad_() for t in (z, U, V))
    ref_out = fm_cross_multihead(zl, Ul, Vl)
    out["fm_cross_pallas_bwd"] = dict(
        name="fm_cross_pallas_bwd", route="cuda", source="tossctr_tpu_torch/csrc/fm_cross_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_kernels.py:173",
        max_abs_err=max(v for (t, n), v in errs.items() if t == "bf16" and n != "out"),
        max_abs_err_fp32=max(v for (t, n), v in errs.items() if t == "fp32" and n != "out"),
        ms=cuda_time_ms(lambda: fm_cross_pallas_bwd(z, U, V, gr)),
        plain_ms=cuda_time_ms(lambda: fm_cross_pallas_bwd_reference(z, U, V, gr)),
        multihead_ms=cuda_time_ms(
            lambda: torch.autograd.grad(ref_out, (zl, Ul, Vl), gr, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    del z, U, V, gr, zl, Ul, Vl, ref_out
    tensor_core_rows(out, {"fm_cross_pallas": fwd_flops, "fm_cross_pallas_bwd": bwd_flops},
                     libs={"fm_cross_pallas": "fm_cross", "fm_cross_pallas_bwd": "fm_cross_bwd"})
    for r in out.values():
        log(f"[kernel] {r['name']} bf16: {r['bound_ms'] / r['ms']:.2%} of the bound; the plain "
            f"einsum path (fm_cross_multihead{', autograd' if 'bwd' in r['name'] else ''}) "
            f"{r['multihead_ms']:.4f} ms, {r['multihead_ms'] / r['ms']:.2f}x the kernel's time")
    # the autograd wrapper's backward is the kernel
    z, U, V, gr = (t.requires_grad_(i < 3) for i, t in enumerate(inputs(torch.bfloat16)))
    before = fm_cross_pallas_bwd.launches
    fm_cross_pallas(z, U, V).backward(gr)
    torch.cuda.synchronize()
    if fm_cross_pallas_bwd.launches != before + 1 or U.grad.dtype != U.dtype:
        raise AssertionError("fm_cross_pallas's backward did not run its kernel")
    return out


def write_checkpoints(cfg, dims, dev):
    import torch

    from tossctr_tpu_torch.eval.calibration import Calibrator, TemperatureScaler
    from tossctr_tpu_torch.models import build_model, init_params
    from tossctr_tpu_torch.train.checkpoint import save_fold_checkpoint

    for fold in range(N_FOLDS):
        t0 = time.time()
        model = init_params(build_model(cfg, dims, dev), seed=1000 + fold)
        cal = Calibrator("temperature")
        cal.temp_scaler = TemperatureScaler(T=1.2 + 0.3 * fold)
        save_fold_checkpoint(cfg.exp_dir(), fold, state_dict=model.state_dict(),
                             cfg_dict=cfg.to_dict(), best_score=0.35 + 0.01 * fold,
                             epoch=1, global_step=0, calibrator=cal)
        del model
        torch.cuda.empty_cache()
        log(f"[serve] fold {fold} checkpoint written in {time.time() - t0:.1f} s")


def check_submission(path, cache):
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["ID", "clicked"]:
        raise AssertionError(f"bad submission header {rows[0]}")
    ids = [r[0] for r in rows[1:]]
    probs = np.array([float(r[1]) for r in rows[1:]])
    if len(ids) != len(cache) or len(set(ids)) != len(cache):
        raise AssertionError(f"submission has {len(ids)} rows, {len(set(ids))} unique ids, "
                             f"want {len(cache)}")
    if not (np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()):
        raise AssertionError("submission probabilities are not all finite and in (0, 1)")
    return probs


def reference_check(cfg, cache, dev, rows=512, tag="check"):
    """One fold on the card (kernels) against the same fold on the CPU
    (plain PyTorch path) on one batch.  Both run bf16; their bf16
    rounding differs, so probabilities are held to the CPU tests' band."""
    import torch

    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.infer import load_fold_models

    batch = next(iter(BatchIterator(cache, batch_size=rows)))
    tb = {k: torch.from_numpy(batch[k]) for k in ("X_num", "X_mask", "X_cat", "seq")}
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        models, _, _ = load_fold_models(cfg, cache.dims, device=device)
        with torch.inference_mode():
            z, p, _ = models[0]({k: v.to(device) for k, v in tb.items()})
        out[name] = (z.cpu().numpy(), p.cpu().numpy())
        del models
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dz = float(np.abs(out["card"][0] - out["cpu"][0]).max())
    dp = float(np.abs(out["card"][1] - out["cpu"][1]).max())
    log(f"[{tag}] fold 0 on {rows} rows, card kernels vs CPU plain path: "
        f"max |dlogit|={dz:.5g}, max |dprob|={dp:.5g} (band 0.02)")
    if not (np.isfinite(out["card"][0]).all() and dp < 0.02):
        raise AssertionError("card output disagrees with the CPU plain path")
    return dz, dp


def throughput_and_profile(cfg, cache, dev):
    """Steady-state serving rate of the loaded folds over the whole cache
    (host batching and transfers included), then one more pass under
    torch.profiler: device time by kernel, and the device's busy share
    of that pass's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.infer import load_fold_models

    models, _, _ = load_fold_models(cfg, cache.dims, device=dev)
    loader = BatchIterator(cache, batch_size=cfg.train.batch_size)
    keys = ("X_num", "X_mask", "X_cat", "seq")

    def run_all():
        t0 = time.perf_counter()
        for batch in loader:
            tb = {k: torch.from_numpy(batch[k]).to(dev) for k in keys}
            for m in models:
                m(tb)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        run_all()  # warm
        wall = run_all()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_wall = run_all()
    events = prof.key_averages()
    device_s = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e6
    table = events.table(sort_by="cuda_time_total", row_limit=25, max_name_column_width=60)
    log(f"[profile] the {len(loader)} batches x {N_FOLDS} folds, by device time:")
    for line in table.splitlines():
        log("  " + line)
    log(f"[profile] device busy {device_s:.4f} s of {prof_wall:.4f} s wall = "
        f"{device_s / prof_wall:.1%} (under the profiler)")
    log(f"[serve] steady state: {len(cache)} rows x {N_FOLDS} folds in {wall:.3f} s = "
        f"{len(cache) / wall:.1f} examples/s ensembled "
        f"({N_FOLDS * len(cache) / wall:.1f} fold-examples/s)")
    return len(cache) / wall


def no_kernel_dropouts(d):
    """The config mapping with every dropout but the kernels' off."""
    d = copy.deepcopy(d)
    d["model"].update(dare_dropout=0.0, embedding_dropout=0.0)
    d["model"]["qnn_alpha"]["dropout"] = 0.0
    return d


def to_device(batch, dev):
    import torch

    keys = ("X_num", "X_mask", "X_cat", "seq", "y", "valid")
    return {k: torch.from_numpy(batch[k]).to(dev, non_blocking=True) for k in keys if k in batch}


def selected_ids(model, batch):
    """The table ids the batch's forward selects (dropout does not touch
    the selection)."""
    import torch

    taps = {}
    with torch.no_grad():
        model(batch, taps=taps)
    return taps["sel_ids"]


def trainer_for(cfg, model):
    from tossctr_tpu_torch.train.trainer import make_optimizer, make_train_state, make_train_step

    # one step an "epoch": the schedule's warmup (2 epochs) ends at step 2,
    # so these few steps run at the configured lr (bench.py's 1000 would
    # hold them in warmup, at 1/1000 of it)
    tx, schedule = make_optimizer(cfg, steps_per_epoch=1)
    state = make_train_state(cfg, model, tx)
    step = make_train_step(model, tx, cfg, base_seed=1, schedule=schedule)
    return state, step


def must_change(cfg):
    """The state the first step must change, by the table update: the one
    it writes without atomics.  Exact dedup writes the accumulator with
    ``index_copy_``, the sweep the table through ``sweep_rows_add``, and
    sparse SGD keeps only the table.  The streaming scatter adds into both
    with atomics, and an fp32 atomic add flushes a subnormal square to
    zero (which cannot change a step: AdaGrad's eps dwarfs its square
    root), so there either one will do."""
    t = cfg.train
    if t.embedding_optimizer not in ("rowwise_adagrad", "sparse_sgd"):  # dense-mode tables
        return "table"
    if t.embedding_optimizer == "sparse_sgd":
        return "table"
    if t.extra.get("exact_dedup", False):
        return "accumulator"
    return "table" if t.extra.get("table_update", "auto") == "sweep" else "table or accumulator"


def accum_rows(state, name, table):
    """The AdaGrad accumulator of the sequence table ``name`` as (V,
    halves), or a (V, 1) zero stand-in where the mode keeps none."""
    import torch

    opt = state.table_opt.get(name)
    if opt is None:
        return torch.zeros(table.shape[0], 1, device=table.device)
    return opt.accum.view(opt.accum.shape[0], -1)


def first_step(cfg, model, state, step, batch, tag, require_change=True):
    """The first train step, checked: it changes only table rows the batch
    selected, never the pad row, and (``require_change``) some dense
    parameters and some rows of what ``must_change`` names.  Every
    sequence table counts: the lane-fused one, or the split pair.  In the
    dense-table modes too, on bf16 tables: a first step's decay of an
    unselected row (lr x weight decay, 3e-8 relative at the flagship's)
    is far below half a bf16 ulp, and its Adam, Adafactor or SGD step is
    0.  -> (state, loss)."""
    import torch

    from tossctr_tpu_torch.train.trainer import dense_params, is_sparse_mode, seq_tables

    tables = seq_tables(model)
    accums = {n: accum_rows(state, n, t) for n, t in tables.items()}
    sel = selected_ids(model, batch)
    before = {n: t.detach().clone() for n, t in tables.items()}
    acc_before = {n: a.clone() for n, a in accums.items()}
    dense_before = torch.cat([p.detach().reshape(-1).float() for p in dense_params(model).values()])
    t0 = time.time()
    state, loss = step(state, batch)
    first = float(loss)
    log(f"[{tag}] step 1: loss {first:.6f}, {time.time() - t0:.2f} s (first call)")
    dense_after = torch.cat([p.detach().reshape(-1).float() for p in dense_params(model).values()])
    dense_moved = int((dense_after != dense_before).sum())

    def rows_where(diff):
        return torch.unique(torch.cat([torch.nonzero(d.reshape(d.shape[0], -1).any(dim=1))[:, 0]
                                       for d in diff]))

    changed = rows_where([t != before[n] for n, t in tables.items()])
    acc_changed = rows_where([a != acc_before[n] for n, a in accums.items()])
    pad = cfg.sequence.pad_id
    touched = torch.unique(sel)
    touched = touched[touched != pad]
    outside = changed[~torch.isin(changed, touched)]
    pad_moved = any(bool((t[pad] != before[n][pad]).any() or
                         (accums[n][pad] != acc_before[n][pad]).any())
                    for n, t in tables.items())
    kept = state.table_opt and is_sparse_mode(cfg)
    log(f"[{tag}] step 1: {dense_moved} of {dense_before.numel()} dense parameters moved; the "
        f"batch selected {touched.numel()} distinct non-pad ids; "
        + (f"{acc_changed.numel()} rows of the fp32 AdaGrad accumulators changed, "
           f"{int((~torch.isin(acc_changed, touched)).sum())} of them not selected; "
           if kept else f"no accumulator ({cfg.train.embedding_optimizer}); ")
        + f"{changed.numel()} rows of the {'/'.join(tables)} table(s) changed, {outside.numel()} "
        f"of them not selected; pad row changed: {pad_moved}")
    need = must_change(cfg)
    moved = {"accumulator": acc_changed.numel(), "table": changed.numel(),
             "table or accumulator": acc_changed.numel() + changed.numel()}[need]
    log(f"[{tag}] step 1 must change some rows of the {need}: {moved}")
    if require_change and dense_moved == 0:
        raise AssertionError(f"{tag}: the step moved no dense parameter")
    if ((require_change and moved == 0) or outside.numel() or pad_moved
            or not bool(torch.isin(acc_changed, touched).all())):
        raise AssertionError(f"{tag}: the table update touched rows it should not have, or "
                             "none it should")
    return state, first


def training_phase(cfg, cache, dev):
    """Full-width train steps over rotating batches: the RMSNorm flagship's
    training path."""
    import torch

    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train.trainer import build_model

    t0 = time.time()
    model = init_params(build_model(cfg, cache.dims, dev), seed=2024)
    state, step = trainer_for(cfg, model)
    loader = BatchIterator(cache, batch_size=cfg.train.batch_size, train=True, shuffle=True,
                           seed=cfg.seed, drop_last=cfg.train.drop_partial_batch)
    batches = [to_device(b, dev) for b in loader]
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"[train] model {n_par / 1e6:.1f}M parameters, {len(batches)} batches of "
        f"{cfg.train.batch_size} on the card, set-up {time.time() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    state, first = first_step(cfg, model, state, step, batches[0], "train")
    state, loss = step(state, batches[1 % len(batches)])  # warm
    float(loss)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, batches[(i + 2) % len(batches)])
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses = [float(x) for x in losses]
    per_step = 1e3 * wall / TRAIN_STEPS
    log(f"[train] {TRAIN_STEPS} steps: {per_step:.2f} ms/step, "
        f"{TRAIN_STEPS * cfg.train.batch_size / wall:.1f} examples/s (B={cfg.train.batch_size}, "
        f"no claim), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] losses {[round(x, 6) for x in losses]}")
    expected = {k: 3 * TRAIN_STEPS if k in RMS_ENCODER else 0 for k in launches}
    log(f"[train] launches during the {TRAIN_STEPS} steps: {launches}, expected {expected} "
        f"(3 layers a step; the QNN takes its plain path without model.extra.use_pallas_fm)")
    if not all(np.isfinite(losses)) or not np.isfinite(first):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")

    profile_step(state, step, batches[0], "train")
    del state, step, model, batches
    torch.cuda.empty_cache()
    return launches


# the class utils/trace.py must give each of the port's kernels, by the
# start of its name in the trace (the __global__ functions of csrc/)
PORT_KERNEL_CLASSES = {
    "mha_qkv_fwd": "attention", "mha_qkv_bwd": "attention", "mha_fwd": "attention",
    "mha_bwd": "attention", "block_tail_fwd": "custom_call", "block_tail_bwd": "custom_call",
    "tail_fwd_mma": "custom_call", "tail_bwd_mma": "custom_call", "ffn_fwd": "custom_call",
    "ffn_bwd": "custom_call", "fm_fwd": "custom_call", "fm_bwd": "custom_call",
    "fm_dv": "custom_call", "reduce_partials": "custom_call", "attn_dump": "custom_call",
    "ffn_dump": "custom_call", "sweep_pieces": "table_update", "sweep_merge": "table_update",
    "sweep_kernel": "table_update",
}
# the kernels a wrapper's launch puts in the trace (PORT_KERNEL_CLASSES
# keys; either form where the wrapper has a CUDA-core and a tensor-core one)
WRAPPER_KERNELS = {
    "fused_mha_qkv": ("mha_qkv_fwd",), "fused_mha_qkv_bwd": ("mha_qkv_bwd",),
    "fused_block_tail": ("block_tail_fwd", "tail_fwd_mma"),
    "fused_block_tail_bwd": ("block_tail_bwd", "tail_bwd_mma"), "fused_mha": ("mha_fwd",),
    "fused_mha_bwd": ("mha_bwd",), "fused_ffn": ("ffn_fwd",), "fused_ffn_bwd": ("ffn_bwd",),
    "fm_cross_pallas": ("fm_fwd",), "fm_cross_pallas_bwd": ("fm_bwd",),
    "sweep_rows_add": ("sweep_pieces",), "dense_sweep": ("sweep_kernel",),
    "sparse_sweep": ("sweep_kernel",), "dump_attention_keep": ("attn_dump",),
    "dump_ffn_keep": ("ffn_dump",),
}
BREAKDOWN_BAND = 0.02  # the kept events' total against the profiler's device time


def port_kernel_of(name):
    """The key of PORT_KERNEL_CLASSES that starts a word of a kernel's
    name, or None."""
    for k in PORT_KERNEL_CLASSES:
        if re.search(r"\b" + k, name):
            return k
    return None


def step_breakdown(prof, device_ms, tag, launched):
    """The profiled step's trace folded into ``utils/trace.py``'s classes:
    prints ms per class (one step, so ms per step) and the top 10 kernels,
    and holds that the classes sum to the kept events' total, that this
    total is within BREAKDOWN_BAND of the profiler's device time
    (``device_ms``), that each wrapper's launches in the window
    (``launched``: {wrapper: launches}) put as many of its kernels in the
    trace (WRAPPER_KERNELS), and that each of the port's kernels in the
    trace lands in its class of PORT_KERNEL_CLASSES."""
    from tossctr_tpu_torch.utils import trace

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trace_", dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "step.json")
        prof.export_chrome_trace(path)
        events = trace.load_device_events(path)
    breakdown = trace.op_time_breakdown(events)
    top = trace.top_ops_detailed(events, n=10)
    kept_ms = sum(float(e.get("dur", 0.0)) for e in events) / 1e3
    span_ms = (max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in events), default=0.0)
               - min((float(e["ts"]) for e in events), default=0.0)) / 1e3
    log(f"[breakdown] {tag} step: {len(events)} device events, {kept_ms:.3f} ms over a span "
        f"of {span_ms:.3f} ms (the profiler's device time {device_ms:.3f} ms); ms per step by "
        f"class: "
        + json.dumps({k: round(v, 4) for k, v in breakdown.items()})
        + f" (export and parse {time.perf_counter() - t0:.1f} s)")
    for d in top:
        log(f"[breakdown] {tag}   {d['ms']:9.4f} ms {d['calls']:5d}x {d['class']:<18} "
            f"{d['name'][:90]}  <- {d['op'][:40]} {d['input_dims'][:80]}")
    if abs(sum(breakdown.values()) - kept_ms) > 1e-6 * max(kept_ms, 1.0):
        raise AssertionError(f"{tag}: the classes sum to {sum(breakdown.values())} ms, the "
                             f"kept events to {kept_ms} ms")
    if abs(kept_ms - device_ms) > BREAKDOWN_BAND * device_ms:
        raise AssertionError(f"{tag}: the trace's device events total {kept_ms:.3f} ms, "
                             f"the profiler's device time {device_ms:.3f} ms: more than "
                             f"{BREAKDOWN_BAND:.0%} apart")
    seen, counts, wrong = {}, {}, []
    for e in events:
        k = port_kernel_of(str(e.get("name", "")))
        if k is None:
            continue
        got = trace.classify_op(e["name"], e["op"], e["input_dims"], e["cat"])
        seen[k] = got
        counts[k] = counts.get(k, 0) + 1
        if got != PORT_KERNEL_CLASSES[k]:
            wrong.append((e["name"][:80], got, PORT_KERNEL_CLASSES[k]))
    in_trace = {w: sum(counts.get(k, 0) for k in WRAPPER_KERNELS[w]) for w in launched}
    log(f"[breakdown] {tag}: the port's kernels in the trace and their classes: {seen}; the "
        f"wrappers' launches in the window {launched}, their kernels' events {in_trace}")
    missing = {w: (n, in_trace[w]) for w, n in launched.items() if in_trace[w] < n}
    if not launched or missing:
        raise AssertionError(f"{tag}: the step's trace lacks launched kernels "
                             f"(wrapper: launches, events): {missing or launched}")
    if wrong:
        raise AssertionError(f"{tag}: port kernels in the wrong class (name, got, want): {wrong}")
    return breakdown


def profiled_step(state, step, batch):
    """One train step under torch.profiler (shapes recorded) -> (state,
    the profile, the step's wall seconds, {wrapper: launches in the
    window}, the profile's kernel events of each launching wrapper)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tossctr_tpu_torch.ops import launch_counts

    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in launch_counts().items() if n > before[k]}
    counts = {}
    for e in prof.key_averages():
        k = port_kernel_of(e.key) if e.device_type == DeviceType.CUDA else None
        if k is not None:
            counts[k] = counts.get(k, 0) + e.count
    recorded = {w: sum(counts.get(k, 0) for k in WRAPPER_KERNELS[w]) for w in launched}
    return state, prof, wall, launched, recorded


def profile_step(state, step, batch, tag):
    """One train step under torch.profiler (``profiled_step``): device time
    by kernel, the device's busy share of the step's wall time, the
    port's kernels' share of the device time, and the step's breakdown by
    class (``step_breakdown``).  The device time leaves out the
    ``record_function`` ranges' device spans, which cover kernels already
    counted (the sum with them is printed beside).  A profile whose record
    lacks kernels the window launched is a fault of the profiler's record
    (seen once on the card: every kernel's time about 1/23 of its own and
    the forward's kernels gone, the host's ops all there): the next step
    is then profiled in its place, once; ``step_breakdown`` fails if that
    record lacks them too."""
    from torch.autograd import DeviceType

    state, prof, prof_wall, launched, recorded = profiled_step(state, step, batch)
    if any(recorded[w] < n for w, n in launched.items()):
        log(f"[profile] {tag} step: the profiler's record lacks launched kernels (wrapper: "
            f"launches {launched}, kernel events {recorded}); profiling the next step instead")
        state, prof, prof_wall, launched, recorded = profiled_step(state, step, batch)
    events = prof.key_averages()
    dev_all = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_events = [e for e in dev_all if not getattr(e, "is_user_annotation", False)]
    device_s = sum(e.self_device_time_total for e in dev_events) / 1e6
    ranges_s = sum(e.self_device_time_total for e in dev_all) / 1e6 - device_s
    ours_s = sum(e.self_device_time_total for e in dev_events
                 if port_kernel_of(e.key) is not None) / 1e6
    table_txt = events.table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=60)
    log(f"[profile] one {tag} step, by device time:")
    for line in table_txt.splitlines():
        log("  " + line)
    log(f"[profile] {tag} step: device busy {1e3 * device_s:.3f} ms of {1e3 * prof_wall:.3f} ms "
        f"wall = {device_s / prof_wall:.1%} (under the profiler); the port's kernels "
        f"{1e3 * ours_s:.3f} ms = {ours_s / max(device_s, 1e-12):.1%} of device time; the "
        f"record_function ranges' device spans {1e3 * ranges_s:.3f} ms more (not counted)")
    step_breakdown(prof, 1e3 * device_s, tag, launched)
    return state


def fold_phase(tmp, test_man, dev):
    """The K-fold entry point at full width: ``train_main`` on the flagship
    config with the FM-cross kernels (``model.extra.use_pallas_fm``) over
    a synthetic train cache, cut to one fold of five, two epochs and
    FOLD_ROWS rows; a second ``train_main``, through the CLI, skips the
    finished fold; ``infer_main`` serves the checkpoint.  Checks the
    train log, the checkpoint, the submission and every kernel's launches
    (training steps, validation and serving batches); reports wall time,
    ms/step and the device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.dataset import load_labels_groups_for_split
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.cv_split import StratifiedGroupKFold

    d = flagship_config_dict()
    epochs_cfg = d["train"]["epochs"]
    d["exp_name"] = "chip_fold"
    d["model"].setdefault("extra", {})["use_pallas_fm"] = True
    d["cv"]["n_splits"] = 1
    d["train"]["epochs"] = FOLD_EPOCHS
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    t0 = time.time()
    d["data"]["manifest_train"] = write_synth_cache_for(
        Config.from_dict(copy.deepcopy(d)), os.path.join(tmp, "cache", "fold_train"), FOLD_ROWS,
        num_dim=N_NUM, seed=23)
    d["data"]["manifest_test"] = test_man
    cfg = Config.from_dict(d)
    B = cfg.train.batch_size
    log(f"[fold] cuts: cv.n_splits 1 (the first of max(5, n_splits) = 5 folds; configured "
        f"{flagship_config_dict()['cv']['n_splits']}), train.epochs {FOLD_EPOCHS} (configured "
        f"{epochs_cfg}), {FOLD_ROWS} synthetic train rows; step checkpointing on as configured; "
        f"model.extra.use_pallas_fm true; cache written in {time.time() - t0:.1f} s")

    # the split the loop will make, for the expected launch counts
    t0 = time.perf_counter()
    y, groups = load_labels_groups_for_split(cfg.data.manifest_train)
    tr, va = next(StratifiedGroupKFold(5, shuffle=True, random_state=cfg.seed)
                  .split(np.zeros_like(y), y, groups))
    split_s = time.perf_counter() - t0
    steps = FOLD_EPOCHS * -(-len(tr) // B)
    val_batches = FOLD_EPOCHS * -(-len(va) // B)
    n_layers = cfg.sequence.tfm.n_layers

    epochs = []  # (examples, seconds) of each epoch's steps, from the loop's own counter

    class Recording(trainer.Logger):
        def throughput(self, tag, step, examples, seconds):
            epochs.append((examples, seconds))
            super().throughput(tag, step, examples, seconds)

    # wall time of the loop's parts, read through the names it calls
    spent = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return run

    parts = ("init_params", "run_validation", "save_fold_checkpoint", "save_train_state")
    real = {n: getattr(trainer, n) for n in parts}
    trainer.Logger, real_logger = Recording, trainer.Logger
    for n in parts:
        setattr(trainer, n, timed(n, real[n]))
    try:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            exp = trainer.train_main(cfg, device=dev)
            torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
    finally:
        trainer.Logger = real_logger
        for n, fn in real.items():
            setattr(trainer, n, fn)
    want = {"fm_cross_pallas": steps + val_batches, "fm_cross_pallas_bwd": steps}
    for k in counts:
        if k not in want:
            want[k] = (n_layers * (steps if k.endswith("_bwd") else steps + val_batches)
                       if k in RMS_ENCODER else 0)
    log(f"[fold] train_main: {len(tr)} train rows, {len(va)} validation rows, {steps} steps and "
        f"{val_batches} validation batches in {wall:.2f} s (under a device-only profiler); "
        f"launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"fold launches {counts} != {want}")
    for i, (ex, sec) in enumerate(epochs, 1):
        log(f"[fold] epoch {i}: {ex // B} steps in {sec:.3f} s = {1e3 * sec / (ex // B):.2f} "
            f"ms/step, {ex / sec:.1f} examples/s (host input, steps and transfers)")
    step_s = sum(sec for _, sec in epochs)
    log(f"[fold] train_main's {wall:.2f} s: the steps {step_s:.2f} s, "
        + ", ".join(f"{n} {v:.2f} s" for n, v in spent.items())
        + f", the rest (the split, ~{split_s:.2f} s apart, the model build, calibration, "
        f"logs) {wall - step_s - sum(spent.values()):.2f} s")
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in events) / 1e6
    fm_s = sum(e.self_device_time_total for e in events
               if "fm_fwd" in e.key or "fm_bwd" in e.key or "fm_dv" in e.key) / 1e6
    copy_s = sum(e.self_device_time_total for e in events if "Memcpy" in e.key) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[fold] device time {device_s:.4f} s of {wall:.2f} s wall, {copy_s:.4f} s of it copies "
        f"(the checkpoints' device-to-host reads among them); the FM-cross kernels "
        f"{fm_s:.4f} s = {fm_s / max(device_s, 1e-12):.2%} of it, "
        f"{fm_s / max(device_s - copy_s, 1e-12):.2%} of the time outside copies; by kernel: "
        + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms" for e in top))
    with open(os.path.join(exp, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        log(f"[fold] train_log.csv: " + ", ".join(f"{k}={v}" for k, v in r.items()))
    if [(r["epoch"], r["split"]) for r in rows] != [
            (str(e), s) for e in range(1, FOLD_EPOCHS + 1) for s in ("val", "val_cal")]:
        raise AssertionError(f"train_log.csv rows {rows}")
    if not all(np.isfinite(float(r[k])) for r in rows for k in ("AP", "WLL", "Score")):
        raise AssertionError("non-finite validation metrics")
    ck = os.path.join(exp, "ckpt_folds_0")
    files = sorted(os.listdir(ck))
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    log(f"[fold] checkpoint {ck}: {files}; best epoch {meta['epoch']}, score {meta['score']:.6f}")
    if files != ["calibrator.json", "ema.pt", "meta.json", "params.pt"] or os.path.exists(
            os.path.join(exp, "fold_0_state.pt")):
        raise AssertionError("the fold checkpoint is not complete")

    # the CLI again: the finished fold is skipped
    cfg_path = os.path.join(tmp, "chip_fold.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "tossctr_tpu_torch.train", "--cfg", cfg_path,
                        "--device", dev.type],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(f"[fold] python -m tossctr_tpu_torch.train --cfg {cfg_path} again: exit {r.returncode} "
        f"in {time.time() - t0:.1f} s: {' | '.join(r.stdout.strip().splitlines())}")
    if r.returncode != 0 or "split=skip" not in r.stdout:
        raise AssertionError(f"the CLI did not skip the finished fold:\n{r.stderr[-4000:]}")

    cache = ShardCache(test_man)
    n_batches = -(-len(cache) // B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    path = infer_main(cfg, device=dev)
    serve_wall = time.time() - t0
    served = launch_counts()
    want = {k: 0 if k.endswith("_bwd") or not (k in RMS_ENCODER or k.startswith("fm"))
            else n_batches * (1 if k.startswith("fm") else n_layers) for k in served}
    log(f"[fold] infer_main served the fold's checkpoint: {path} in {serve_wall:.2f} s; "
        f"launches {served}, expected {want}")
    if served != want:
        raise AssertionError(f"serving launches {served} != {want}")
    probs = check_submission(path, cache)
    log(f"[fold] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}")
    torch.cuda.empty_cache()
    return counts, served


def layernorm_config_dict():
    """The flagship config mapping with LayerNorm in the encoder and the
    QNN-alpha head (the reference's ``norm: layer`` option)."""
    from tossctr_tpu_torch.config.flagship import flagship_config_dict

    d = flagship_config_dict()
    d["sequence"]["tfm"]["norm"] = "layer"
    d["model"]["qnn_alpha"]["norm"] = "layer"
    return d


def layernorm_phase(tmp, test_man, train_cache, dev):
    """The LayerNorm flagship at full width: train steps (every dropout on)
    through the separate-kernel encoder, its fp32 512-row step against the
    CPU, its weights served from one fold checkpoint through
    ``infer_main`` and held against the CPU plain path, and the unfused
    encoder on the same weights.  -> (launches of the timed steps,
    launches of infer_main)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.eval.calibration import Calibrator, TemperatureScaler
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.models import build_model, init_params
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train.checkpoint import save_fold_checkpoint

    d = layernorm_config_dict()
    d["exp_name"] = "chip_layernorm"
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    d["data"]["manifest_test"] = test_man
    cfg = Config.from_dict(copy.deepcopy(d))
    B, n_layers = cfg.train.batch_size, cfg.sequence.tfm.n_layers
    t0 = time.time()
    model = init_params(build_model(cfg, train_cache.dims, dev), seed=2025)
    state, step = trainer_for(cfg, model)
    loader = BatchIterator(train_cache, batch_size=B, train=True, shuffle=True, seed=cfg.seed,
                           drop_last=cfg.train.drop_partial_batch)
    batches = [to_device(b, dev) for b in loader]
    torch.cuda.synchronize()
    log(f"[layernorm] sequence.tfm.norm layer, model.qnn_alpha.norm layer: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters, "
        f"{len(batches)} batches of {B}, set-up {time.time() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    state, first = first_step(cfg, model, state, step, batches[0], "layernorm")
    state, loss = step(state, batches[1 % len(batches)])  # warm
    float(loss)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(LAYERNORM_STEPS):
        state, loss = step(state, batches[(i + 2) % len(batches)])
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses = [float(x) for x in losses]
    expected = {k: n_layers * LAYERNORM_STEPS if k in LAYER_ENCODER else 0 for k in launches}
    log(f"[layernorm] {LAYERNORM_STEPS} steps: {1e3 * wall / LAYERNORM_STEPS:.2f} ms/step, "
        f"{LAYERNORM_STEPS * B / wall:.1f} examples/s (no claim), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses {[round(x, 6) for x in losses]}")
    log(f"[layernorm] launches during the {LAYERNORM_STEPS} steps: {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(first)):
        raise AssertionError(f"non-finite LayerNorm training loss: {losses}")
    if launches != expected:
        raise AssertionError(f"LayerNorm kernel launches {launches} != {expected}")
    profile_step(state, step, batches[0], "layernorm")
    del state, step, batches
    torch.cuda.empty_cache()

    train_reference_check(layernorm_config_dict(), train_cache, dev, "none", tag="layernorm",
                          held_only=True)

    # ---- the trained weights served from one fold checkpoint ----
    cal = Calibrator("temperature")
    cal.temp_scaler = TemperatureScaler(T=1.1)
    save_fold_checkpoint(cfg.exp_dir(), 0, state_dict=model.state_dict(), cfg_dict=cfg.to_dict(),
                         best_score=0.4, epoch=1, global_step=LAYERNORM_STEPS + 2,
                         calibrator=cal)
    cache = ShardCache(test_man)
    n_batches = -(-len(cache) // B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    path = infer_main(cfg, device=dev)
    serve_wall = time.time() - t0
    served = launch_counts()
    want = {k: n_layers * n_batches if k in LAYER_ENCODER and not k.endswith("_bwd") else 0
            for k in served}
    log(f"[layernorm] infer_main served the fold: {path} in {serve_wall:.2f} s, "
        f"{len(cache) / serve_wall:.1f} examples/s end to end; launches {served}, expected {want}")
    if served != want:
        raise AssertionError(f"LayerNorm serving launches {served} != {want}")
    probs = check_submission(path, cache)
    log(f"[layernorm] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}")
    reference_check(cfg, cache, dev, tag="layernorm")

    # ---- the unfused encoder on the same weights ----
    d["model"].update(use_pallas_attention=False, use_pallas_ffn=False)
    unfused = build_model(Config.from_dict(d), cache.dims, dev)
    unfused.load_state_dict(model.state_dict())
    batch = next(iter(BatchIterator(cache, batch_size=B)))
    tb = {k: torch.from_numpy(batch[k]).to(dev) for k in ("X_num", "X_mask", "X_cat", "seq")}
    with torch.inference_mode():
        zk, pk, _ = model(tb)
        reset_launch_counts()
        zu, pu, _ = unfused(tb)
        torch.cuda.synchronize()
        unfused_launches = launch_counts()
    dz = float((zu - zk).abs().max())
    dp = float((pu - pk).abs().max())
    log(f"[layernorm] unfused encoder (use_pallas_attention / use_pallas_ffn false) on the same "
        f"weights, one batch of {B}: launches {unfused_launches}; against the kernel path "
        f"max |dlogit| {dz:.5g}, max |dprob| {dp:.5g} (band {UNFUSED_BAND})")
    if any(unfused_launches.values()) or not (torch.isfinite(zu).all() and dp < UNFUSED_BAND):
        raise AssertionError("the unfused encoder launched a kernel or left the kernels' band")
    del model, unfused, cache
    torch.cuda.empty_cache()
    return launches, served


def trained_steps(cfg, model, batches, n_steps, tag, expected, require_change=True):
    """The first step checked (``first_step``), one warm step, then
    ``n_steps`` timed ones over the rotating batches with the launch
    counts read around them, held to ``expected`` ({kernel: launches}).
    -> (state, step, launches)."""
    import torch

    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts

    state, step = trainer_for(cfg, model)
    torch.cuda.reset_peak_memory_stats()
    state, first = first_step(cfg, model, state, step, batches[0], tag, require_change)
    state, loss = step(state, batches[1 % len(batches)])  # warm
    float(loss)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(n_steps):
        state, loss = step(state, batches[(i + 2) % len(batches)])
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses = [float(x) for x in losses]
    B = cfg.train.batch_size
    log(f"[{tag}] {n_steps} steps: {1e3 * wall / n_steps:.2f} ms/step, {n_steps * B / wall:.1f} "
        f"examples/s (B={B}, no claim), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
        f"{[round(x, 6) for x in losses]}")
    log(f"[{tag}] launches during the {n_steps} steps: {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and np.isfinite(first)):
        raise AssertionError(f"{tag}: non-finite training loss: {losses}")
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches} != {expected}")
    return state, step, launches


LARGE_K_STEPS = 3  # timed steps of the K = 120 and K = 148 phases, after 2 warm ones


def large_k_steps(d, tmp, dev, tag, seed):
    """A larger-K config's mapping ``d`` at full width (4 encoder layers,
    the 10M-row table, random seeded weights) over a synthetic train cache
    of 4 batches: LARGE_K_STEPS train steps through the RMS encoder
    kernels, timed after 2 warm ones, their launch counts held to 4 layers
    x steps of each.  -> (cfg, train cache, model, state, step, the
    batches, launches)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.models import build_model, init_params
    from tossctr_tpu_torch.ops import launch_counts

    cfg = Config.from_dict(copy.deepcopy(d))
    B, n_layers = cfg.train.batch_size, cfg.sequence.tfm.n_layers
    t0 = time.time()
    train_man = write_synth_cache_for(cfg, os.path.join(tmp, "cache", f"{tag}_train"), 4 * B,
                                      num_dim=N_NUM, seed=seed)
    cache = ShardCache(train_man)
    model = init_params(build_model(cfg, cache.dims, dev), seed=2026)
    loader = BatchIterator(cache, batch_size=B, train=True, shuffle=True, seed=cfg.seed,
                           drop_last=cfg.train.drop_partial_batch)
    batches = [to_device(b, dev) for b in loader]
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.exp_name}: K={cfg.sequence.top_k}, {n_layers} layers, query "
        f"{cfg.sequence.query_mode}, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        f"parameters, {len(batches)} batches of {B}, set-up {time.time() - t0:.1f} s")
    expected = {k: n_layers * LARGE_K_STEPS if k in RMS_ENCODER else 0 for k in launch_counts()}
    # the synthetic batches hold empty histories, whose gradients blow the
    # pre-clip norm up (ROADMAP queue 3): the clip can then scale every
    # gradient below what the parameters, the fp32 accumulator and the bf16
    # table resolve, so the first step need not change anything; it must
    # change no unselected row, and the step is held to the CPU after on
    # the rows with a history
    log(f"[{tag}] the first batch's global gradient norm before the clip (no dropout): "
        f"{grad_norm_on(cfg, model, batches[0]):.6g} (the clip is at {cfg.train.grad_clip_norm}; "
        f"{int((batches[0]['seq'] == cfg.sequence.pad_id).all(dim=1).sum())} rows have an "
        f"empty history)")
    state, step, launches = trained_steps(cfg, model, batches, LARGE_K_STEPS, tag, expected,
                                          require_change=False)
    return cfg, cache, model, state, step, batches, launches


def k120_phase(tmp, dev):
    """``cfgs/v3_k120_s1_tpu.yaml`` at full width (K = 120, 4 encoder
    layers, S1 query, B = 8192; ``large_k_steps``): train steps through
    the RMS encoder kernels at K = 120 (K padded to 128: the backwards'
    dbias in registers), the fp32 512-row step held against the CPU and
    against the plain versions on the card (``train_reference_check``),
    the weights served from one fold checkpoint through ``infer_main`` and
    held against the CPU plain path within 0.02.  -> (launches of the
    timed steps, launches of infer_main)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import v3_k120_config_dict
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.eval.calibration import Calibrator, TemperatureScaler
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train.checkpoint import save_fold_checkpoint

    d = v3_k120_config_dict()
    d["exp_name"] = "chip_k120"
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    cfg, cache, model, state, step, batches, launches = large_k_steps(d, tmp, dev, "k120", 13)
    del state, step, batches
    torch.cuda.empty_cache()
    train_reference_check(copy.deepcopy(d), cache, dev, "none", tag="k120", held_only=True)
    torch.cuda.empty_cache()

    B, n_layers = cfg.train.batch_size, cfg.sequence.tfm.n_layers
    d["data"]["manifest_test"] = write_synth_cache_for(
        cfg, os.path.join(tmp, "cache", "k120_test"), 2 * B, num_dim=N_NUM, seed=14)
    cfg = Config.from_dict(copy.deepcopy(d))
    cal = Calibrator("temperature")
    cal.temp_scaler = TemperatureScaler(T=1.1)
    save_fold_checkpoint(cfg.exp_dir(), 0, state_dict=model.state_dict(), cfg_dict=cfg.to_dict(),
                         best_score=0.4, epoch=1, global_step=LARGE_K_STEPS + 2, calibrator=cal)
    del model
    torch.cuda.empty_cache()
    test_cache = ShardCache(d["data"]["manifest_test"])
    n_batches = -(-len(test_cache) // B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    path = infer_main(cfg, device=dev)
    serve_wall = time.time() - t0
    served = launch_counts()
    want = {k: n_layers * n_batches if k in RMS_ENCODER and not k.endswith("_bwd") else 0
            for k in served}
    log(f"[k120] infer_main served the fold: {path} in {serve_wall:.2f} s; launches {served}, "
        f"expected {want}")
    if served != want:
        raise AssertionError(f"K = 120 serving launches {served} != {want}")
    probs = check_submission(path, test_cache)
    log(f"[k120] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}")
    reference_check(cfg, test_cache, dev, tag="k120")
    torch.cuda.empty_cache()
    return launches, served


def k148_phase(tmp, dev):
    """``cfgs/v3_k148_s1_tpu.yaml`` at full width (K = 148 padded to 152,
    4 encoder layers, S1 query, B = 4096; ``large_k_steps``): train steps
    through the RMS encoder kernels at K = 152 (the attention backward's
    tensor-core form at K padded to 160), one step under the profiler,
    then the bf16 512-row step held against the CPU and against the plain
    versions on the card with every ReLU pinned and the bands derived from
    the perturbation witness (``train_reference_check`` with K148_BANDS),
    which is what judges a tensor-core attention kernel inside the step,
    and the negative controls on those bands.  Not served:
    the K = 120 phase serves through the same forwards.  -> launches of
    the timed steps."""
    import torch

    from tossctr_tpu_torch.config.flagship import v3_k148_config_dict

    d = v3_k148_config_dict()
    d["exp_name"] = "chip_k148"
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    _, cache, model, state, step, batches, launches = large_k_steps(d, tmp, dev, "k148", 15)
    profile_step(state, step, batches[0], "k148")
    del model, state, step, batches
    torch.cuda.empty_cache()
    checked = train_reference_check(copy.deepcopy(d), cache, dev, "bf16", tag="k148",
                                    held_only=True, bands=K148_BANDS)
    negative_controls(*checked["pinned"], tag="k148 controls")
    torch.cuda.empty_cache()
    return launches


# the three streaming table-update modes the JAX sparse step dispatches
STREAM_MODES = {
    "scatter": dict(exact_dedup=False),
    "sweep": dict(exact_dedup=False, table_update="sweep"),
    "sparse_sgd": dict(exact_dedup=False, embedding_optimizer="sparse_sgd"),
}
STREAM_STEPS = 3  # timed steps a mode, after 2 warm ones


def stream_phase(train_cache, dev):
    """The flagship with each streaming table update at full width (B =
    8192, every dropout on): ``exact_dedup: false`` (the JAX default, a
    scatter-add), with ``table_update: sweep`` (the ``sweep_rows_add``
    kernel) and ``embedding_optimizer: sparse_sgd``.  Timed steps with
    launch counts (``sweep_rows_add`` once a step in the sweep mode, never
    otherwise), only selected rows changed and never the pad row, a
    profile of the sweep mode's step, and each mode's fp32 512-row step
    against the CPU and against the plain versions on the card.  -> the
    sweep mode's launches."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.ops import launch_counts
    from tossctr_tpu_torch.train.trainer import build_model

    sweep_launches = None
    for mode, over in STREAM_MODES.items():
        d = flagship_config_dict()
        d["train"].update(over)
        cfg = Config.from_dict(copy.deepcopy(d))
        t0 = time.time()
        model = init_params(build_model(cfg, train_cache.dims, dev), seed=2027)
        loader = BatchIterator(train_cache, batch_size=cfg.train.batch_size, train=True,
                               shuffle=True, seed=cfg.seed, drop_last=cfg.train.drop_partial_batch)
        batches = [to_device(b, dev) for b in loader][:4]
        log(f"[stream {mode}] train {over}: set-up {time.time() - t0:.1f} s")
        expected = {k: (3 * STREAM_STEPS if k in RMS_ENCODER else
                        STREAM_STEPS if k == "sweep_rows_add" and mode == "sweep" else 0)
                    for k in launch_counts()}
        state, step, launches = trained_steps(cfg, model, batches, STREAM_STEPS,
                                              f"stream {mode}", expected)
        if mode == "sweep":
            sweep_launches = launches
            profile_step(state, step, batches[0], "stream sweep")
        del state, step, batches, model
        torch.cuda.empty_cache()
        train_reference_check(d, train_cache, dev, "none", tag=f"stream {mode}", held_only=True)
        torch.cuda.empty_cache()
    return sweep_launches


SELECT_STEPS = 3  # timed steps of each selection mode, after the checked first and a warm one
SELECT_ROUNDS = 5  # then rounds of SELECT_STEPS steps a mode, the modes in turns
SELECT_MODES = {  # bench.py's default (the flagship TPU mode), then the streaming pass
    "dense": {},
    "proxy": dict(select_proxy=True, select_proxy_block=64, select_proxy_candidates=128),
    "stream": dict(select_chunk=128),  # 400 positions: 4 chunks, 112 phantom positions
}
SELECT_FOLD_ROWS = 5 * 8192  # the select fold's synthetic train rows: its fold trains on 4/5


def select_ids_check(cfg, model, batch, dev):
    """The three selection passes on the card on one full-width batch (B =
    8192, L = 400, the model's 10M-row bf16 table, a seeded bf16 query):
    the proxy at block 1 bit-equal to the dense ids, the streaming ids
    equal to the dense ids on at least CHECK_BANDS' ``select`` share of the
    rows (bf16 scores of a (B, 128, D) product may round otherwise than a
    (B, 400, D) one's), and the proxy's recall of the dense top-K at block
    64 (logged, not held).  -> {name: number}."""
    import torch

    from tossctr_tpu_torch.ops.topk_select import dare_select_ids

    D = cfg.model.emb_dim
    att = model.dare.emb_tables.detach()[:, :D]
    seq = batch["seq"]
    gen = torch.Generator(device=dev).manual_seed(5)
    query = torch.randn(seq.shape[0], D, generator=gen, device=dev).to(cfg.compute_dtype)
    kw = dict(top_k=cfg.sequence.top_k, tau=cfg.sequence.recency_tau, pad_id=cfg.sequence.pad_id)
    idx, ids, _ = dare_select_ids(att, seq, query, **kw)
    got = {}
    b1_idx, b1_ids, _ = dare_select_ids(att, seq, query, select_proxy={"block": 1,
                                                                          "candidates": 128}, **kw)
    got["proxy block 1 bit-equal rows"] = float(((b1_idx == idx) & (b1_ids == ids))
                                               .all(dim=1).double().mean())
    s_idx, s_ids, _ = dare_select_ids(att, seq, query, select_chunk=128, **kw)
    got["streaming rows equal"] = float(((s_idx == idx) & (s_ids == ids))
                                        .all(dim=1).double().mean())
    p = SELECT_MODES["proxy"]
    p_idx, p_ids, _ = dare_select_ids(att, seq, query, select_proxy={
        "block": p["select_proxy_block"], "candidates": p["select_proxy_candidates"]}, **kw)
    B, K = idx.shape
    base = torch.arange(B, device=dev)[:, None] * seq.shape[1]
    dense_set, proxy_set = (idx + base).reshape(-1), (p_idx + base).reshape(-1)
    real = (ids != kw["pad_id"]).reshape(-1)
    found = torch.isin(dense_set[real], proxy_set)
    got["proxy recall at block 64"] = float(found.double().mean())
    log(f"[select] the passes on one batch (B={B}, L={seq.shape[1]}, K={K}, the model's table, "
        f"a seeded bf16 query): " + ", ".join(f"{k} {v:.6f}" for k, v in got.items()))
    if got["proxy block 1 bit-equal rows"] != 1.0:
        raise AssertionError("the proxy at block 1 does not select the dense ids")
    if got["streaming rows equal"] < CHECK_BANDS["bf16"]["select"]:
        raise AssertionError(f"the streaming pass agrees with the dense one on "
                             f"{got['streaming rows equal']:.6f} of the rows (band "
                             f"{CHECK_BANDS['bf16']['select']})")
    return got


def block_cut_check(cache, dev, block):
    """The flagship one-step check's batch and parameters (as
    ``compact_check``) with the fused table cut by whole blocks of
    ``block`` rows: every block the batch's ids fall in is kept, in order
    (the pad id's block first, so the pad id stays 0), and an id becomes
    ``new_block * block + id % block``.  The proxy's block means are then
    the full table's, so the proxy selects what it selects on the full
    table, and the step is the same step.  -> (batch, state_dict on the
    CPU, rows kept)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train.trainer import build_model

    d = no_kernel_dropouts(flagship_config_dict())
    d["model"]["table_dtype"] = "float32"
    cfg = Config.from_dict(d)
    batch = next(iter(BatchIterator(cache, batch_size=CHECK_ROWS, train=True)))
    pad = cfg.sequence.pad_id
    blocks = np.union1d([pad // block], np.unique(batch["seq"] // block))
    if blocks[0] != pad // block or pad % block:
        raise AssertionError("the pad id must lead the first kept block")
    new_block = np.searchsorted(blocks, batch["seq"] // block)
    batch = dict(batch, seq=(new_block * block + batch["seq"] % block).astype(batch["seq"].dtype))
    full = init_params(build_model(cfg, cache.dims, dev), seed=77)
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    rows = (torch.from_numpy(blocks).to(dev)[:, None] * block
            + torch.arange(block, device=dev)).reshape(-1)
    sd["dare.emb_tables"] = sd["dare.emb_tables"][rows]
    sd = {k: v.cpu() for k, v in sd.items()}
    del full, rows
    torch.cuda.empty_cache()
    return batch, sd, len(blocks) * block


def select_profile(mode, state, step, batch):
    """One train step of a selection mode under torch.profiler: the device
    time of the selection's ranges (``select.dense``, ``select.streaming``,
    the proxy's ``select.proxy_build``, ``_stage1`` and ``_stage2``, named
    in ``ops/topk_select.py``; each forward of the step selects once) and
    of the whole step.  -> (state, selection ms, step's device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, loss = step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    parts = {}
    for e in events:
        if e.key.startswith("select."):
            # the range's device time, on its CPU-side or its GPU-side entry
            parts[e.key] = max(parts.get(e.key, 0.0), e.device_time_total / 1e3)
    total = sum(parts.values())
    log(f"[select] one {mode} step under the profiler: device busy {device_ms:.3f} ms; the "
        f"selection's device time {total:.3f} ms: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(parts.items()))
        + ("" if parts else " (no device time found under the ranges)"))
    return state, total, device_ms


def gather_times(cache, n, repeats=5):
    """Host ms of ``cache.gather`` of ``n`` random rows, the native threaded
    gather against NumPy's (``TOSSCTR_NATIVE_GATHER=0``), in turns; the
    median of ``repeats`` each; the two batches must be byte-equal.  Beside
    it the rows' copy alone (``gather_rows_multi`` against NumPy's fancy
    indexing of the five arrays, on one shard's sorted rows), the part the
    native gather replaces."""
    from tossctr_tpu_torch.native import gather_rows_multi

    idx = np.random.default_rng(3).choice(len(cache), size=min(n, len(cache)), replace=False)
    arrs = cache.shards[0].arrs
    keys = ("X_num", "X_mask", "X_cat", "seq", "y")
    rows = np.sort(idx[idx < cache.shards[0].rows])
    times = {"native": [], "numpy": [], "copy native": [], "copy numpy": []}
    saved = os.environ.get("TOSSCTR_NATIVE_GATHER")
    try:
        for _ in range(repeats):
            for kind in ("native", "numpy"):
                os.environ["TOSSCTR_NATIVE_GATHER"] = "1" if kind == "native" else "0"
                t0 = time.perf_counter()
                out = cache.gather(idx, train=True)
                times[kind].append(1e3 * (time.perf_counter() - t0))
                if kind == "native":
                    fast = out
                elif any(fast[k].tobytes() != out[k].tobytes() for k in out):
                    raise AssertionError("the native gather's batch is not NumPy's")
            t0 = time.perf_counter()
            gather_rows_multi([arrs[k] for k in keys], rows)
            times["copy native"].append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            [arrs[k][rows] for k in keys]
            times["copy numpy"].append(1e3 * (time.perf_counter() - t0))
    finally:
        if saved is None:
            os.environ.pop("TOSSCTR_NATIVE_GATHER", None)
        else:
            os.environ["TOSSCTR_NATIVE_GATHER"] = saved
    return {k: float(np.median(v)) for k, v in times.items()}


def select_phase(tmp, train_cache, test_man, dev):
    """Streaming and proxy selection at the flagship's full width (D = 64,
    L = 400, K = 60 padded to 64, 3 RMS layers, the 10M-row bf16 table,
    B = 8192, every dropout on):

    (a) SELECT_STEPS timed train steps each of the dense pass, the proxy
        (``select_proxy``, block 64, 128 candidates: bench.py's default)
        and the streaming pass (``select_chunk: 128``), after the checked
        first step and a warm one, the same seeded weights and batches;
        launch counts as the training phase's (3 layers a step); one step
        of each profiled, the selection's device time by part; then
        SELECT_ROUNDS rounds of SELECT_STEPS steps a mode, the modes in
        turns, their medians compared; the host cost of an empty
        ``record_function`` range (the selection enters its ranges on
        every forward);
    (b) the three passes' ids on one batch (``select_ids_check``);
    (c) the proxy's 512-row step, in fp32 and in bf16, and the streaming
        pass's in fp32, held against the CPU and the plain versions
        (CHECK_BANDS of the amp, unchanged; the bf16 proxy's share of ids
        selected on both sides reported, not held) on the flagship
        check's batch and parameters, the table cut by whole blocks
        (``block_cut_check``; the cut keeps the streaming pass's order
        too: the renumbering keeps the ids' order);
    (d) one fold of ``train_main`` with the proxy, ``eval.device_metrics:
        true``, ``temperature+isotonic`` and the native gather (one epoch
        over SELECT_FOLD_ROWS synthetic rows); the card's AP / WLL within
        1e-5 of the host's on the fold's replayed validation scores;
    (e) the OOF replay (``tools/run_calibration.py``, temperature+isotonic)
        and ``infer_main`` serving the fold with its calibrator.
    -> the proxy steps' launches."""
    import torch
    from torch.profiler import record_function

    from tossctr_tpu_torch import native
    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.eval.metrics import final_score, final_score_device
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.tools import run_calibration
    from tossctr_tpu_torch.train import trainer
    from tossctr_tpu_torch.train.trainer import build_model

    t_phase = time.time()
    B = flagship_config_dict()["train"]["batch_size"]
    loader = BatchIterator(train_cache, batch_size=B, train=True, shuffle=True, seed=7)
    batches = [to_device(b, dev) for b in loader][:4]
    runs, proxy_launches = {}, None
    for mode, over in SELECT_MODES.items():
        d = flagship_config_dict()
        d["sequence"].update(over)
        cfg = Config.from_dict(copy.deepcopy(d))
        model = init_params(build_model(cfg, train_cache.dims, dev), seed=2031)
        expected = {k: 3 * SELECT_STEPS if k in RMS_ENCODER else 0 for k in launch_counts()}
        state, step, launches = trained_steps(cfg, model, batches, SELECT_STEPS,
                                              f"select {mode}", expected)
        state, _, _ = select_profile(mode, state, step, batches[0])
        runs[mode] = [state, step]
        if mode == "proxy":
            proxy_launches = launches
        if mode == "dense":
            select_ids_check(cfg, model, batches[0], dev)
        del model
    # the three modes in turns, so a drift of the card or the host falls on
    # each alike: SELECT_ROUNDS rounds of SELECT_STEPS steps a mode
    per_round = {m: [] for m in runs}
    for r in range(SELECT_ROUNDS):
        for mode, (state, step) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(SELECT_STEPS):
                state, loss = step(state, batches[(r + i) % len(batches)])
            float(loss)
            torch.cuda.synchronize()
            per_round[mode].append(1e3 * (time.perf_counter() - t0) / SELECT_STEPS)
            runs[mode][0] = state
    med = {m: float(np.median(v)) for m, v in per_round.items()}
    log(f"[select] ms/step in {SELECT_ROUNDS} rounds of {SELECT_STEPS} steps a mode, in turns "
        f"(B={B}, the same seeded weights and batches): " + "; ".join(
            f"{m} median {v:.2f} ms = {1e3 * B / v:.1f} examples/s (rounds "
            f"{', '.join(f'{x:.2f}' for x in per_round[m])})" for m, v in med.items())
        + f"; the proxy saves {med['dense'] - med['proxy']:.2f} ms a step, the streaming pass "
        f"{med['dense'] - med['stream']:.2f} ms (negative: it costs)")
    del runs, batches
    torch.cuda.empty_cache()
    # the selection's profiler ranges are entered on every forward, with or
    # without a profiler: their host cost
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("select.cost"):
            pass
    range_us = 1e6 * (time.perf_counter() - t0) / n
    log(f"[select] one record_function range with no profiler on: {range_us:.3f} us of host "
        f"time ({n} in a row, the mean); a step's forward enters 1 (dense, streaming) or "
        f"3 (proxy): {3e-3 * range_us / med['proxy']:.5%} of the proxy's median step")

    # (c) the held steps on a table cut by whole blocks
    t0 = time.time()
    p = SELECT_MODES["proxy"]
    chk_batch, chk_init, n_rows = block_cut_check(train_cache, dev, p["select_proxy_block"])
    log(f"[select] the held check runs the flagship check's {CHECK_ROWS}-row batch and "
        f"parameters with the table cut to the {n_rows // p['select_proxy_block']} whole blocks "
        f"({n_rows} rows) it reads ({time.time() - t0:.1f} s)")
    for mode, amp in (("proxy", "none"), ("proxy", "bf16"), ("stream", "none")):
        t0 = time.time()
        dd = flagship_config_dict()
        dd["sequence"].update(SELECT_MODES[mode])
        dd["model"]["seq_vocab"] = n_rows
        # the bf16 proxy's ids shared with the CPU are reported, not held:
        # two cuts on bf16 scores (stage 1's of small block means among
        # them) part more ids than the dense pass's one, below the dense
        # band of 0.999 (ROADMAP queue 3); every other band is held as is
        bands = dict(CHECK_BANDS[amp], select=None) if (mode, amp) == ("proxy", "bf16") else None
        train_reference_check(dd, train_cache, dev, amp, tag=f"select {mode}", held_only=True,
                              bands=bands, init=chk_init, batch=chk_batch)
        log(f"[select {mode}] the held amp={amp} check took {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
    del chk_init
    torch.cuda.empty_cache()

    # (d) one fold of train_main: proxy, device metrics, isotonic, native gather
    t0 = time.time()
    d = flagship_config_dict()
    d["sequence"].update(p)
    d["exp_name"] = "chip_select"
    d["cv"]["n_splits"] = 1
    d["train"]["epochs"] = 1
    d["eval"]["device_metrics"] = True
    d["calibration"].update(enabled=True, method="temperature+isotonic")
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    d["data"]["manifest_train"] = write_synth_cache_for(
        Config.from_dict(copy.deepcopy(d)), os.path.join(tmp, "cache", "select_train"),
        SELECT_FOLD_ROWS, num_dim=N_NUM, seed=17)
    d["data"]["manifest_test"] = test_man
    cfg = Config.from_dict(copy.deepcopy(d))
    gather_ms = gather_times(ShardCache(cfg.data.manifest_train), B)
    log(f"[select] host ms to gather a batch of {B} random rows of the fold's cache (page cache "
        "warm: the cache was just written), median of 5: cache.gather " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in gather_ms.items()))
    native.reset_gather_counts()
    reset_launch_counts()
    t1 = time.time()
    exp = trainer.train_main(cfg, device=dev)
    fold_wall = time.time() - t1
    gathers = native.gather_counts()["gather_rows_multi"]
    log(f"[select] train_main (one fold, one epoch, {SELECT_FOLD_ROWS} rows; cache written in "
        f"{t1 - t0:.1f} s) in {fold_wall:.2f} s; the native gather (library "
        f"{native.library_path().name}) copied {gathers} batches' rows; launches "
        f"{launch_counts()}")
    if gathers == 0:
        raise AssertionError("the fold's batches did not go through the native gather")
    with open(os.path.join(exp, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        log(f"[select] train_log.csv: " + ", ".join(f"{k}={v}" for k, v in r.items()))
    val = next(r for r in rows if r["split"] == "val")

    # (e) the OOF replay, then the fold served with the OOF calibrator
    cfg_path = os.path.join(tmp, "chip_select.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    t0 = time.time()
    out = run_calibration.main(["--cfg", cfg_path, "--method", "temperature+isotonic",
                                "--device", dev.type])
    with open(os.path.join(out, "cal_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(out, "oof_metrics.json")) as f:
        oof = json.load(f)
    log(f"[select] run_calibration in {time.time() - t0:.1f} s: {oof['rows']} of "
        f"{oof['total']} rows; before {oof['before']}, after {oof['after']}; method "
        f"{meta['method']}, T {meta.get('T')}, {len(meta.get('iso_thresholds_x', []))} "
        "isotonic thresholds")
    if "iso_thresholds_x" not in meta:
        raise AssertionError("the OOF calibrator has no isotonic map")
    z, y, covered, total = run_calibration.compute_oof_from_ckpts(
        cfg, cfg.data.manifest_train, exp, dev)
    prob = 1.0 / (1.0 + np.exp(-z))
    on_card = final_score_device(y, prob, device=dev)
    on_host = final_score(y, prob)
    logged = (float(val["AP"]), float(val["WLL"]))
    log(f"[select] the fold's {covered} validation scores: AP / WLL / Score on the card "
        f"{on_card}, on the host {on_host}; the loop logged AP {logged[0]} WLL {logged[1]}")
    if (max(abs(a - b) for a, b in zip(on_card, on_host)) > 1e-5
            or max(abs(a - b) for a, b in zip(on_card[:2], logged)) > 1e-5):
        raise AssertionError("the card's AP / WLL are not the host's within 1e-5")
    os.replace(os.path.join(out, "calibrator.json"),
               os.path.join(exp, "ckpt_folds_0", "calibrator.json"))
    cache = ShardCache(test_man)
    reset_launch_counts()
    t0 = time.time()
    path = infer_main(cfg, device=dev)
    served = launch_counts()
    n_batches = -(-len(cache) // B)
    want = {k: n_batches * 3 if k in RMS_ENCODER and not k.endswith("_bwd") else 0
            for k in served}
    log(f"[select] infer_main served the fold with the OOF calibrator in {time.time() - t0:.2f} "
        f"s: {path}; launches {served}, expected {want}")
    if served != want:
        raise AssertionError(f"serving launches {served} != {want}")
    probs = check_submission(path, cache)
    log(f"[select] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}")
    log(f"[select] the phase took {time.time() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return proxy_launches


REF_STEPS = 3  # timed steps of the reference-tables phase's modes, after the checked first
SYNTH_ROWS = 20_000  # synth_small's synthetic train rows (its fold: 4/5 of them)
SYNTH_TEST_ROWS = 5_000
SYNTH_NUM = 8  # synth_small's synthetic numeric features (and as many isna masks)


def table_optimizers_check(dev, lr=1e-2, weight_decay=1e-4):
    """The dense-mode table optimizers on the card against the CPU, on the
    same fp32 parameters and gradients, two steps: torch's AdamW (as
    ``make_train_state`` builds it), ``train/adafactor.py``'s Adafactor and
    SGD, over a (V, 64) table (not factored), a (V, 128) one (factored), a
    (35, 16, 64) projection and a vector, some table rows without a
    gradient, at an lr at which each moves every tensor by far more than
    the band.  The held one-step checks hold what the step feeds the
    optimizer (the loss, the dense gradients, the rows' gradient), which
    is the same for the three; this holds what they do with it.  Within
    1e-6 of each tensor's largest magnitude (the same fp32 arithmetic,
    the means summed in another order).  -> {optimizer: largest error}."""
    import torch

    from tossctr_tpu_torch.train.adafactor import SGD, Adafactor

    rng = np.random.default_rng(3)
    shapes = {"emb_att": (100_000, 64), "emb_tables": (50_000, 128), "proj": (35, 16, 64),
              "vec": (64,)}
    init = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for _ in range(2):
        g = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        for k in ("emb_att", "emb_tables"):
            g[k][rng.random(shapes[k][0]) < 0.5] = 0.0  # rows the batch did not read
        grads.append(g)

    def run(name, device):
        ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(device)) for k, v in init.items()}
        opt = (torch.optim.AdamW(list(ps.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay) if name == "adamw" else
               Adafactor(ps) if name == "adafactor" else SGD(ps))
        for i, g in enumerate(grads):
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k]).to(device)
            step_lr = lr * (i + 1) / 2  # a warmup's two steps
            if name == "adamw":
                for group in opt.param_groups:
                    group["lr"] = step_lr
                opt.step()
            else:
                opt.step(step_lr)
        return {k: p.detach().cpu() for k, p in ps.items()}

    out = {}
    for name in ("adamw", "adafactor", "sgd"):
        card, cpu = run(name, dev), run(name, torch.device("cpu"))
        errs = {k: float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max()) for k in cpu}
        moved = {k: float((cpu[k] - torch.from_numpy(init[k])).abs().max()) for k in cpu}
        out[name] = max(errs.values())
        log(f"[reference tables] {name} on the card against the CPU, two fp32 steps: largest "
            f"error / largest magnitude {', '.join(f'{k} {e:.3g}' for k, e in errs.items())} "
            f"(band 1e-6; largest move {', '.join(f'{k} {m:.3g}' for k, m in moved.items())})")
        if not out[name] <= 1e-6 or not min(moved.values()) > 1e-3:
            raise AssertionError(f"{name} on the card departs from the CPU, or moved nothing")
    return out


def compact_check(cache, dev):
    """The flagship one-step check's batch and parameters for the split
    tables, with the tables cut to the rows the batch reads: the batch of
    ``train_reference_check`` (the cache's first CHECK_ROWS rows) with its
    sequence ids renumbered 0..U-1 in order (the pad id stays 0), and the
    state_dict of the flagship check's model (the seeded fused model, fp32
    tables) with the fused table's rows at those ids split into ``emb_att``
    and ``emb_rep``.  The split model on it computes what the flagship
    check's model computes on its batch (the same rows, positions and
    selection; a row the batch does not read gets no gradient and no
    sparse update), and a dense optimizer then sweeps U rows, not 10M.
    -> (batch, state_dict on the CPU, U)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train.trainer import build_model

    d = no_kernel_dropouts(flagship_config_dict())
    d["model"]["table_dtype"] = "float32"
    cfg = Config.from_dict(d)
    batch = next(iter(BatchIterator(cache, batch_size=CHECK_ROWS, train=True)))
    ids = np.unique(batch["seq"])
    pad, D = cfg.sequence.pad_id, cfg.model.emb_dim
    if ids[0] != pad:  # the pad id leads the renumbering
        ids = np.concatenate([[pad], ids])
    batch = dict(batch, seq=np.searchsorted(ids, batch["seq"]).astype(batch["seq"].dtype))
    full = init_params(build_model(cfg, cache.dims, dev), seed=77)
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    rows = sd.pop("dare.emb_tables")[torch.from_numpy(ids).to(dev)]
    sd["dare.emb_att"], sd["dare.emb_rep"] = rows[:, :D].contiguous(), rows[:, D:].contiguous()
    sd = {k: v.cpu() for k, v in sd.items()}
    del full, rows
    torch.cuda.empty_cache()
    return batch, sd, len(ids)


def reference_tables_phase(tmp, train_cache, dev):
    """The reference-shaped tables and the dense-table modes.  At the
    flagship's width (D = 64, B = 8192, every dropout on) with
    ``model.fused_seq_tables: false``, two (10M, 64) bf16 tables:

    (a) ``rowwise_adagrad`` + ``table_update: sweep``: REF_STEPS timed
        steps after the checked first (only selected rows of either table
        change, never the pad row), one ``sweep_rows_add`` launch a step
        for both tables, one step profiled; the table update's own time;
        the fp32 512-row step held against the CPU and the plain versions;
    (b) dense ``adamw`` (the tables trainable, one AdamW over every
        parameter, the EMA shadowing the tables): REF_STEPS timed steps
        after the checked first, one profiled;
    (c) ``adafactor`` and ``sgd``: one checked step each, and the three
        dense optimizers on the card against the CPU
        (``table_optimizers_check``);
    and (b)'s 512-row step held against the CPU and the plain versions in
    fp32 and bf16, (c)'s in bf16 (``train_reference_check``,
    its bands, the pinned bf16 witness and the negative controls; the
    dense modes' rows held by their gradient, ``_compare_steps``) on the
    flagship check's batch and parameters with the tables cut to the rows
    the batch reads (``compact_check``: a dense optimizer sweeps every
    row, and at 10M rows the CPU's steps would take minutes).
    (d) ``cfgs/synth_small.yaml``
    (``synth_small_config_dict``: fp32, D = 32, K = 12 padded to 16, the
    schema's default dense AdamW) through ``train_main`` for its one fold
    on a synthetic cache, then ``infer_main`` of its checkpoint: launch
    counts, the train log, the checkpoint and the submission.
    -> the kernels' launches, summed over the phase's counted runs (each
    held to its own expected counts)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict, synth_small_config_dict
    from tossctr_tpu_torch.data import BatchIterator, ShardCache
    from tossctr_tpu_torch.data.dataset import load_labels_groups_for_split
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.train import sparse_embed
    from tossctr_tpu_torch.train.cv_split import StratifiedGroupKFold
    from tossctr_tpu_torch.train.trainer import build_model, seq_tables, train_main

    t_phase = time.time()
    total = {k: 0 for k in launch_counts()}

    def counted(got):
        for k, v in got.items():
            total[k] += v

    def split_dict(**train):
        d = flagship_config_dict()
        d["model"]["fused_seq_tables"] = False
        d["train"].update(train)
        return d

    def full_width(d, tag):
        cfg = Config.from_dict(copy.deepcopy(d))
        t0 = time.time()
        model = init_params(build_model(cfg, train_cache.dims, dev), seed=2028)
        tables = seq_tables(model)
        shapes = {n: (tuple(t.shape), t.dtype, t.requires_grad) for n, t in tables.items()}
        dense = cfg.train.embedding_optimizer not in ("rowwise_adagrad", "sparse_sgd")
        want = {n: ((cfg.model.seq_vocab, cfg.model.emb_dim), torch.bfloat16, dense)
                for n in ("emb_att", "emb_rep")}
        if shapes != want:
            raise AssertionError(f"{tag}: the sequence tables {shapes} != {want}")
        loader = BatchIterator(train_cache, batch_size=cfg.train.batch_size, train=True,
                               shuffle=True, seed=cfg.seed, drop_last=cfg.train.drop_partial_batch)
        batches = [to_device(b, dev) for b in loader][:4]
        log(f"[{tag}] {cfg.train.embedding_optimizer}, split tables {shapes}: set-up "
            f"{time.time() - t0:.1f} s")
        return cfg, model, batches

    def per_step(sweep=0):
        return {k: (3 * REF_STEPS if k in RMS_ENCODER else sweep if k == "sweep_rows_add" else 0)
                for k in launch_counts()}

    # (a) the sparse AdaGrad step over the split pair through the sweep kernel
    d = split_dict(exact_dedup=False, table_update="sweep")
    cfg, model, batches = full_width(d, "reference tables sweep")
    state, step, got = trained_steps(cfg, model, batches, REF_STEPS, "reference tables sweep",
                                     per_step(sweep=REF_STEPS))
    counted(got)
    profile_step(state, step, batches[0], "reference tables sweep")
    tables = seq_tables(model)
    taps = {}
    with torch.no_grad():
        model(batches[0], taps=taps)
    ids = taps["sel_ids"]
    gen = torch.Generator(device=dev).manual_seed(12)
    grads = [torch.randn(taps[k].shape, generator=gen, device=dev) * 1e-3
             for k in ("att_rows", "rep_rows")]
    states = [state.table_opt[n] for n in tables]
    update_ms = cuda_time_ms(lambda: sparse_embed.rowwise_adagrad_sweep_update(
        list(tables.values()), states, ids, grads, lr=1e-4, pad_row=cfg.sequence.pad_id,
        weight_decay=float(cfg.train.weight_decay)), iters=5)
    log(f"[reference tables sweep] the table update alone (rowwise_adagrad_sweep_update: both "
        f"(V,) accumulators and one sweep_rows_add over both tables, {ids.numel()} ids): "
        f"{update_ms:.4f} ms")
    del state, step, model, batches, tables, taps, ids, grads, states
    torch.cuda.empty_cache()

    # the held checks: the flagship check's batch and model, tables cut to
    # the rows it reads
    t0 = time.time()
    chk_batch, chk_init, n_rows = compact_check(train_cache, dev)
    log(f"[reference tables] the held checks run the flagship check's {CHECK_ROWS}-row batch "
        f"and parameters with the split tables cut to the {n_rows} rows it reads "
        f"({time.time() - t0:.1f} s)")

    def held(train, amps):
        dd = split_dict(**train)
        dd["model"]["seq_vocab"] = n_rows
        tag = f"reference tables {train.get('embedding_optimizer', 'rowwise_adagrad')}"
        for amp in amps:
            checked = train_reference_check(copy.deepcopy(dd), train_cache, dev, amp, tag=tag,
                                            held_only=True, init=chk_init, batch=chk_batch)
            if "pinned" in checked:
                negative_controls(*checked["pinned"], tag=f"{tag} controls")
            torch.cuda.empty_cache()

    held(dict(exact_dedup=False, table_update="sweep"), ("none",))

    # (b) dense AdamW over every parameter, the tables included
    cfg, model, batches = full_width(split_dict(embedding_optimizer="adamw"),
                                     "reference tables adamw")
    state, step, got = trained_steps(cfg, model, batches, REF_STEPS, "reference tables adamw",
                                     per_step())
    counted(got)
    profile_step(state, step, batches[0], "reference tables adamw")
    del state, step, model, batches
    torch.cuda.empty_cache()
    held(dict(embedding_optimizer="adamw"), ("none", "bf16"))

    # (c) Adafactor and SGD on the tables, AdamW on the rest: one step each;
    # their held checks in bf16 (the fp32 ones hold the same records as
    # adamw's: the loss and gradients the step feeds the optimizer), and the
    # three optimizers themselves on the card against the CPU
    table_optimizers_check(dev, weight_decay=float(cfg.train.weight_decay))
    for opt in ("adafactor", "sgd"):
        tag = f"reference tables {opt}"
        cfg, model, batches = full_width(split_dict(embedding_optimizer=opt), tag)
        state, step = trainer_for(cfg, model)
        reset_launch_counts()
        torch.cuda.synchronize()
        # a first SGD step, lr x g, is far below half an ulp of a N(0, 1) bf16
        # table row: it need not change one (its fp32 check below holds it)
        state, first = first_step(cfg, model, state, step, batches[0], tag,
                                  require_change=opt != "sgd")
        got = launch_counts()
        # 3 layers: the forward that reads the selection, then the step's
        want = {k: (3 if k.endswith("_bwd") else 6) if k in RMS_ENCODER else 0 for k in got}
        log(f"[{tag}] launches of the checked step: {got}, expected {want}")
        if got != want or not np.isfinite(first):
            raise AssertionError(f"{tag}: launches {got} != {want}, or loss {first}")
        counted(got)
        del state, step, model, batches
        torch.cuda.empty_cache()
        held(dict(embedding_optimizer=opt), ("bf16",))
    log(f"[reference tables] the flagship-width modes and their checks: "
        f"{time.time() - t_phase:.1f} s")

    # (d) synth_small through the K-fold entry point and serving
    t0 = time.time()
    d = synth_small_config_dict()
    d["exp_name"] = "chip_synth_small"
    d["logging"]["log_dir"] = os.path.join(tmp, "runs")
    cfg0 = Config.from_dict(copy.deepcopy(d))
    d["data"]["manifest_train"] = write_synth_cache_for(
        cfg0, os.path.join(tmp, "cache", "synth_train"), SYNTH_ROWS, num_dim=SYNTH_NUM, seed=31)
    d["data"]["manifest_test"] = write_synth_cache_for(
        cfg0, os.path.join(tmp, "cache", "synth_test"), SYNTH_TEST_ROWS, num_dim=SYNTH_NUM,
        seed=32)
    cfg = Config.from_dict(d)
    B, E, n_layers = cfg.train.batch_size, cfg.train.epochs, cfg.sequence.tfm.n_layers
    y, groups = load_labels_groups_for_split(cfg.data.manifest_train)
    tr, va = next(StratifiedGroupKFold(5, shuffle=True, random_state=cfg.seed)
                  .split(np.zeros_like(y), y, groups))
    steps, val_batches = E * -(-len(tr) // B), E * -(-len(va) // B)
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    exp = train_main(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t1
    got = launch_counts()
    want = {k: (n_layers * (steps if k.endswith("_bwd") else steps + val_batches)
                if k in RMS_ENCODER else 0) for k in got}
    log(f"[synth_small] train_main ({cfg.train.embedding_optimizer} tables, amp "
        f"{cfg.amp}, D={cfg.model.emb_dim}, K={cfg.sequence.top_k} padded to 16, "
        f"{n_layers} layers, B={B}, {E} epochs; {SYNTH_ROWS} synthetic rows, the first of 5 "
        f"folds): {len(tr)} train rows, {len(va)} validation rows, {steps} steps and "
        f"{val_batches} validation batches in {wall:.2f} s; launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"synth_small launches {got} != {want}")
    counted(got)
    with open(os.path.join(exp, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        log("[synth_small] train_log.csv: " + ", ".join(f"{k}={v}" for k, v in r.items()))
    if [(r["epoch"], r["split"]) for r in rows] != [
            (str(e), s) for e in range(1, E + 1) for s in ("val", "val_cal")]:
        raise AssertionError(f"synth_small train_log.csv rows {rows}")
    if not all(np.isfinite(float(r[k])) for r in rows for k in ("AP", "WLL", "Score")):
        raise AssertionError("synth_small: non-finite validation metrics")
    ck = os.path.join(exp, "ckpt_folds_0")
    files = sorted(os.listdir(ck))
    ema = torch.load(os.path.join(ck, "ema.pt"), map_location="cpu", weights_only=True)
    log(f"[synth_small] checkpoint {ck}: {files}; the EMA weights shadow the table too: "
        f"{'dare.emb_tables' in ema}")
    if files != ["calibrator.json", "ema.pt", "meta.json", "params.pt"] or (
            "dare.emb_tables" not in ema):
        raise AssertionError("the synth_small checkpoint is not complete")
    test_cache = ShardCache(cfg.data.manifest_test)
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    path = infer_main(cfg, device=dev)
    served = launch_counts()
    n_batches = -(-len(test_cache) // B)
    want = {k: n_layers * n_batches if k in RMS_ENCODER and not k.endswith("_bwd") else 0
            for k in served}
    log(f"[synth_small] infer_main served the fold: {path} in {time.time() - t1:.2f} s; "
        f"launches {served}, expected {want}")
    if served != want:
        raise AssertionError(f"synth_small serving launches {served} != {want}")
    probs = check_submission(path, test_cache)
    log(f"[synth_small] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}; the part took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    log(f"[reference tables] phase wall time {time.time() - t_phase:.1f} s")
    return total


def mha_module_check(cfg, dev):
    """``MultiHeadSelfAttention`` with ``fuse_qkv`` off (the qkv Dense, a
    split, ``fused_mha``) against ``fuse_qkv`` on (``fused_mha_qkv``) on the
    same parameters at the flagship's attention shapes, dropout off: the
    output and the gradients of x, the bias and every parameter.  fp32 is
    held to 1e-4 of each one's largest magnitude (the same arithmetic in
    another order); bf16 to a norm-relative 5e-2, since the Dense rounds
    the product and adds its bias in bf16 where the fused kernel adds it
    in fp32 before one rounding.  -> the launches of the bf16 pass."""
    import torch

    from tossctr_tpu_torch.models.layers import MultiHeadSelfAttention
    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts

    B, K, D = cfg.train.batch_size, -(-cfg.sequence.top_k // 8) * 8, cfg.model.emb_dim
    H = cfg.sequence.tfm.n_heads
    g = torch.Generator(device=dev).manual_seed(5)
    counts = None
    for dtype in (torch.bfloat16, torch.float32):
        fused = MultiHeadSelfAttention(D, H, use_pallas=True, fuse_qkv=True).to(dev)
        with torch.no_grad():
            for name, p in fused.named_parameters():
                std = D ** -0.5 if name.endswith("kernel") else 0.1
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * std)
        split = MultiHeadSelfAttention(D, H, use_pallas=True, fuse_qkv=False).to(dev)
        split.load_state_dict(fused.state_dict())
        x = torch.randn(B, K, D, generator=g, device=dev).to(dtype)
        bias = torch.randn(K, K, generator=g, device=dev) * 0.5
        bias[:, cfg.sequence.top_k:] = -1e9
        bias = bias.to(dtype)
        go = torch.randn(B, K, D, generator=g, device=dev).to(dtype)
        grads = []
        for m in (fused, split):
            xl, bl = x.clone().requires_grad_(), bias.clone().requires_grad_()
            if m is split and dtype == torch.bfloat16:
                reset_launch_counts()
            out = m(xl, bl)
            out.backward(go)
            torch.cuda.synchronize()
            if m is split and dtype == torch.bfloat16:
                counts = launch_counts()
            grads.append({"out": out.detach(), "dx": xl.grad, "dbias": bl.grad,
                          **{f"d{n}": p.grad for n, p in m.named_parameters()}})
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        worst = {}
        for name, want in grads[0].items():
            got = grads[1][name].float()
            want = want.float()
            if dtype == torch.float32:
                err, band = float((got - want).abs().max()), 1e-4 * float(want.abs().max())
            else:
                err, band = float((got - want).norm() / want.norm()), 5e-2
            worst[name] = err
            if not err <= band:
                raise AssertionError(f"fused_mha module {tag} {name}: {err} > {band}")
        log(f"[module] MultiHeadSelfAttention fuse_qkv off vs on, B={B} K={K} D={D} H={H} {tag}: "
            + ", ".join(f"{n} {e:.3g}" for n, e in worst.items())
            + (" (max abs err; band 1e-4 of each one's largest)" if dtype == torch.float32
               else " (norm-relative; band 5e-2)"))
        del fused, split, x, bias, go, grads
    want = {k: 1 if k in ("fused_mha", "fused_mha_bwd") else 0 for k in counts}
    log(f"[module] launches of the bf16 fuse_qkv-off pass: {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"module launches {counts} != {want}")
    torch.cuda.empty_cache()
    return counts


HASH_OPS = 17  # integer operations a mask element: four products and adds, fmix32, compare
# the mask dumps' odd shapes, (B, K, H) of the attention mask and (N, F) of the
# FFN's: K % 4 != 0 with one and three heads, a single row, element counts
# that are not multiples of 4
DUMP_ODD_SHAPES = ((3, 13, 1, 1, 7), (1, 7, 3, 5, 3), (1, 61, 8, 37, 385), (2, 64, 3, 1, 4099))


def scatter_probe_phase(dev):
    """The scatter probe (``tossctr_tpu_torch.exp.scatter_probe``) on its
    three tables, timed with the launch counts read around it, then each of
    its kernels against its plain version on each table, outside the
    counted run.  -> the ``kernels`` rows of the two sweeps."""
    import torch

    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts

    sp = importlib.import_module("tossctr_tpu_torch.exp.scatter_probe")
    reset_launch_counts()
    torch.cuda.synchronize()
    recs = [r for tag in sp.TABLES for r in sp.run_table(tag, dev, check=False)]
    launches = launch_counts()
    chain = sp.ITERS + sp.WARMUP  # launches of one timed chain
    per = len(sp.TABLES) * len(sp.WIDTHS) * chain
    expected = {k: per if k in ("dense_sweep", "sparse_sweep") else
                len(sp.TABLES) * chain if k == "sweep_rows_add" else 0 for k in launches}
    log(f"[scatter probe] launches during the probe: {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"scatter probe launches {launches} != {expected}")
    for tag, spec in sp.TABLES.items():
        table, ids, delta = sp.make_inputs(*spec, dev)
        sp.check_table(table, ids, delta)
        log(f"[scatter probe] {tag}: dense_sweep and sparse_sweep bit-equal to their plain "
            f"versions at W = {sp.WIDTHS} (sparse: untouched blocks unchanged, padding repeats "
            f"add nothing); sweep_rows_add within one bf16 ulp")
        del table, ids, delta
        torch.cuda.empty_cache()
    rows = {}
    for name, probe, replaces in (("dense_sweep", "B", 62), ("sparse_sweep", "C", 107)):
        cases = [r for r in recs if r["probe"] == probe]
        head = next(r for r in cases if r["table"] == "flagship" and r["W"] == 1024)
        rows[name] = dict(
            name=name, route="cuda", source="tossctr_tpu_torch/csrc/table_sweep.cu",
            replaces=f"exp/scatter_probe.py:{replaces}", max_abs_err=0.0, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by="bytes",
            library_ms=head["library_ms"], library_call=head["library_call"],
            headline="flagship table (10M, 128) bf16, W = 1024", cases=cases,
            scatter_baseline=[r for r in recs if r["probe"] in "AD"])
    return rows, launches


def dropout_check_phase(dev):
    """The dropout-mask device check (``tossctr_tpu_torch.exp.
    hw_dropout_device_check``) at the flagship geometry, with the launch
    counts read around it; then the two dump kernels bit-equal to their
    plain masks at the odd shapes of DUMP_ODD_SHAPES and at the flagship
    geometry, and timed there, outside the counted run.  -> the ``kernels`` rows of
    the two dumps."""
    import torch

    from tossctr_tpu_torch.ops import launch_counts, reset_launch_counts
    from tossctr_tpu_torch.ops.dropout import (
        attention_keep,
        dump_attention_keep,
        dump_ffn_keep,
        ffn_keep,
    )

    chk = importlib.import_module("tossctr_tpu_torch.exp.hw_dropout_device_check")
    reset_launch_counts()
    torch.cuda.synchronize()
    report = chk.run_geometry("flagship", dev)
    launches = launch_counts()
    # two seeds of each mask; each kernel once against the oracle, and the
    # persistent ones twice more (two grids)
    persistent = ("fused_mha_qkv", "fused_mha", "fused_mha_qkv_bwd", "fused_mha_bwd",
                  "fused_block_tail_bwd", "fused_ffn_bwd")
    expected = {k: 2 if k.startswith("dump_") else 3 if k in persistent else
                1 if k in ("fused_block_tail", "fused_ffn") else 0 for k in launches}
    log(f"[dropout check] launches during the check: {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"dropout check launches {launches} != {expected}")
    geo = report["geometry"]
    B, K, H, N, F = geo["B"], geo["K"], geo["H"], geo["N"], geo["F"]
    for b, k, h, n, f in DUMP_ODD_SHAPES:
        for kind, got, want in (
                ("attention", dump_attention_keep(b, k, h, 0.1, DROP_SEED, dev),
                 attention_keep(b, k, h, 0.1, DROP_SEED, device=dev)),
                ("ffn", dump_ffn_keep(n, f, 0.1, DROP_SEED, dev),
                 ffn_keep(n, f, 0.1, DROP_SEED, device=dev))):
            if not torch.equal(got, want):
                raise AssertionError(f"{kind} mask dump at {tuple(got.shape)} differs from its "
                                     "plain version")
    log(f"[dropout check] both dumps bit-equal to their plain versions at the odd shapes "
        f"(B, K, H / N, F) {DUMP_ODD_SHAPES}")
    rows = {}
    for name, dump, plain, args, replaces in (
            ("dump_attention_keep", dump_attention_keep, attention_keep,
             (B, K, H, geo["p_attn"], DROP_SEED), 61),
            ("dump_ffn_keep", dump_ffn_keep, ffn_keep, (N, F, geo["p_ffn"], DROP_SEED), 133)):
        got = dump(*args, dev)
        want = plain(*args, device=dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        b_ms, b_by = bound_ms(got.numel() * 4, got.numel() * HASH_OPS, PEAK_FP32_FLOPS)
        rows[name] = dict(
            name=name, route="cuda", source="tossctr_tpu_torch/csrc/dropout_dump.cu",
            replaces=f"exp/hw_dropout_device_check.py:{replaces}", max_abs_err=0.0,
            shape=list(got.shape), ms=cuda_time_ms(lambda: dump(*args, dev), iters=10),
            plain_ms=cuda_time_ms(lambda: plain(*args, device=dev), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            check=report if name == "dump_attention_keep" else None)
        log(f"[dropout check] {name} {tuple(got.shape)}: bit-equal to its plain version; "
            f"{rows[name]['ms']:.4f} ms, plain {rows[name]['plain_ms']:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})")
        del got, want
        torch.cuda.empty_cache()
    return rows, launches


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` replaced by ``fn`` inside."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


# each RMS encoder kernel's wrapper: (module, name), the functions the
# autograd Functions call
ENCODER_WRAPPERS = {
    "fused_mha_qkv": ("tossctr_tpu_torch.ops.fused_attention", "fused_mha_qkv_fwd"),
    "fused_mha_qkv_bwd": ("tossctr_tpu_torch.ops.fused_attention", "fused_mha_qkv_bwd"),
    "fused_block_tail": ("tossctr_tpu_torch.ops.fused_ffn", "fused_block_tail_fwd"),
    "fused_block_tail_bwd": ("tossctr_tpu_torch.ops.fused_ffn", "fused_block_tail_bwd"),
}


@contextlib.contextmanager
def plain_versions_on_card(*over):
    """The encoder kernels' and the table update's wrappers swapped for
    their plain PyTorch versions, which then run on the card: a witness
    that splits the card's rounding between the kernels and the rest of
    the step.  ``over``: context managers entered after the swap (a
    perturbed or a wrong plain version)."""
    # the modules, not the package's functions of the same name
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    ff = importlib.import_module("tossctr_tpu_torch.ops.fused_ffn")
    sw = importlib.import_module("tossctr_tpu_torch.ops.sweep_scatter")

    swaps = [(fa, "fused_mha_qkv_fwd", fa.fused_mha_qkv_reference),
             (fa, "fused_mha_qkv_bwd", fa.fused_mha_qkv_bwd_reference),
             (fa, "fused_mha_fwd", fa.fused_mha_reference),
             (fa, "fused_mha_bwd", fa.fused_mha_bwd_reference),
             (ff, "fused_block_tail_fwd", ff.fused_block_tail_reference),
             (ff, "fused_block_tail_bwd", ff.fused_block_tail_bwd_reference),
             (ff, "fused_ffn_fwd", ff.fused_ffn_reference),
             (ff, "fused_ffn_bwd", ff.fused_ffn_bwd_reference),
             (sw, "sweep_rows_add", sw.sweep_rows_add_reference)]
    with contextlib.ExitStack() as stack:
        for m, n, plain in swaps:
            stack.enter_context(swapped(m, n, plain))
        for c in over:
            stack.enter_context(c)
        yield


@contextlib.contextmanager
def ulp_nudged(kernel, share=WITNESS_SHARE, seed=WITNESS_SEED):
    """The RMS encoder kernel ``kernel``'s wrapper, as installed, returning
    its bf16 outputs with a seeded ``share`` of their elements moved by
    one bf16 ulp, up or down at random (a zero moves up); its fp32 outputs
    as they are."""
    import torch

    mod_name, attr = ENCODER_WRAPPERS[kernel]
    mod = importlib.import_module(mod_name)
    fn, gens = getattr(mod, attr), {}

    def nudge(t):
        if not (torch.is_tensor(t) and t.dtype == torch.bfloat16):
            return t
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(seed)
        pick = torch.rand(t.shape, generator=gens[t.device], device=t.device) < share
        up = torch.rand(t.shape, generator=gens[t.device], device=t.device) < 0.5
        bits = t.contiguous().view(torch.int16)
        mag = bits & 0x7FFF  # the magnitude's bits: +1 moves away from 0, -1 toward it
        step = torch.where((up & (mag < 0x7F7F)) | (mag == 0), 1, -1).to(torch.int16)
        return torch.where(pick, bits + step, bits).view(torch.bfloat16)

    def nudged(*args, **kwargs):
        out = fn(*args, **kwargs)
        return tuple(nudge(t) for t in out) if isinstance(out, tuple) else nudge(out)

    with swapped(mod, attr, nudged):
        yield


def wrong_plain_versions():
    """The negative controls' wrong forwards, each (label, module, wrapper
    name, function) to swap in over the plain versions: the tail forward
    with the dropout mask of the next seed, the tail forward with its kept
    hidden units not scaled by 1/(1-p), and the qkv forward without the
    positional bias (the pad columns' -1e9 kept)."""
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    ff = importlib.import_module("tossctr_tpu_torch.ops.fused_ffn")
    keep = ff.ffn_keep

    def next_seed(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p=0.0, seed=0):
        return ff.fused_block_tail_reference(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                                             dropout_p, seed + 1)

    def unscaled(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2, dropout_p=0.0, seed=0):
        with swapped(ff, "ffn_keep", lambda *a, **k: (keep(*a, **k) > 0).float()):
            return ff.fused_block_tail_reference(x, o, wout, bout, wn1, w1, b1, w2, b2, wn2,
                                                 dropout_p, seed)

    def no_positional_bias(x, wqkv, bqkv, bias, n_heads, dropout_p=0.0, seed=0, **_):
        return fa.fused_mha_qkv_reference(x, wqkv, bqkv, bias.masked_fill(bias > -1e8, 0),
                                          n_heads, dropout_p, seed)

    return (("tail forward with the mask of seed + 1", ff, "fused_block_tail_fwd", next_seed),
            ("tail forward with keep not scaled by 1/(1-p)", ff, "fused_block_tail_fwd",
             unscaled),
            ("qkv forward without the positional bias", fa, "fused_mha_qkv_fwd",
             no_positional_bias))


def relu_signs(model, batch, device):
    """The sign of every ReLU input in ``model``'s forward on ``batch`` (a
    dict of numpy arrays) as the first train step runs it (its dropout
    generator), in call order."""
    import torch

    from tossctr_tpu_torch.models.layers import DropoutRNG
    from tossctr_tpu_torch.train.trainer import step_seed

    signs, relu = [], torch.relu

    def spy(x):
        signs.append((x > 0).cpu())
        return relu(x)

    torch.relu = spy
    try:
        with torch.no_grad():
            model(to_device(batch, device), rng=DropoutRNG(step_seed(1, 0), device))
    finally:
        torch.relu = relu
    return signs


@contextlib.contextmanager
def pinned_relus(signs):
    """``torch.relu`` replaced by ``torch.where(mask, x, 0)`` on the masks
    ``signs`` (one a call, in call order, from ``relu_signs``): every ReLU
    keeps the inputs another forward kept, whatever their sign here.
    Where the signs agree it is ReLU, forward and gradient."""
    import torch

    relu, calls = torch.relu, iter(signs)

    def pinned(x):
        m = next(calls, None)
        if m is None or tuple(m.shape) != tuple(x.shape):
            raise AssertionError(f"ReLU call of {tuple(x.shape)} against a mask "
                                 f"{None if m is None else tuple(m.shape)}")
        return torch.where(m.to(x.device), x, 0.0)

    torch.relu = pinned
    try:
        yield
    finally:
        torch.relu = relu


class PinnedPlain:
    """The bf16 ``vs_plain`` comparison with every ReLU pinned, on one model,
    batch (a dict of numpy arrays) and id set.  It records the ReLU signs
    of the step's forward with the kernels' plain versions, then that
    step with those signs pinned on both sides (``pinned_relus``): every
    step here is held against that one.  A ReLU input within rounding of 0
    sends a row's gradient down another path wholesale, so unpinned the
    comparison would count the sign flips that any correct kernel summing
    in another order sets off; pinned, it gives the ReLU's gradient
    wherever the signs agree and holds the rest of the step as it is.
    ``ctx`` below: a callable that returns a context manager (the step's
    kernels: ``contextlib.nullcontext`` for the kernels as built,
    ``plain_versions_on_card`` with perturbed or wrong versions over it)."""

    def __init__(self, cfg, model, init, batch, device, ids):
        self.args = (cfg, model, init, batch, device, ids)
        self.signs = self.signs_under(plain_versions_on_card)
        self.plain = self.record(plain_versions_on_card)

    def signs_under(self, ctx):
        """``relu_signs`` of the forward under ``ctx``."""
        _, model, init, batch, device, _ = self.args
        model.load_state_dict(init)
        with ctx():
            return relu_signs(model, batch, device)

    def record(self, ctx):
        """The step under ``ctx`` with the ReLUs pinned (``_step_record``)."""

        @contextlib.contextmanager
        def pinned():
            with ctx(), pinned_relus(self.signs):
                yield

        return _step_record(*self.args, variant=pinned)

    def compare(self, ctx):
        """The step under ``ctx`` against the plain one, both pinned."""
        return _compare_steps(self.record(ctx), self.plain)

    def flips(self, ctx):
        """The ReLU inputs whose sign in the unpinned forward under ``ctx``
        is not the plain forward's."""
        return sum(int((a != b).sum()) for a, b in zip(self.signs_under(ctx), self.signs))

    def witness(self, bands, share=WITNESS_SHARE, together=False):
        """-> (``bands`` with each None derived, at most WITNESS_CAP: the
        largest distance from the plain step of the plain step with one RMS
        encoder kernel's bf16 outputs nudged by an ulp on ``share`` of them
        (``ulp_nudged``), with ``together`` also of the plain step with all
        four nudged at once; {kernel, or "all four": its distances})."""
        found = {k: self.compare(lambda k=k: plain_versions_on_card(ulp_nudged(k, share)))
                 for k in RMS_ENCODER}
        if together:
            found["all four"] = self.compare(lambda: plain_versions_on_card(
                *(ulp_nudged(k, share) for k in RMS_ENCODER)))
        out = {m: min(WITNESS_CAP, max(g[m] for g in found.values())) if b is None else b
               for m, b in bands.items()}
        return out, found

    def negative_controls(self, bands):
        """Each wrong plain version (``wrong_plain_versions``) in place of its
        plain version, against the plain step: -> [(label, distances, the
        held metrics out of ``bands``)]."""
        out = []
        for label, mod, attr, wrong in wrong_plain_versions():
            g = self.compare(lambda m=mod, a=attr, w=wrong: plain_versions_on_card(
                swapped(m, a, w)))
            out.append((label, g, [m for m, b in bands.items() if not g[m] <= b]))
        return out


def same_relu_rows(sides, batch, rows):
    """``rows`` less the rows whose ReLU inputs take another sign on the
    card than on the CPU in the first step's forward on just those rows:
    one input within rounding of 0 sends a row's gradient down another
    path wholesale.  The SE gates read the batch's mean, so dropping a row
    can move another's signs: repeat until none differs.  sides: ((model,
    device), (model, device)).  -> (rows kept, rows dropped)."""
    import torch

    keep = rows.clone()
    for _ in range(4):
        sub = {k: v[keep.numpy()] for k, v in batch.items()}
        n = int(keep.sum())
        flip = torch.zeros(n, dtype=torch.bool)
        for a, b in zip(*(relu_signs(m, sub, x) for m, x in sides)):
            if a.shape[0] == n:
                flip |= (a != b).reshape(n, -1).any(dim=1)
            elif bool((a != b).any()):  # a batch-level input: every row
                flip[:] = True
        if not flip.any():
            return keep, int(rows.sum()) - n
        keep[keep.nonzero()[:, 0][flip]] = False
    raise AssertionError("the ReLU signs of the card and the CPU do not settle")


def _step_record(cfg, model, init, batch, device, ids, variant=None):
    """One train step of ``model`` from the parameters ``init`` on
    ``batch``: the loss, each dense gradient, and the table rows and
    AdaGrad accumulator at ``ids`` before and after (every sequence table's
    rows side by side; in the dense-table modes also the rows' gradient,
    ``row_grads``).  ``variant``:
    "oneDNN off" runs the CPU's matrix products through PyTorch's own
    kernels instead of oneDNN's; "plain versions" runs the card's step
    with the plain versions of the kernels; a callable returns the
    context manager the step runs in."""
    import torch

    from tossctr_tpu_torch.train.trainer import dense_params, seq_tables

    model.load_state_dict(init)
    state, step = trainer_for(cfg, model)
    tables = seq_tables(model)
    on = ids.to(device)

    def rows():  # every sequence table's rows at the ids, side by side
        return torch.cat([t.detach()[on].double().cpu() for t in tables.values()], dim=1)

    before = rows()
    ctx = variant if callable(variant) else {
        None: contextlib.nullcontext, "plain versions": plain_versions_on_card,
        "oneDNN off": lambda: torch.backends.mkldnn.flags(enabled=False)}[variant]
    with ctx():
        state, loss = step(state, to_device(batch, device))
    accs = [accum_rows(state, n, t)[on].double().cpu() for n, t in tables.items()
            if n in state.table_opt]
    dense_tables = all(t.grad is not None for t in tables.values())
    rec = dict(loss=float(loss), before=before, rows=rows(),
               accum=torch.cat(accs, dim=1) if accs else None,
               row_grads=torch.cat([t.grad[on].double().cpu() for t in tables.values()], dim=1)
               if dense_tables else None,
               grads={n: p.grad.double().cpu() for n, p in dense_params(model).items()})
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _grad_norm(cfg, model, init, batch, device):
    """The global norm of the dense and table-row gradients of the loss
    (deterministic forward) from the parameters ``init``: what the step
    clips to ``train.grad_clip_norm``."""
    model.load_state_dict(init)
    return grad_norm_on(cfg, model, to_device(batch, device))


def grad_norm_on(cfg, model, b):
    """``_grad_norm`` of ``model`` as it stands on the batch ``b`` of
    tensors on its device."""
    from tossctr_tpu_torch.train.loss import bce_wll_style
    from tossctr_tpu_torch.train.trainer import ROW_TAPS, dense_params

    taps = {}
    z, _, aux = model(b, taps=taps)
    w = float(cfg.model.qnn_alpha.aux_head_weight)
    valid = b.get("valid")
    (bce_wll_style(z, b["y"], valid) + w * bce_wll_style(aux, b["y"], valid)).backward()
    grads = [p.grad for p in dense_params(model).values() if p.grad is not None]
    grads += [taps[k].grad for k in ROW_TAPS.values() if k in taps]
    total = sum(float(g.double().square().sum()) for g in grads)
    for p in model.parameters():
        p.grad = None
    return total ** 0.5


def log_grad_norms(cfg, card_model, init, batch, dev, nonempty, rows_of, tag, amp):
    """The pre-clip global gradient norm of the whole batch and of its rows
    with a history (the empty-history blow-up, ROADMAP queue 3)."""
    log(f"[{tag}] amp={amp} global gradient norm before the clip (card, no dropout): whole "
        f"batch {_grad_norm(cfg, card_model, init, batch, dev):.6g}; its "
        f"{int(nonempty.sum())} rows with a non-empty history "
        f"{_grad_norm(cfg, card_model, init, rows_of(nonempty), dev):.6g} (the clip is at "
        f"{cfg.train.grad_clip_norm}; {int((~nonempty).sum())} rows have an empty history)")


def _compare_steps(c, r):
    """Step record ``c`` against the reference record ``r``: loss, every
    dense gradient, and over the ids whose accumulator is at least
    ACCUM_FLOOR of the largest the accumulator and the rows' update (sparse
    SGD: the ids whose update is; the dense-table modes: the rows' gradient
    over the ids whose gradient is, as "delta")."""

    def rel(a, b):
        return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else float((a - b).norm())

    got = dict(loss=abs(c["loss"] - r["loss"]) / abs(r["loss"]))
    num = sum(float((c["grads"][n] - g).square().sum()) for n, g in r["grads"].items())
    den = sum(float(g.square().sum()) for g in r["grads"].values())
    got["grads"] = (num / den) ** 0.5
    per = {n: rel(c["grads"][n], g) for n, g in r["grads"].items()}
    got["grad_tensor"] = max(per.values())
    got["worst"] = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    got["pbias"] = {n: e for n, e in per.items() if "pbias" in n}
    got["delta_of"] = "row update"
    if r.get("row_grads") is not None:
        # the dense-table modes: the rows' gradient, the optimizer's input, over
        # the ids whose gradient is not negligible.  Their first update is no
        # measure of it: AdamW's and Adafactor's move an element by about
        # lr x sign(g) (Adafactor's eps is 1e-30 on g^2), so a gradient
        # within rounding of 0 moves it a whole step either way, and an SGD
        # step lr x g falls below half an ulp of most fp32 rows
        acc = r["row_grads"].abs().max(dim=1).values
        big = acc >= ACCUM_FLOOR * float(acc.max())
        got["accum_all"] = got["accum"] = got["acc_max"] = 0.0
        got["accum_halves"] = [0.0, 0.0]
        got["n_big"], got["n_ids"] = int(big.sum()), int(acc.numel())
        got["delta"] = rel(c["row_grads"][big], r["row_grads"][big])
        got["delta_max"] = float(r["row_grads"].abs().max())
        got["delta_of"] = "row gradient"
        return got
    if r["accum"] is not None:
        acc = r["accum"].max(dim=1).values
        big = acc >= ACCUM_FLOOR * float(acc.max())
        got["accum_all"] = rel(c["accum"], r["accum"])
        got["accum"] = rel(c["accum"][big], r["accum"][big])
        got["accum_halves"] = [rel(c["accum"][big, h], r["accum"][big, h]) for h in (0, 1)]
        got["acc_max"] = float(acc.max())
    else:  # sparse SGD: no accumulator; the rows whose update is not negligible
        acc = (r["rows"] - r["before"]).abs().max(dim=1).values
        big = acc >= ACCUM_FLOOR * float(acc.max())
        got["accum_all"] = got["accum"] = got["acc_max"] = 0.0
        got["accum_halves"] = [0.0, 0.0]
    got["n_big"], got["n_ids"] = int(big.sum()), int(acc.numel())
    dr = (r["rows"] - r["before"])[big]
    got["delta"] = rel((c["rows"] - c["before"])[big], dr)
    got["delta_max"] = float(dr.abs().max())
    return got


def log_compare(head, g, ra, rb):
    """One step comparison (``_compare_steps`` of records ``ra``, ``rb``) on
    one line."""
    log(f"{head}: loss {ra['loss']:.6f} vs {rb['loss']:.6f} "
        f"(rel {g['loss']:.3g}); dense gradients |diff|/|grad| {g['grads']:.3g}, worst "
        "tensors " + ", ".join(f"{n} {e:.3g}" for n, e in g["worst"])
        + "; positional biases "
        + ", ".join(f"{n.split('.')[1]} {e:.3g}" for n, e in sorted(g["pbias"].items()))
        + f"; over the {g['n_big']} of {g['n_ids']} ids whose accumulator is >= "
        f"{ACCUM_FLOOR:g} of the largest: accumulator {g['accum']:.3g} (att, rep halves "
        f"{g['accum_halves'][0]:.3g}, {g['accum_halves'][1]:.3g}; all {g['n_ids']} ids "
        f"{g['accum_all']:.3g}), {g['delta_of']} {g['delta']:.3g} (largest accumulator "
        f"{g['acc_max']:.3g}, largest |{g['delta_of'].split()[1]}| {g['delta_max']:.3g})")


def negative_controls(pin, bands, tag="controls"):
    """The pinned bf16 ``vs_plain`` comparison (``pin``, a ``PinnedPlain``,
    and its held ``bands``) with each wrong plain version of
    ``wrong_plain_versions`` in place of its plain version: each must land
    out of at least one held band, or the check could not fail a wrong
    kernel.  -> {label: the held metrics out of band}."""
    out, passed = {}, []
    for label, g, off in pin.negative_controls(bands):
        log(f"[{tag}] {label}, every ReLU pinned, against the plain step: "
            + ", ".join(f"{m} {g[m]:.4g} (band {b:.4g})" for m, b in bands.items())
            + f"; out of band: {', '.join(off) or 'none'}")
        out[label] = off
        if not off:
            passed.append(label)
    if passed:
        raise AssertionError(f"the bf16 step check passes wrong plain versions: {passed}")
    return out


def train_reference_check(d, cache, dev, amp, tag="check", held_only=False, bands=None,
                          init=None, batch=None):
    """One step from one state on a CHECK_ROWS-row batch, in the compute
    dtype of ``amp``, kernel dropouts on (the counter-hash masks are the
    same everywhere) and the other dropouts off: the card's step against
    the CPU plain path, and against the card's own step with the kernels'
    plain versions; held to CHECK_BANDS[amp].

    Two kinds of row make the card and the CPU part for reasons that are
    not the kernels'.  In bf16 the two sides' selection scores round
    apart, and near-equal scores sort into another slot order (or, at the
    K-th place, another id): such a row runs another positional bias and
    attention, so its gradients differ wholesale.  And a row with an empty
    history (every slot the pad id) feeds the encoder all-zero rows: each
    RMSNorm then divides by sqrt(eps), the row's gradients grow ~1e3-fold
    a norm (the JAX package's model does the same), and the global-norm
    clip scales every other gradient down to where AdaGrad's eps swamps
    the table's.  A third kind in fp32: a ReLU input within rounding of 0
    that takes another sign on each side sends the row's gradient down
    another path.  So the card is held against the CPU on the rows with a
    history whose ordered selection is the same on both sides (and, in
    fp32, whose ReLU inputs take the same signs: ``same_relu_rows``), the
    whole batch and all rows with a history are reported beside, and the
    kernels are held against their plain versions on one device, where
    every selection is the same, over all rows with a history.  A second
    witness: two CPU steps whose matrix products come from two libraries
    (oneDNN's and PyTorch's own).  In bf16 two more (``bf16_witnesses``):
    each side's step against the card's fp32 step, the card held to no
    more than FP32_WITNESS_RATIO times the CPU's distance from it; and the
    card's step with cuBLAS's reduced-precision bf16 reductions off.

    In bf16 the held ``vs_plain`` runs both steps with every ReLU pinned
    to the plain step's signs (``PinnedPlain``; the unpinned pair and its
    ReLU sign flips are reported beside, not held), and the bands of None
    come from the perturbation witness measured in the same run.
    ``held_only``: the two held comparisons alone.  ``bands``: in place of
    CHECK_BANDS[amp] (the K = 148 phase's K148_BANDS).  ``init`` (a
    state_dict) and ``batch`` (numpy arrays): in place of the seeded
    parameters and the cache's first CHECK_ROWS rows (``compact_check``).
    -> the numbers, by name; in bf16 also "pinned": (the ``PinnedPlain``,
    its bands), for ``negative_controls``."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train.trainer import build_model

    d = no_kernel_dropouts(d)
    d["amp"] = amp
    d["model"]["table_dtype"] = "float32"
    cfg = Config.from_dict(d)
    bands = bands or CHECK_BANDS[amp]
    if batch is None:
        batch = next(iter(BatchIterator(cache, batch_size=CHECK_ROWS, train=True)))
    cpu = torch.device("cpu")
    if init is None:
        card_model = init_params(build_model(cfg, cache.dims, dev), seed=77)
    else:
        card_model = build_model(cfg, cache.dims, dev)
        card_model.load_state_dict(init, strict=True)
    init = {k: v.to("cpu", copy=True) for k, v in card_model.state_dict().items()}
    cpu_model = build_model(cfg, cache.dims, cpu)
    cpu_model.load_state_dict(init)
    sel = {"card": selected_ids(card_model, to_device(batch, dev)).cpu(),
           "cpu": selected_ids(cpu_model, to_device(batch, cpu)).cpu()}
    same_rows = (sel["card"] == sel["cpu"]).all(dim=1)
    shared = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(sel["card"], sel["cpu"]))
    got = dict(select=shared / sum(len(set(b.tolist())) for b in sel["cpu"]),
               same_order=float(same_rows.double().mean()))
    nonempty = (sel["cpu"] != cfg.sequence.pad_id).any(dim=1)
    held = same_rows & nonempty
    if bands["same_relu"] is not None:
        n_held = int(held.sum())
        held, dropped = same_relu_rows(((card_model, dev), (cpu_model, cpu)), batch, held)
        got["same_relu"] = 1.0 - dropped / max(n_held, 1)
        log(f"[{tag}] amp={amp} {dropped} of the {n_held} rows with a history and the same "
            f"ordered selection have a ReLU input of another sign on the card than on the CPU")

    def rows_of(mask):
        return {k: v[mask.numpy()] for k, v in batch.items()}

    if not held_only:
        log_grad_norms(cfg, card_model, init, batch, dev, nonempty, rows_of, tag, amp)
    sides = {"card": (card_model, dev, None), "cpu": (cpu_model, cpu, None),
             "cpu, oneDNN off": (cpu_model, cpu, "oneDNN off"),
             "card, plain versions": (card_model, dev, "plain versions")}
    # (label, rows, side, against): the bands name the two held pairs; the
    # pinned bf16 vs_plain is held instead of the unpinned one
    pinned = bands["pinned"]
    plain_label = "vs_plain unpinned (reported, not held)" if pinned else "vs_plain"
    runs = [("whole batch", torch.ones_like(held), "card", "cpu"),
            ("non-empty history", nonempty, "card", "cpu"),
            ("vs_cpu", held, "card", "cpu"),
            (plain_label, nonempty, "card", "card, plain versions"),
            ("witness", held, "cpu, oneDNN off", "cpu")]
    if held_only:
        runs = [r for r in runs if r[0] in ("vs_cpu", "vs_plain")]

    def ids_of(rows):
        ids = torch.unique(sel["card"][rows])
        return ids[torch.isin(ids, sel["cpu"][rows]) & (ids != cfg.sequence.pad_id)]

    recs, found = {}, {}
    for label, rows, a, b in runs:
        t0 = time.time()
        ids = ids_of(rows)
        for side in (a, b):
            key = (side, tuple(rows.tolist()))
            if key not in recs:
                m, x, variant = sides[side]
                recs[key] = _step_record(cfg, m, init, rows_of(rows), x, ids, variant)
        ra, rb = (recs[(side, tuple(rows.tolist()))] for side in (a, b))
        found[label] = g = _compare_steps(ra, rb)
        log_compare(f"[{tag}] amp={amp} {label}: {a} vs {b} ({int(rows.sum())} rows, "
                    f"{time.time() - t0:.1f} s)", g, ra, rb)
    held_bands = dict(bands, vs_plain=dict(bands["vs_plain"]))
    if pinned:
        t0 = time.time()
        pin = PinnedPlain(cfg, card_model, init, rows_of(nonempty), dev, ids_of(nonempty))
        together = bands["witness"] == "all"
        held_bands["vs_plain"], wit = pin.witness(bands["vs_plain"], together=together)
        for k, w in wit.items():
            log(f"[{tag}] amp={amp} vs_plain witness: the plain step with {k}'s bf16 outputs "
                f"{WITNESS_SHARE:.3%} moved by an ulp, against the plain step, both pinned: "
                + ", ".join(f"{m} {w[m]:.4g} (band {b:.4g})"
                            for m, b in held_bands["vs_plain"].items()))
        log(f"[{tag}] amp={amp} vs_plain derived bands (the largest witness"
            + (", all four at once among them" if together else "")
            + f", at most {WITNESS_CAP}): " + ", ".join(
                f"{m} {held_bands['vs_plain'][m]:.4g}" for m, b in bands["vs_plain"].items()
                if b is None))
        flips = pin.flips(contextlib.nullcontext)
        rec = pin.record(contextlib.nullcontext)
        found["vs_plain"] = g = _compare_steps(rec, pin.plain)
        log_compare(f"[{tag}] amp={amp} vs_plain: card vs card, plain versions, every ReLU "
                    f"pinned to the plain step's signs ({int(nonempty.sum())} rows, "
                    f"{time.time() - t0:.1f} s with the witness; {flips} ReLU inputs take "
                    f"another sign unpinned)", g, rec, pin.plain)
        got["pinned"] = (pin, held_bands["vs_plain"])
        got["relu flips"] = flips
    if amp == "bf16" and not held_only:
        got.update(bf16_witnesses(d, cfg, cache.dims, batch, init, (card_model, cpu_model), sel,
                                  held, recs, dev, tag))
    failed = [k for k in ("select", "same_order", "same_relu")
              if bands[k] is not None and not got[k] >= bands[k]]
    for pair in ("vs_cpu", "vs_plain"):
        for k, band in held_bands[pair].items():
            got[f"{pair} {k}"] = found[pair][k]
            if not found[pair][k] <= band:
                failed.append(f"{pair} {k}")
    def band(k):
        return "reported, not held" if bands[k] is None else f"band {bands[k]}"

    log(f"[{tag}] one amp={amp} train step on {CHECK_ROWS} rows: selected ids shared "
        f"{got['select']:.4%} ({band('select')}), rows with the same ordered selection "
        f"{got['same_order']:.4%} ({band('same_order')})"
        + (f", of them with the same ReLU signs {got['same_relu']:.4%} (band "
           f"{bands['same_relu']})" if bands["same_relu"] is not None else "") + "; held: "
        + "; ".join(f"{pair} " + ", ".join(f"{k} {found[pair][k]:.3g} (band {b:.4g})"
                                           for k, b in held_bands[pair].items())
                    for pair in ("vs_cpu", "vs_plain")))
    if amp == "bf16" and not held_only and not got["fp32 ratio"] <= FP32_WITNESS_RATIO:
        failed.append("fp32 ratio")
    if failed:
        raise AssertionError(f"the card's {amp} train step disagrees: {failed}")
    return got


def bf16_witnesses(d, cfg, dims, batch, init, models, sel, held, recs, dev, tag):
    """How far the card's bf16 step lands from the CPU's, set beside how far
    each lands from the fp32 step (the card's, which agrees with the
    CPU's fp32 step within CHECK_BANDS["none"]), on the held rows whose
    fp32 selection is theirs too; and the card's step with
    ``allow_bf16_reduced_precision_reduction`` off against the CPU's on the
    held rows.  Two bf16 steps that each land about as far from fp32 as
    they land from each other part by rounding order; a card step much
    farther from fp32 than the CPU's would be a fault of the card's
    path.  -> the numbers, by name."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.train.trainer import build_model

    card_model, cpu_model = models
    cpu = torch.device("cpu")
    f_cfg = Config.from_dict({**copy.deepcopy(d), "amp": "none"})
    f_model = build_model(f_cfg, dims, dev)
    f_model.load_state_dict(init)
    rows = held & (selected_ids(f_model, to_device(batch, dev)).cpu() == sel["cpu"]).all(dim=1)
    sub = {k: v[rows.numpy()] for k, v in batch.items()}
    ids = torch.unique(sel["cpu"][rows])
    ids = ids[ids != cfg.sequence.pad_id]
    card = _step_record(cfg, card_model, init, sub, dev, ids)
    on_cpu = _step_record(cfg, cpu_model, init, sub, cpu, ids)
    truth = _step_record(f_cfg, f_model, init, sub, dev, ids)
    del f_model
    torch.cuda.empty_cache()
    gc, gp, gx = (_compare_steps(a, b) for a, b in ((card, truth), (on_cpu, truth),
                                                    (card, on_cpu)))
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ids_h = torch.unique(sel["card"][held])
        ids_h = ids_h[torch.isin(ids_h, sel["cpu"][held]) & (ids_h != cfg.sequence.pad_id)]
        held_rows = {k: v[held.numpy()] for k, v in batch.items()}
        exact = _step_record(cfg, card_model, init, held_rows, dev, ids_h)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    key = tuple(held.tolist())
    gr = _compare_steps(exact, recs[("cpu", key)])
    g_on = _compare_steps(recs[("card", key)], recs[("cpu", key)])
    out = {"fp32 card": gc["grads"], "fp32 cpu": gp["grads"], "fp32 card vs cpu": gx["grads"],
           "fp32 ratio": gc["grads"] / gp["grads"], "rpr off vs_cpu": gr["grads"]}
    log(f"[{tag}] amp=bf16 fp32 witness ({int(rows.sum())} rows whose fp32 selection agrees "
        f"too): dense gradients |diff|/|grad| card bf16 vs the card's fp32 step "
        f"{gc['grads']:.4g}, CPU bf16 vs it {gp['grads']:.4g}, card vs CPU {gx['grads']:.4g} "
        f"(the card at {out['fp32 ratio']:.3f} of the CPU's distance, band "
        f"{FP32_WITNESS_RATIO}); loss {gc['loss']:.3g} / {gp['loss']:.3g}, accumulator "
        f"{gc['accum']:.3g} / {gp['accum']:.3g}, row update {gc['delta']:.3g} / "
        f"{gp['delta']:.3g}")
    log(f"[{tag}] amp=bf16 with cuBLAS's reduced-precision bf16 reductions off: vs_cpu dense "
        f"gradients {gr['grads']:.4g} (on: {g_on['grads']:.4g})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.infer import infer_main
    from tossctr_tpu_torch.ops import _build, launch_counts, reset_launch_counts

    t0 = time.time()
    _build.build()
    log(f"[build] {len(_build.KERNELS)} kernels built in {time.time() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    d = flagship_config_dict()
    base_cfg = Config.from_dict(copy.deepcopy(d))
    kernels = kernel_phase(base_cfg, dev)
    torch.cuda.empty_cache()
    module_launches = mha_module_check(base_cfg, dev)
    t0 = time.time()
    probe_rows, probe_launches = scatter_probe_phase(dev)
    kernels.update(probe_rows)
    probe_wall = time.time() - t0
    t0 = time.time()
    dump_rows, dump_launches = dropout_check_phase(dev)
    kernels.update(dump_rows)
    dump_wall = time.time() - t0

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.time()
        man = write_synth_cache_for(base_cfg, os.path.join(tmp, "cache", "test"), N_ROWS,
                                    num_dim=N_NUM, seed=7)
        d.update(exp_name="chip_smoke")
        d["logging"]["log_dir"] = os.path.join(tmp, "runs")
        d["data"]["manifest_test"] = man
        cfg = Config.from_dict(d)
        cache = ShardCache(man)
        log(f"[serve] synthetic cache: {len(cache)} rows, dims {cache.dims}, "
            f"{time.time() - t0:.1f} s")
        write_checkpoints(cfg, cache.dims, dev)

        n_batches = -(-len(cache) // cfg.train.batch_size)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        path = infer_main(cfg)
        wall = time.time() - t0
        counts = launch_counts()
        want = N_FOLDS * n_batches * cfg.sequence.tfm.n_layers
        log(f"[serve] infer_main wrote {path} in {wall:.2f} s (checkpoint loading included): "
            f"{len(cache) / wall:.1f} examples/s end to end")
        expected = {k: want if k in RMS_ENCODER and not k.endswith("_bwd") else 0
                    for k in counts}
        log(f"[serve] launches during infer_main: {counts}, expected {want} of each encoder "
            f"forward kernel ({N_FOLDS} folds x {n_batches} batches x "
            f"{cfg.sequence.tfm.n_layers} layers), no backward, and no FM-cross kernel (the "
            f"plain path without model.extra.use_pallas_fm)")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts} != {expected}")
        probs = check_submission(path, cache)
        log(f"[serve] submission: {len(probs)} rows, unique ids, probabilities in "
            f"[{probs.min():.6f}, {probs.max():.6f}], mean {probs.mean():.6f}")
        reference_check(cfg, cache, dev)
        throughput_and_profile(cfg, cache, dev)
        del cache
        torch.cuda.empty_cache()

        t0 = time.time()
        train_man = write_synth_cache_for(base_cfg, os.path.join(tmp, "cache", "train"),
                                          TRAIN_BATCHES * base_cfg.train.batch_size,
                                          num_dim=N_NUM, seed=11)
        train_cache = ShardCache(train_man)
        log(f"[train] synthetic train cache: {len(train_cache)} rows, {time.time() - t0:.1f} s")
        train_launches = training_phase(base_cfg, train_cache, dev)
        for amp in CHECK_BANDS:
            checked = train_reference_check(flagship_config_dict(), train_cache, dev, amp)
            if "pinned" in checked:
                negative_controls(*checked["pinned"])
        t0 = time.time()
        layer_launches, layer_served = layernorm_phase(tmp, man, train_cache, dev)
        layer_wall = time.time() - t0
        t0 = time.time()
        stream_launches = stream_phase(train_cache, dev)
        stream_wall = time.time() - t0
        t0 = time.time()
        select_launches = select_phase(tmp, train_cache, man, dev)
        select_wall = time.time() - t0
        t0 = time.time()
        ref_launches = reference_tables_phase(tmp, train_cache, dev)
        ref_wall = time.time() - t0
        del train_cache
        torch.cuda.empty_cache()
        t0 = time.time()
        k120_launches, k120_served = k120_phase(tmp, dev)
        k120_wall = time.time() - t0
        t0 = time.time()
        k148_launches = k148_phase(tmp, dev)
        k148_wall = time.time() - t0
        t0 = time.time()
        fold_launches, fold_served = fold_phase(tmp, man, dev)
        fold_wall = time.time() - t0

    for name, r in kernels.items():
        # launches_reference_tables: the reference-tables phase's counted
        # runs summed (each held to its own expected counts there);
        # launches_select: the select phase's proxy steps (3 layers a step).
        # Each kernel's launches on the path that is its own: the RMSNorm
        # encoder kernels' in the training phase, fused_ffn's in the
        # LayerNorm phase, fused_mha's in its module check (no config serves
        # it: its serving count is the serving phase's, read there), the FM
        # pair's in the fold phase, the table update's in the streaming phase's
        # sweep mode, the table sweeps' in the scatter probe, the mask dumps'
        # in the dropout check
        if name in probe_rows:
            r["launches"], r["launches_serving"] = probe_launches[name], counts[name]
        elif name in dump_rows:
            r["launches"], r["launches_serving"] = dump_launches[name], counts[name]
        elif name == "sweep_rows_add":
            r["launches"], r["launches_serving"] = stream_launches[name], counts[name]
        elif name.startswith("fm_cross"):
            r["launches"], r["launches_serving"] = fold_launches[name], fold_served[name]
        elif name.startswith("fused_ffn"):
            r["launches"], r["launches_serving"] = layer_launches[name], layer_served[name]
        elif name.startswith("fused_mha") and not name.startswith("fused_mha_qkv"):
            r["launches"], r["launches_serving"] = module_launches[name], counts[name]
        else:
            r["launches"], r["launches_serving"] = train_launches[name], counts[name]
        r["launches_fold"] = fold_launches[name]
        r["launches_layernorm"] = layer_launches[name]
        r["launches_k120"], r["launches_k120_serving"] = k120_launches[name], k120_served[name]
        r["launches_k148"] = k148_launches[name]
        r["launches_reference_tables"] = ref_launches[name]
        r["launches_select"] = select_launches[name]
    total = time.time() - T_START
    log(f"[time] the whole script {total:.1f} s, the fold phase {fold_wall:.1f} s, the "
        f"LayerNorm phase {layer_wall:.1f} s, the streaming phase {stream_wall:.1f} s, the "
        f"select phase {select_wall:.1f} s, the "
        f"reference-tables phase {ref_wall:.1f} s, the "
        f"K = 120 phase {k120_wall:.1f} s, the K = 148 phase {k148_wall:.1f} s, the scatter "
        f"probe {probe_wall:.1f} s and the dropout check {dump_wall:.1f} s of it")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
