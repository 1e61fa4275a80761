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
   wrapper's sort, search and kernels timed apart.
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
9. K = 120 phase: ``cfgs/v3_k120_s1_tpu.yaml`` at full width (K = 120,
   4 layers, S1 query): timed steps through the encoder kernels at K =
   120, the fp32 512-row step against the CPU and the plain versions, the
   weights served from a fold checkpoint through ``infer_main``, held
   against the CPU plain path within 0.02.  Then the K = 148 phase:
   ``cfgs/v3_k148_s1_tpu.yaml`` at full width (K = 152 padded, B = 4096,
   4 layers): timed steps with their launch counts and profile, and the
   bf16 512-row step against the CPU and, with the ReLUs pinned and the
   witness's bands, against the plain versions on the card.
10. ``fused_mha`` module check: no config reaches ``fused_mha``, so the
   card runs it in its module: ``MultiHeadSelfAttention`` with
   ``fuse_qkv`` off (qkv Dense, ``fused_mha``) against ``fuse_qkv`` on
   (``fused_mha_qkv``) on the same parameters at the flagship shapes, the
   output and the gradients of x, the bias and every parameter, in bf16
   (one launch each of ``fused_mha`` and its backward) and in fp32.
11. Scatter-probe phase: ``python -m tossctr_tpu_torch.exp.scatter_probe``'s
   measurements on its three tables (the JAX probe's (10M, 64) bf16 with
   245,760 ids, the flagship's (10M, 128) with 524,288 uniform and with
   524,288 zipf:1.0 ids): ``index_add_``,
   the dense and the sparse table sweep at W = 1024, 4096, 16384, and
   ``sweep_rows_add``, timed with the launch counts read around them;
   then the two sweeps bit-equal to their plain versions on each table.
12. Dropout-check phase: ``python -m
   tossctr_tpu_torch.exp.hw_dropout_device_check`` at the flagship
   geometry: the mask dumps bit-equal to the plain masks, the eight
   dropping encoder kernels in fp32 against a float64 oracle on the
   dumped masks (outputs and every gradient), the keep rates and the
   independence of the decisions within 1e-3, and the persistent kernels'
   results against a grid of a few blocks; the dumps timed.
13. Prints the ``kernels`` JSON line (the thirteen rows' kernels: the
   eleven ported kernels, the two table sweeps and the two mask dumps),
   then ``{"ok": true, "device": ...}``.

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
    head = cases[0]  # uniform ids: the headline row; every case beside it
    return dict(name="sweep_rows_add", route="cuda",
                source="tossctr_tpu_torch/csrc/sweep_rows_add.cu",
                replaces="tossctr_tpu/ops/pallas_scatter.py:224",
                max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"],
                library_call="Tensor.index_add_ of the bf16 deltas (atomics, bf16 sums)",
                cases=cases)


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
    if t.embedding_optimizer == "sparse_sgd":
        return "table"
    if t.extra.get("exact_dedup", False):
        return "accumulator"
    return "table" if t.extra.get("table_update", "auto") == "sweep" else "table or accumulator"


def first_step(cfg, model, state, step, batch, tag, require_change=True):
    """The first train step, checked: it changes only table rows the batch
    selected, never the pad row, and (``require_change``) some dense
    parameters and some rows of what ``must_change`` names.
    -> (state, loss)."""
    import torch

    from tossctr_tpu_torch.train.trainer import dense_params

    table = model.dare.emb_tables
    opt = state.table_opt.get("emb_tables")  # sparse SGD keeps no accumulator
    accum = opt.accum if opt is not None else torch.zeros(table.shape[0], 1, device=table.device)
    sel = selected_ids(model, batch)
    before, acc_before = table.detach().clone(), accum.clone()
    dense_before = torch.cat([p.detach().reshape(-1).float() for p in dense_params(model).values()])
    t0 = time.time()
    state, loss = step(state, batch)
    first = float(loss)
    log(f"[{tag}] step 1: loss {first:.6f}, {time.time() - t0:.2f} s (first call)")
    dense_after = torch.cat([p.detach().reshape(-1).float() for p in dense_params(model).values()])
    dense_moved = int((dense_after != dense_before).sum())
    changed = torch.nonzero((table != before).any(dim=1))[:, 0]
    acc_changed = torch.nonzero((accum != acc_before).any(dim=1))[:, 0]
    pad = cfg.sequence.pad_id
    touched = torch.unique(sel)
    touched = touched[touched != pad]
    outside = changed[~torch.isin(changed, touched)]
    pad_moved = bool((table[pad] != before[pad]).any() or (accum[pad] != acc_before[pad]).any())
    log(f"[{tag}] step 1: {dense_moved} of {dense_before.numel()} dense parameters moved; the "
        f"batch selected {touched.numel()} distinct non-pad ids; "
        + (f"{acc_changed.numel()} rows of the fp32 AdaGrad accumulator changed, "
           f"{int((~torch.isin(acc_changed, touched)).sum())} of them not selected; "
           if opt is not None else "no accumulator (sparse SGD); ")
        + f"{changed.numel()} bf16 table rows changed, {outside.numel()} of them not selected; "
        f"pad row changed: {pad_moved}")
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


def profile_step(state, step, batch, tag):
    """One train step under torch.profiler: device time by kernel, the
    device's busy share of the step's wall time, and the port's kernels'
    share of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in dev_events) / 1e6
    ours = ("mha_qkv_fwd", "block_tail_fwd", "mha_qkv_bwd", "block_tail_bwd", "ffn_fwd",
            "ffn_bwd", "mha_fwd", "mha_bwd", "fm_fwd", "fm_bwd", "fm_dv", "reduce_partials",
            "sweep_pieces", "sweep_merge")
    ours_s = sum(e.self_device_time_total for e in dev_events
                 if any(k in e.key for k in ours)) / 1e6
    table_txt = events.table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=60)
    log(f"[profile] one {tag} step, by device time:")
    for line in table_txt.splitlines():
        log("  " + line)
    log(f"[profile] {tag} step: device busy {1e3 * device_s:.3f} ms of {1e3 * prof_wall:.3f} ms "
        f"wall = {device_s / prof_wall:.1%} (under the profiler); the port's kernels "
        f"{1e3 * ours_s:.3f} ms = {ours_s / max(device_s, 1e-12):.1%} of device time")
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
    counts read around it; then the two dump kernels against their plain
    masks and timed, outside the counted run.  -> the ``kernels`` rows of
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
    AdaGrad accumulator at ``ids`` before and after.  ``variant``:
    "oneDNN off" runs the CPU's matrix products through PyTorch's own
    kernels instead of oneDNN's; "plain versions" runs the card's step
    with the plain versions of the kernels; a callable returns the
    context manager the step runs in."""
    import torch

    from tossctr_tpu_torch.train.trainer import dense_params

    model.load_state_dict(init)
    state, step = trainer_for(cfg, model)
    table = model.dare.emb_tables
    on = ids.to(device)
    before = table[on].double().cpu()
    ctx = variant if callable(variant) else {
        None: contextlib.nullcontext, "plain versions": plain_versions_on_card,
        "oneDNN off": lambda: torch.backends.mkldnn.flags(enabled=False)}[variant]
    with ctx():
        state, loss = step(state, to_device(batch, device))
    opt = state.table_opt.get("emb_tables")
    rec = dict(loss=float(loss), before=before, rows=table[on].double().cpu(),
               accum=None if opt is None else opt.accum[on].double().cpu(),
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
    from tossctr_tpu_torch.train.trainer import dense_params

    taps = {}
    z, _, aux = model(b, taps=taps)
    w = float(cfg.model.qnn_alpha.aux_head_weight)
    valid = b.get("valid")
    (bce_wll_style(z, b["y"], valid) + w * bce_wll_style(aux, b["y"], valid)).backward()
    grads = [p.grad for p in dense_params(model).values() if p.grad is not None]
    total = sum(float(g.double().square().sum()) for g in grads + [taps["table_rows"].grad])
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
    ACCUM_FLOOR of the largest the accumulator and the rows' update."""

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
        f"{g['accum_all']:.3g}), row update {g['delta']:.3g} (largest accumulator "
        f"{g['acc_max']:.3g}, largest |update| {g['delta_max']:.3g})")


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


def train_reference_check(d, cache, dev, amp, tag="check", held_only=False, bands=None):
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
    CHECK_BANDS[amp] (the K = 148 phase's K148_BANDS).  -> the numbers, by
    name; in bf16 also "pinned": (the ``PinnedPlain``, its bands), for
    ``negative_controls``."""
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
    batch = next(iter(BatchIterator(cache, batch_size=CHECK_ROWS, train=True)))
    cpu = torch.device("cpu")
    card_model = init_params(build_model(cfg, cache.dims, dev), seed=77)
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
    log(f"[{tag}] one amp={amp} train step on {CHECK_ROWS} rows: selected ids shared "
        f"{got['select']:.4%} (band {bands['select']}), rows with the same ordered selection "
        f"{got['same_order']:.4%} (band {bands['same_order']})"
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
        # each kernel's launches on the path that is its own: the RMSNorm
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
    total = time.time() - T_START
    log(f"[time] the whole script {total:.1f} s, the fold phase {fold_wall:.1f} s, the "
        f"LayerNorm phase {layer_wall:.1f} s, the streaming phase {stream_wall:.1f} s, the "
        f"K = 120 phase {k120_wall:.1f} s, the K = 148 phase {k148_wall:.1f} s, the scatter "
        f"probe {probe_wall:.1f} s and the dropout check {dump_wall:.1f} s of it")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
