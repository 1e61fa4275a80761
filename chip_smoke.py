"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without a CUDA card.
2. Builds the hand-written kernels from ``tossctr_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
3. Kernel phase, at the flagship shapes in bf16: the two encoder forward
   kernels with dropout off (serving) and on (training, p = 0.1), the two
   encoder backward kernels with dropout on, and the FM-cross pair at the
   QNN-alpha head's shapes (also in fp32), each against its plain PyTorch
   version (error and tolerance), its time from CUDA events beside the
   plain version's, a PyTorch yardstick where PyTorch computes the same
   function, and the least time the card could take.
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
   the rows each comparison holds and the gaps reported beside).  The
   serving and training phases run the QNN head's plain FM path.
6. Fold phase: the K-fold entry point at full width with the FM-cross
   kernels (``model.extra.use_pallas_fm``): ``train_main`` over a
   synthetic train cache of FOLD_ROWS rows, cut to one fold of five and
   FOLD_EPOCHS epochs (the cuts are printed), then the training CLI again
   (it must skip the finished fold) and ``infer_main`` on the fold's
   checkpoint.  Checks the train log, the checkpoint, the submission and
   every kernel's launches; reports wall time, ms/step and the FM
   kernels' share of the device time.
7. Prints the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Any failure exits non-zero before the last line.  Scratch files live in a
temporary directory under ``build/`` that is removed at exit.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
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
# the one-step check, by compute dtype.  The table is stored in fp32, so
# that one step's row update is visible (at the flagship lr a first
# AdaGrad step moves a N(0, 1) bf16 row by under half an ulp: in bf16
# storage neither side would change it).  select: share of each row's
# selected ids found on the card and on the CPU; same_order: share of the
# rows whose ordered selection is the same on both.  vs_cpu, the card
# against the CPU on the rows with a history and the same ordered
# selection; vs_plain, the card's kernels against their plain versions on
# the card, on every row with a history: loss, relative; grads, norm of
# the difference over the norm for all dense gradients together;
# grad_tensor, the same for the worst single tensor (the positional
# biases among them); accum, delta: the same for the AdaGrad accumulator
# and the rows' update over the ids whose accumulator is >= ACCUM_FLOOR of
# the largest (the others carry a gradient below AdaGrad's eps).
ACCUM_FLOOR = 1e-6
_HELD = ("loss", "grads", "grad_tensor", "accum", "delta")
CHECK_BANDS = {
    "bf16": dict(select=0.999, same_order=0.3,
                 vs_cpu=dict(zip(_HELD, (1e-3, 3e-2, 8e-2, 5e-2, 6e-2))),
                 vs_plain=dict(zip(_HELD, (5e-4, 6e-3, 1e-2, 3e-3, 2.5e-2)))),
    "none": dict(select=0.999, same_order=0.999,
                 vs_cpu=dict(zip(_HELD, (1e-6, 2e-6, 1e-5, 1e-5, 1e-4))),
                 vs_plain=dict(zip(_HELD, (1e-6, 2e-6, 1e-5, 1e-5, 1e-4)))),
}


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_tolerance(ref) -> float:
    """3 bf16 ulps of the output's largest magnitude: the kernel and the
    plain version sum in other orders, so each bf16 rounding point can
    land one ulp apart."""
    top = float(ref.float().abs().max())
    return 3.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    del got, want
    xg, wg, bg = (t.detach().requires_grad_() for t in (x, wqkv, bqkv))
    out = sdpa_yardstick(xg, wg, bg)
    grad_bytes = 4 * (D * 3 * D + 3 * D + K * K)
    b_ms, b_by = bound_ms(nbytes(x, wqkv, bqkv, bias, do) + nbytes(x) + grad_bytes,
                          2 * B * K * D * 3 * D * 3 + 10 * B * K * K * D)
    results["fused_mha_qkv_bwd"] = dict(
        name="fused_mha_qkv_bwd", route="cuda",
        source="tossctr_tpu_torch/csrc/fused_mha_qkv_bwd.cu",
        replaces="tossctr_tpu/ops/pallas_attention.py:1101",
        max_abs_err=max(errs), dropout_p=P_DROP,
        ms=cuda_time_ms(lambda: fused_mha_qkv_bwd(*bw)),
        plain_ms=cuda_time_ms(lambda: fused_mha_qkv_bwd_reference(*bw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_time_ms(
            lambda: torch.autograd.grad(out, (xg, wg, bg), do, retain_graph=True)),
        library_call="backward of the torch.matmul projection + "
                     "F.scaled_dot_product_attention (retain_graph; no dropout, no dbias)",
    )
    del x, do, out, xg, wg, bg, bw

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
    b_ms, b_by = bound_ms(nbytes(*targs) + N * D * 2, 2 * N * (D * D + 2 * D * Fh))
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
    b_ms, b_by = bound_ms(nbytes(*targs, dy) + 2 * N * D * 2 + grad_bytes,
                          2 * N * (D * D + 2 * D * Fh) + 2 * N * (4 * D * Fh + 2 * D * D))
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
    results.update(fm_kernel_rows(cfg, dev, g))
    for r in results.values():
        extra = (f", dropout off {r['ms_no_dropout']:.4f} ms (plain {r['plain_ms_no_dropout']:.4f})"
                 if "ms_no_dropout" in r else "")
        if "multihead_ms" in r:
            extra = f", the plain einsum path (fm_cross_multihead) {r['multihead_ms']:.4f} ms"
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"yardstick {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms{extra}")
    return results


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
    from tossctr_tpu_torch.ops.fm_cross import fm_cross_pallas_fwd

    qa = cfg.model.qnn_alpha
    B, D = cfg.train.batch_size, cfg.model.emb_dim
    F = 1 + 2 * N_NUM + len(cfg.data.cat_cols)
    H, R, P = qa.heads, qa.rank, qa.proj_dim
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
    b_ms, b_by = bound_ms(fwd_bytes, flops_a + 3 * B * F * H * R + 2 * B * H * R * P)
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
    b_ms, b_by = bound_ms(bwd_bytes, 3 * flops_a + 4 * B * H * R * P + 6 * B * F * H * R)
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


def reference_check(cfg, cache, dev, rows=512):
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
    log(f"[check] fold 0 on {rows} rows, card kernels vs CPU plain path: "
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


def training_phase(cfg, cache, dev):
    """Full-width train steps over rotating batches: the slice's main path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    # one step changes only table rows the batch selected, never the pad row
    table, accum = model.dare.emb_tables, state.table_opt["emb_tables"].accum
    sel = selected_ids(model, batches[0])
    before, acc_before = table.detach().clone(), accum.clone()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, loss = step(state, batches[0])
    first = float(loss)
    log(f"[train] step 1: loss {first:.6f}, {time.time() - t0:.2f} s (first call)")
    changed = torch.nonzero((table != before).any(dim=1))[:, 0]
    acc_changed = torch.nonzero((accum != acc_before).any(dim=1))[:, 0]
    pad = cfg.sequence.pad_id
    touched = torch.unique(sel)
    touched = touched[touched != pad]
    outside = changed[~torch.isin(changed, touched)]
    pad_moved = bool((table[pad] != before[pad]).any() or (accum[pad] != acc_before[pad]).any())
    log(f"[train] step 1: the batch selected {touched.numel()} distinct non-pad ids; "
        f"{acc_changed.numel()} rows of the fp32 AdaGrad accumulator changed, "
        f"{int((~torch.isin(acc_changed, touched)).sum())} of them not selected; "
        f"{changed.numel()} bf16 table rows changed, {outside.numel()} of them not selected; "
        f"pad row changed: {pad_moved}")
    if (acc_changed.numel() == 0 or outside.numel() or pad_moved
            or not bool(torch.isin(acc_changed, touched).all())):
        raise AssertionError("the table update touched rows it should not have")
    del before, acc_before
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
    expected = {k: 0 if k.startswith("fm_cross") else 3 * TRAIN_STEPS for k in launches}
    log(f"[train] launches during the {TRAIN_STEPS} steps: {launches}, expected {expected} "
        f"(3 layers a step; the QNN takes its plain path without model.extra.use_pallas_fm)")
    if not all(np.isfinite(losses)) or not np.isfinite(first):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batches[0])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in dev_events) / 1e6
    ours = ("mha_qkv_fwd", "block_tail_fwd", "mha_qkv_bwd", "block_tail_bwd", "reduce_partials")
    ours_s = sum(e.self_device_time_total for e in dev_events
                 if any(k in e.key for k in ours)) / 1e6
    table_txt = events.table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=60)
    log("[profile] one train step, by device time:")
    for line in table_txt.splitlines():
        log("  " + line)
    log(f"[profile] train step: device busy {1e3 * device_s:.3f} ms of {1e3 * prof_wall:.3f} ms "
        f"wall = {device_s / prof_wall:.1%} (under the profiler); the port's kernels "
        f"{1e3 * ours_s:.3f} ms = {ours_s / max(device_s, 1e-12):.1%} of device time")
    del state, step, model, batches
    torch.cuda.empty_cache()
    return launches


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
            want[k] = n_layers * (steps if k.endswith("_bwd") else steps + val_batches)
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
    want = {k: 0 if k.endswith("_bwd") else n_batches * (1 if k.startswith("fm") else n_layers)
            for k in served}
    log(f"[fold] infer_main served the fold's checkpoint: {path} in {serve_wall:.2f} s; "
        f"launches {served}, expected {want}")
    if served != want:
        raise AssertionError(f"serving launches {served} != {want}")
    probs = check_submission(path, cache)
    log(f"[fold] submission: {len(probs)} rows, probabilities in [{probs.min():.6f}, "
        f"{probs.max():.6f}], mean {probs.mean():.6f}")
    torch.cuda.empty_cache()
    return counts, served


@contextlib.contextmanager
def plain_versions_on_card():
    """The four kernels' wrappers swapped for their plain PyTorch versions,
    which then run on the card: a witness that splits the card's rounding
    between the kernels and the rest of the step."""
    from tossctr_tpu_torch.ops import fused_attention as fa
    from tossctr_tpu_torch.ops import fused_ffn as ff

    swaps = [(fa, "fused_mha_qkv_fwd", fa.fused_mha_qkv_reference),
             (fa, "fused_mha_qkv_bwd", fa.fused_mha_qkv_bwd_reference),
             (ff, "fused_block_tail_fwd", ff.fused_block_tail_reference),
             (ff, "fused_block_tail_bwd", ff.fused_block_tail_bwd_reference)]
    saved = [getattr(m, n) for m, n, _ in swaps]
    try:
        for m, n, plain in swaps:
            setattr(m, n, plain)
        yield
    finally:
        for (m, n, _), fn in zip(swaps, saved):
            setattr(m, n, fn)


def _step_record(cfg, model, init, batch, device, ids, variant=None):
    """One train step of ``model`` from the parameters ``init`` on
    ``batch``: the loss, each dense gradient, and the table rows and
    AdaGrad accumulator at ``ids`` before and after.  ``variant``:
    "oneDNN off" runs the CPU's matrix products through PyTorch's own
    kernels instead of oneDNN's; "plain versions" runs the card's step
    with the plain versions of the kernels."""
    import torch

    from tossctr_tpu_torch.train.trainer import dense_params

    model.load_state_dict(init)
    state, step = trainer_for(cfg, model)
    table = model.dare.emb_tables
    on = ids.to(device)
    before = table[on].double().cpu()
    ctx = {None: contextlib.nullcontext(),
           "oneDNN off": torch.backends.mkldnn.flags(enabled=False),
           "plain versions": plain_versions_on_card()}[variant]
    with ctx:
        state, loss = step(state, to_device(batch, device))
    rec = dict(loss=float(loss), before=before, rows=table[on].double().cpu(),
               accum=state.table_opt["emb_tables"].accum[on].double().cpu(),
               grads={n: p.grad.double().cpu() for n, p in dense_params(model).items()})
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _grad_norm(cfg, model, init, batch, device):
    """The global norm of the dense and table-row gradients of the loss
    (deterministic forward) from the parameters ``init``: what the step
    clips to ``train.grad_clip_norm``."""
    from tossctr_tpu_torch.train.loss import bce_wll_style
    from tossctr_tpu_torch.train.trainer import dense_params

    model.load_state_dict(init)
    b, taps = to_device(batch, device), {}
    z, _, aux = model(b, taps=taps)
    w = float(cfg.model.qnn_alpha.aux_head_weight)
    (bce_wll_style(z, b["y"], b["valid"]) + w * bce_wll_style(aux, b["y"], b["valid"])).backward()
    grads = [p.grad for p in dense_params(model).values() if p.grad is not None]
    total = sum(float(g.double().square().sum()) for g in grads + [taps["table_rows"].grad])
    for p in model.parameters():
        p.grad = None
    return total ** 0.5


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
    acc = r["accum"].max(dim=1).values
    big = acc >= ACCUM_FLOOR * float(acc.max())
    got["n_big"], got["n_ids"] = int(big.sum()), int(acc.numel())
    got["accum_all"] = rel(c["accum"], r["accum"])
    got["accum"] = rel(c["accum"][big], r["accum"][big])
    got["accum_halves"] = [rel(c["accum"][big, h], r["accum"][big, h]) for h in (0, 1)]
    dr = (r["rows"] - r["before"])[big]
    got["delta"] = rel((c["rows"] - c["before"])[big], dr)
    got["acc_max"], got["delta_max"] = float(acc.max()), float(dr.abs().max())
    return got


def train_reference_check(d, cache, dev, amp):
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
    the table's.  So the card is held against the CPU on the rows with a
    history whose ordered selection is the same on both sides, the whole
    batch and all rows with a history are reported beside, and the
    kernels are held against their plain versions on one device, where
    every selection is the same, over all rows with a history.  A second
    witness: two CPU steps whose matrix products come from two libraries
    (oneDNN's and PyTorch's own)."""
    import torch

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.data import BatchIterator
    from tossctr_tpu_torch.models import init_params
    from tossctr_tpu_torch.train.trainer import build_model

    d = no_kernel_dropouts(d)
    d["amp"] = amp
    d["model"]["table_dtype"] = "float32"
    cfg = Config.from_dict(d)
    bands = CHECK_BANDS[amp]
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

    def rows_of(mask):
        return {k: v[mask.numpy()] for k, v in batch.items()}

    log(f"[check] amp={amp} global gradient norm before the clip (card, no dropout): whole "
        f"batch {_grad_norm(cfg, card_model, init, batch, dev):.6g}; its "
        f"{int(nonempty.sum())} rows with a non-empty history "
        f"{_grad_norm(cfg, card_model, init, rows_of(nonempty), dev):.6g} (the clip is at "
        f"{cfg.train.grad_clip_norm}; {int((~nonempty).sum())} rows have an empty history)")
    sides = {"card": (card_model, dev, None), "cpu": (cpu_model, cpu, None),
             "cpu, oneDNN off": (cpu_model, cpu, "oneDNN off"),
             "card, plain versions": (card_model, dev, "plain versions")}
    # (label, rows, side, against): the bands name the two held pairs
    runs = [("whole batch", torch.ones_like(held), "card", "cpu"),
            ("non-empty history", nonempty, "card", "cpu"),
            ("vs_cpu", held, "card", "cpu"),
            ("vs_plain", nonempty, "card", "card, plain versions"),
            ("witness", held, "cpu, oneDNN off", "cpu")]
    recs, found = {}, {}
    for label, rows, a, b in runs:
        t0 = time.time()
        ids = torch.unique(sel["card"][rows])
        ids = ids[torch.isin(ids, sel["cpu"][rows]) & (ids != cfg.sequence.pad_id)]
        for side in (a, b):
            key = (side, tuple(rows.tolist()))
            if key not in recs:
                m, x, variant = sides[side]
                recs[key] = _step_record(cfg, m, init, rows_of(rows), x, ids, variant)
        ra, rb = (recs[(side, tuple(rows.tolist()))] for side in (a, b))
        found[label] = g = _compare_steps(ra, rb)
        log(f"[check] amp={amp} {label}: {a} vs {b} ({int(rows.sum())} rows, "
            f"{time.time() - t0:.1f} s): loss {ra['loss']:.6f} vs {rb['loss']:.6f} "
            f"(rel {g['loss']:.3g}); dense gradients |diff|/|grad| {g['grads']:.3g}, worst "
            "tensors " + ", ".join(f"{n} {e:.3g}" for n, e in g["worst"])
            + "; positional biases "
            + ", ".join(f"{n.split('.')[1]} {e:.3g}" for n, e in sorted(g["pbias"].items()))
            + f"; over the {g['n_big']} of {g['n_ids']} ids whose accumulator is >= "
            f"{ACCUM_FLOOR:g} of the largest: accumulator {g['accum']:.3g} (att, rep halves "
            f"{g['accum_halves'][0]:.3g}, {g['accum_halves'][1]:.3g}; all {g['n_ids']} ids "
            f"{g['accum_all']:.3g}), row update {g['delta']:.3g} (largest accumulator "
            f"{g['acc_max']:.3g}, largest |update| {g['delta_max']:.3g})")
    failed = [k for k in ("select", "same_order") if not got[k] >= bands[k]]
    for pair in ("vs_cpu", "vs_plain"):
        for k, band in bands[pair].items():
            got[f"{pair} {k}"] = found[pair][k]
            if not found[pair][k] <= band:
                failed.append(f"{pair} {k}")
    log(f"[check] one amp={amp} train step on {CHECK_ROWS} rows: selected ids shared "
        f"{got['select']:.4%} (band {bands['select']}), rows with the same ordered selection "
        f"{got['same_order']:.4%} (band {bands['same_order']}); held: "
        + "; ".join(f"{pair} " + ", ".join(f"{k} {found[pair][k]:.3g} (band {b})"
                                           for k, b in bands[pair].items())
                    for pair in ("vs_cpu", "vs_plain")))
    if failed:
        raise AssertionError(f"the card's {amp} train step disagrees: {failed}")
    return got


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
        expected = {k: (0 if k.endswith("_bwd") or k.startswith("fm_cross") else want)
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
            train_reference_check(flagship_config_dict(), train_cache, dev, amp)
        del train_cache
        torch.cuda.empty_cache()
        t0 = time.time()
        fold_launches, fold_served = fold_phase(tmp, man, dev)
        fold_wall = time.time() - t0

    for name, r in kernels.items():
        # each kernel's launches on the path that is its own: the encoder
        # kernels' in the training phase, the FM pair's in the fold phase
        fm = name.startswith("fm_cross")
        r["launches"] = fold_launches[name] if fm else train_launches[name]
        r["launches_serving"] = fold_served[name] if fm else counts[name]
        r["launches_fold"] = fold_launches[name]
    total = time.time() - T_START
    log(f"[time] the whole script {total:.1f} s, the fold phase {fold_wall:.1f} s of it "
        f"({total - fold_wall:.1f} s without)")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
