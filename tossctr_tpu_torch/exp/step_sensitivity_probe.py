"""Card diagnostic: how far the bf16 train step moves when the encoder's
attention forward rounds one of its fp32 sums otherwise, and where.

``chip_smoke.py``'s one-step check holds the card's bf16 step against the
same step with the kernels' plain versions on the card (``vs_plain``).
On its batch and parameters (the rows with a history, every kernel's
plain version on the card) this runs, each against the plain step:

  kernels   the step as built (``fused_mha_qkv``'s forward on its
            FFMA-chain kernel, bit-equal to its plain version);
  mma       the step as built with ``fused_mha_qkv``'s forward on the
            tensor cores: its kernel built with the backward's projection
            (``project_qkv_mma``) and ``fused_mha``'s forward unit
            (``query_tile_fwd``) in place of the FFMA chains;
  proj, scores, p, pv
            the plain versions, ``fused_mha_qkv``'s forward with one
            stage's fp32 result multiplied by 1 +- 2^-23 (a random sign an
            element: about one rounding, what a sum taken in another order
            gives) before that stage rounds or goes on: q, k, v = x Wqkv +
            b before the rounding to bf16; q_h k_h^T before the scale and
            the bias; the probabilities times the keep mask before the
            rounding; P v_h before the rounding of the output.  A factor 1
            +- 2^-26 leaves fp32 values unchanged and is the control.

For each it reports the step against the plain one as ``chip_smoke.py``
does (gradients, worst tensor, accumulator, row update) beside the
``vs_plain`` bands, then where the gradients' distance lies:

* the leaves (dense gradient tensors) with the largest share of the
  squared distance, each with its relative change and its share of the
  plain gradients' squared norm, the qkv kernels and biases split into
  their q, k and v thirds (the k third of a qkv bias has a gradient of 0
  in exact arithmetic: softmax does not move when every score of a
  query's row moves by the same amount, so its plain gradient is rounding
  noise);
* the distance without the k thirds of the qkv biases (a diagnostic, not
  the check);
* the ReLU inputs that take another sign than in the plain step's
  forward, by ReLU call (an input within rounding of 0 sends a row's
  gradient down another path wholesale: ``chip_smoke.same_relu_rows``),
  and the step against the plain step with every ReLU of both pinned to
  the plain step's signs (``pinned_relus``): what is left of the
  distance once no ReLU input changes sides.

Run it from the root of a checkout, on a card:

    python -m tossctr_tpu_torch.exp.step_sensitivity_probe

With ``--fixed-check`` it runs only ``chip_smoke.py``'s fixed bf16 check
(``PinnedPlain``: the ReLUs pinned, the bands of None derived from the
perturbation witness) on the step as built and on the step with the
tensor-core qkv forward, and exits non-zero unless both pass.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import os
import subprocess
import sys
import tempfile

import torch

from ..config import Config
from ..config.flagship import flagship_config_dict
from ..data import BatchIterator, ShardCache
from ..data.synth import write_synth_cache_for
from ..models import init_params
from ..ops import _build
from ..ops.dropout import attention_keep
from ..train.trainer import build_model
from ._timing import log

STAGES = (("proj", 2.0 ** -23), ("scores", 2.0 ** -23), ("p", 2.0 ** -23), ("pv", 2.0 ** -23),
          ("proj", 2.0 ** -26), ("pv", 2.0 ** -26))
QKV = "fused_mha_qkv"
# fused_mha_qkv's forward on the tensor cores: the FFMA-chain projection and
# unit swapped for the mma ones
MMA_SUBS = [
    (f"{QKV}.cu", "project_qkv_chain(xb, LX, w_s, L.LW, b_s, qs, qs + slab, qs + 2 * slab, geo);",
     "project_qkv_mma<kWarpsF>(xb, LX, w_s, L.LW, b_s, qs, qs + slab, qs + 2 * slab, geo, L.DP);"),
    (f"{QKV}.cu", "query_tile_fwd_chain<KP, DHP>(", "query_tile_fwd<KP, DHP>("),
]
TOP_LEAVES = 8


def perturbed_forward(fa, stage, rel, gen):
    """``fused_mha_qkv_reference`` with ``stage``'s fp32 result times 1 +-
    ``rel``."""

    def jitter(t, on):
        if not on:
            return t
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device).float() * 2 - 1
        return t * (1 + sign * rel)

    def forward(x, wqkv, bqkv, bias, n_heads, dropout_p=0.0, seed=0, **_):
        B, K, D = x.shape
        qkv = jitter(x.float() @ wqkv.float() + bqkv.float(), stage == "proj").to(x.dtype)
        q, k, v = (fa._heads(t, n_heads) for t in qkv.split(D, dim=-1))
        s = jitter(q @ k.transpose(-1, -2), stage == "scores") * fa.attention_scale(D // n_heads)
        s = s + bias.float()
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        if dropout_p > 0.0:
            p = p * attention_keep(B, K, n_heads, dropout_p, seed, device=x.device)
        o = jitter(jitter(p, stage == "p").to(x.dtype).float() @ v, stage == "pv")
        return fa._merge(o).to(x.dtype)

    return forward


def mma_library():
    """``fused_mha_qkv``'s library with its bf16 forward on the tensor
    cores (``MMA_SUBS``), its entry points typed as ``load_library``'s."""
    tag = "probe_step_qkv_mma"
    _build.build_variant(QKV, MMA_SUBS, tag)
    lib = ctypes.CDLL(str(_build.BUILD_DIR / tag / f"{QKV}.so"))
    lib.tossctr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tossctr_cuda_error_string.restype = ctypes.c_char_p
    fn_name, argtypes = _build.SIGNATURES[QKV]
    getattr(lib, fn_name).argtypes = argtypes
    getattr(lib, fn_name).restype = ctypes.c_int
    for fn, r in sorted(_build.parse_ptxas((_build.BUILD_DIR / tag / f"{QKV}.ptxas.txt")
                                           .read_text()).items()):
        if "fwd_chain" in fn:
            log(f"mma variant {fn} (its units on mma): {r['registers']} registers, spill "
                f"stores {r['spill_stores']} / loads {r['spill_loads']} bytes")
    return lib


@contextlib.contextmanager
def library(lib):
    """``load_library(QKV)`` answers ``lib`` inside."""
    _build.load_library(QKV)
    saved = _build._libs[QKV]
    _build._libs[QKV] = lib
    try:
        yield
    finally:
        _build._libs[QKV] = saved


@contextlib.contextmanager
def perturbed(cs, fa, stage, rel, dev):
    """The plain versions, ``fused_mha_qkv``'s forward perturbed at
    ``stage``; the same signs on every entry."""
    gen = torch.Generator(device=dev).manual_seed(5)
    with cs.plain_versions_on_card():
        fa.fused_mha_qkv_fwd = perturbed_forward(fa, stage, rel, gen)
        yield


def parts(name, g):
    """A gradient tensor as named parts: the qkv kernels and biases in their
    q, k and v thirds (the last dimension), every other tensor whole."""
    if ".qkv." in name and g.shape[-1] % 3 == 0:
        return [(f"{name}[{w}]", t) for w, t in zip("qkv", g.split(g.shape[-1] // 3, dim=-1))]
    return [(name, g)]


def leaf_table(c, r):
    """-> [(part, relative change, share of the squared distance, share of
    the plain gradients' squared norm)] over every part, largest share
    first; and the distance without the k thirds of the qkv biases."""
    rows, num, den, num_k, den_k = [], 0.0, 0.0, 0.0, 0.0
    for n, g in r["grads"].items():
        for (pn, a), (_, b) in zip(parts(n, c["grads"][n]), parts(n, g)):
            d2, n2 = float((a - b).square().sum()), float(b.square().sum())
            rows.append((pn, (d2 / n2) ** 0.5 if n2 > 0 else d2 ** 0.5, d2, n2))
            num, den = num + d2, den + n2
            if pn.endswith("qkv.bias[k]"):
                num_k, den_k = num_k + d2, den_k + n2
    rows = [(pn, rel, d2 / num if num > 0 else 0.0, n2 / den) for pn, rel, d2, n2 in rows]
    rows.sort(key=lambda x: -x[2])
    return rows, ((num - num_k) / (den - den_k)) ** 0.5


def relu_flips(cs, model, init, batch, dev, ctx, ref_ctx):
    """The ReLU inputs of the first step's forward on ``batch`` (a dict of
    numpy arrays) whose sign under ``ctx`` is not the one under
    ``ref_ctx``.  -> (the rows with such an input, as a bool tensor; one
    line per ReLU call with flips: its input's shape, the inputs and rows
    flipped).  A batch-level input flipped flags no row."""
    n = len(next(iter(batch.values())))
    signs = []
    for c in (ctx, ref_ctx):
        model.load_state_dict(init)
        with c():
            signs.append(cs.relu_signs(model, batch, dev))
    rows, lines = torch.zeros(n, dtype=torch.bool), []
    for i, (a, b) in enumerate(zip(*signs)):
        diff = a != b
        if not bool(diff.any()):
            continue
        if a.shape[0] == n:
            per_row = diff.reshape(n, -1).any(dim=1)
            rows |= per_row
            lines.append(f"ReLU {i} {tuple(a.shape)}: {int(diff.sum())} inputs in "
                         f"{int(per_row.sum())} rows")
        else:
            lines.append(f"ReLU {i} {tuple(a.shape)} (batch-level): {int(diff.sum())} inputs")
    return rows, lines


def fixed_check(cs, cfg, model, init, part, dev, ids, mma_lib):
    """The fixed bf16 check (``chip_smoke.PinnedPlain``: every ReLU pinned
    to the plain step's signs, the bands of None derived from the
    perturbation witness) on the step as built and on the step with
    ``fused_mha_qkv``'s forward on the tensor cores: -> whether both pass."""
    pin = cs.PinnedPlain(cfg, model, init, part, dev, ids)
    bands, wit = pin.witness(cs.CHECK_BANDS["bf16"]["vs_plain"])
    for k, w in wit.items():
        log(f"witness {k}: " + ", ".join(f"{m} {w[m]:.4g}" for m in bands))
    ok = True
    for label, ctx in (("as built", contextlib.nullcontext),
                       ("qkv forward on the tensor cores", lambda: library(mma_lib))):
        g = pin.compare(ctx)
        off = [m for m, b in bands.items() if not g[m] <= b]
        ok &= not off
        log(f"fixed check, {label} ({pin.flips(ctx)} ReLU inputs of another sign unpinned): "
            + ", ".join(f"{m} {g[m]:.4g} (band {b:.4g})" for m, b in bands.items())
            + f"; {'FAILS ' + ', '.join(off) if off else 'passes'}")
    return ok


def main(argv=None) -> int:
    fixed_only = "--fixed-check" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("step_sensitivity_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the one-step check's records, comparison and bands

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    mma_lib = mma_library()
    g = torch.Generator(device=dev).manual_seed(3)  # the variant against the plain version
    B, K, D, H = 512, 64, 64, 8
    x = torch.randn(B, K, D, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(D, 3 * D, generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
    b = torch.randn(3 * D, generator=g, device=dev) * 0.1
    bias = (torch.randn(K, K, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    want = fa.fused_mha_qkv_reference(x, w, b, bias, H, 0.1, 7)
    for label, ctx in (("as built", contextlib.nullcontext), ("mma", lambda: library(mma_lib))):
        with ctx():
            got = fa.fused_mha_qkv_fwd(x, w, b, bias, H, 0.1, 7)
        err = float((got.float() - want.float()).abs().max())
        log(f"fused_mha_qkv fwd {label} at (B, K, D, H) = {(B, K, D, H)}, p = 0.1: "
            f"{float((got != want).double().mean()):.4%} of the outputs differ from the plain "
            f"version's, max |err| {err:.4g} (band {cs.bf16_tolerance(want):.4g})")
    base = Config.from_dict(flagship_config_dict())
    d = cs.no_kernel_dropouts(flagship_config_dict())
    d["amp"], d["model"]["table_dtype"] = "bf16", "float32"
    cfg = Config.from_dict(d)
    bands = cs.CHECK_BANDS["bf16"]["vs_plain"]
    plain = cs.plain_versions_on_card
    sides = [("kernels", contextlib.nullcontext),
             ("kernels, qkv forward on the tensor cores", lambda: library(mma_lib))]
    sides += [(f"plain, {stage} times 1 +- 2^{round(torch.tensor(rel).log2().item())}",
               lambda stage=stage, rel=rel: perturbed(cs, fa, stage, rel, dev))
              for stage, rel in STAGES]
    with tempfile.TemporaryDirectory() as tmp:  # chip_smoke.py's train cache
        cache = ShardCache(write_synth_cache_for(
            base, os.path.join(tmp, "train"), cs.TRAIN_BATCHES * base.train.batch_size,
            num_dim=cs.N_NUM, seed=11))
        batch = next(iter(BatchIterator(cache, batch_size=cs.CHECK_ROWS, train=True)))
        model = init_params(build_model(cfg, cache.dims, dev), seed=77)
        init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        sel = cs.selected_ids(model, cs.to_device(batch, dev)).cpu()
        rows = (sel != cfg.sequence.pad_id).any(dim=1)
        part = {k: v[rows.numpy()] for k, v in batch.items()}
        sel = sel[rows]

        ids = torch.unique(sel)
        ids = ids[ids != cfg.sequence.pad_id]
        if fixed_only:
            return 0 if fixed_check(cs, cfg, model, init, part, dev, ids, mma_lib) else 1

        def record(ctx, sub):
            with ctx():
                return cs._step_record(cfg, model, init, sub, dev, ids)

        def report(label, rec, ref):
            g = cs._compare_steps(rec, ref)
            log(f"{label}: " + ", ".join(f"{k} {g[k]:.4g} (band {b})" for k, b in bands.items()))
            return g

        ref = record(plain, part)
        for label, ctx in sides:
            rec = record(ctx, part)
            g = report(f"{label} ({int(rows.sum())} rows)", rec, ref)
            table, without_k = leaf_table(rec, ref)
            log(f"{label}: leaves by share of the gradients' squared distance (relative change, "
                f"share of the distance, share of the plain gradients' squared norm): "
                + "; ".join(f"{pn} {rel:.3g}, {sd:.2%}, {sn:.3%}"
                            for pn, rel, sd, sn in table[:TOP_LEAVES]))
            log(f"{label}: the qkv thirds: " + "; ".join(
                f"{pn} {rel:.3g}, {sd:.2%}, {sn:.3%}" for pn, rel, sd, sn in
                sorted((t for t in table if ".qkv." in t[0]), key=lambda t: t[0])))
            log(f"{label}: gradients without the k thirds of the qkv biases {without_k:.4g} "
                f"(with them {g['grads']:.4g})")
            flipped, lines = relu_flips(cs, model, init, part, dev, ctx, plain)
            log(f"{label}: ReLU inputs of another sign than in the plain step: "
                + ("; ".join(lines) if lines else "none"))
            if not lines:
                continue
            model.load_state_dict(init)
            with plain():  # the plain step's ReLU masks, pinned on both sides
                signs = cs.relu_signs(model, part, dev)

            @contextlib.contextmanager
            def pinned(c):
                with c(), cs.pinned_relus(signs):
                    yield

            report(f"{label}: every ReLU pinned to the plain step's signs, on both sides "
                   f"({int(flipped.sum())} rows had an input of another sign)",
                   record(lambda: pinned(ctx), part), record(lambda: pinned(plain), part))
    return 0


if __name__ == "__main__":
    sys.exit(main())
