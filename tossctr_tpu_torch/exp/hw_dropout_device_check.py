"""Card check of the dropout masks the eight dropping encoder kernels draw.

Port of the JAX package's TPU check ``exp/hw_dropout_device_check.py``.
There, the hardware-PRNG mask cannot be rebuilt in numpy, so a sibling
kernel dumps it at the fused kernels' coordinates and a masked oracle
rebuilds their outputs from the dump.  The card has no hardware mask:
``dropout_impl: hw`` runs the counter hash (``ops/dropout.py``), and the
dump kernel (``csrc/dropout_dump.cu``) writes it with the same 32-bit
hash the kernels compute (``common.cuh``'s constants and ``fmix32``).
At each geometry the check then holds:

1. the dumps bit-equal to the plain masks (``attention_keep``,
   ``ffn_keep``);
2. all eight dropping kernels, the forwards and backwards of
   ``fused_mha_qkv``, ``fused_mha``, ``fused_block_tail`` and
   ``fused_ffn``, in fp32, against a float64 oracle that drops with the
   dumped mask: each output and the gradient of every input (autograd of
   the oracle, with one random cotangent).  Bands, relative to the
   largest magnitude of each: 1e-5 for the outputs and the gradients of
   the activations, which a single element dropped otherwise would move
   by orders more; 1e-4 for the weight gradients, fp32 sums over up to
   5e5 rows in another order than the oracle's;
3. the keep rate of each mask within ``rate_band`` of 1 - p;
4. independence: across two consecutive seeds, neighbouring heads,
   neighbouring batch rows (attention), and neighbouring rows and columns
   (FFN), the share of equal keep decisions within ``rate_band`` of
   p^2 + (1-p)^2 (the hash is linear in its coordinates before
   ``fmix32``);
5. grid invariance, in bf16 as the model runs them: the six persistent
   kernels (the attention forwards and the four backwards) with their
   default grid against a grid of GRID_BLOCKS blocks: outputs and the
   gradients of the activations bit-equal, the weight gradients (whose
   per-block partials regroup) within 1e-4 of the largest magnitude.  The
   FFN and block-tail forwards launch one block a row tile, a grid that
   the rows fix.

Geometries: the JAX check's (B = 64, K = 12, D = 16, H = 8, p = 0.3; the
FFN at N = 128 rows, F = 256; rate band 0.02 as there), the flagship's
(B = 8192, K = 64, D = 64, H = 8, F = 384, its configured p; N = B * K;
rate band 1e-3) and K = 120 (``v3_k120_s1_tpu``: the forwards query-tiled,
``fused_mha_qkv_bwd`` key-tiled).

    python -m tossctr_tpu_torch.exp.hw_dropout_device_check
"""

from __future__ import annotations

import importlib
import json
import sys
import time

import torch

from ..config import Config
from ..config.flagship import flagship_config_dict, v3_k120_config_dict
from ..ops.dropout import attention_keep, dump_attention_keep, dump_ffn_keep, ffn_keep
from ._timing import log

fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
ff = importlib.import_module("tossctr_tpu_torch.ops.fused_ffn")

SEED = 1234
GRID_BLOCKS = 7  # the few-block grid of the invariance check
ACT_BAND = 1e-5  # fp32 outputs and activation gradients against float64
WGRAD_BAND = 1e-4  # fp32 weight gradients (sums over the rows) against float64
GRID_WGRAD_BAND = 1e-4  # bf16 kernels' fp32 weight-gradient sums, two grids
ORACLE_ROWS = 1 << 16  # rows of a float64 oracle chunk (attention: / K)


def _geometry(d: dict) -> dict:
    """A config's encoder geometry at its batch: K padded to a multiple of
    8 (the last columns masked), N = B * K FFN rows."""
    cfg = Config.from_dict(d)
    tfm = cfg.sequence.tfm
    B, K = cfg.train.batch_size, -(-cfg.sequence.top_k // 8) * 8
    return dict(B=B, K=K, D=cfg.model.emb_dim, H=tfm.n_heads, F=tfm.ffn_hidden,
                p_attn=tfm.mha_dropout, p_ffn=tfm.ffn_dropout, N=B * K,
                valid_k=cfg.sequence.top_k, rate_band=1e-3)


def geometries() -> dict:
    probe = dict(B=64, K=12, D=16, H=8, F=256, p_attn=0.3, p_ffn=0.3, N=128, valid_k=12,
                 rate_band=0.02)
    return {"probe": probe, "flagship": _geometry(flagship_config_dict()),
            "k120": _geometry(v3_k120_config_dict())}


# ---- float64 oracles that drop with a given mask ----


def _attend(q, k, v, bias, H, keep):
    B, K, D = q.shape
    dh = D // H

    def heads(t):
        return t.reshape(B, K, H, dh).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2) * fa.attention_scale(dh) + bias
    p = torch.softmax(s, dim=-1) * keep
    return (p @ heads(v)).transpose(1, 2).reshape(B, K, D)


def mha_qkv_oracle(rows, shared, keep, H):
    (x,), (wqkv, bqkv, bias) = rows, shared
    q, k, v = (x @ wqkv + bqkv).split(x.shape[-1], dim=-1)
    return _attend(q, k, v, bias, H, keep)


def mha_oracle(rows, shared, keep, H):
    (q, k, v), (bias,) = rows, shared
    return _attend(q, k, v, bias, H, keep)


def _rms(r, w):
    return w * r * torch.rsqrt((r * r).mean(dim=-1, keepdim=True) + ff.RMS_EPS)


def _ffn(x, w1, b1, w2, b2, keep):
    return (ff.gelu_tanh(x @ w1 + b1) * keep) @ w2 + b2


def block_tail_oracle(rows, shared, keep, H=None):
    (x, o), (wout, bout, wn1, w1, b1, w2, b2, wn2) = rows, shared
    y1 = _rms(x + o @ wout + bout, wn1)
    return _rms(y1 + _ffn(y1, w1, b1, w2, b2, keep), wn2)


def ffn_oracle(rows, shared, keep, H=None):
    (x,), (w1, b1, w2, b2) = rows, shared
    return _ffn(x, w1, b1, w2, b2, keep)


def oracle_vjp(fn, rows, shared, keep, cot, chunk, H=None):
    """fn's output and the gradients of <output, cot> w.r.t. every row and
    shared input, in float64, over chunks of ``chunk`` rows (rows and the
    mask split along dim 0; the shared inputs' gradients summed over the
    chunks).  -> (out, [row grads], [shared grads])."""
    shared = [t.double().requires_grad_() for t in shared]
    outs, row_grads, shared_grads = [], [[] for _ in rows], [0.0] * len(shared)
    for a in range(0, rows[0].shape[0], chunk):
        r = [t[a:a + chunk].double().requires_grad_() for t in rows]
        out = fn(r, shared, keep[a:a + chunk].double(), H)
        grads = torch.autograd.grad(out, r + shared, cot[a:a + chunk].double())
        outs.append(out.detach())
        for i in range(len(r)):
            row_grads[i].append(grads[i])
        for i, g in enumerate(grads[len(r):]):
            shared_grads[i] = shared_grads[i] + g
    return torch.cat(outs), [torch.cat(g) for g in row_grads], shared_grads


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


# ---- inputs ----


def _rnd(g, dev, *shape, std=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)


def attention_inputs(geo, g, dev):
    B, K, D = geo["B"], geo["K"], geo["D"]
    bias = _rnd(g, dev, K, K, std=0.5)
    bias[:, geo["valid_k"]:] = -1e9
    return dict(x=_rnd(g, dev, B, K, D), wqkv=_rnd(g, dev, D, 3 * D, std=D ** -0.5),
                bqkv=_rnd(g, dev, 3 * D, std=0.1), bias=bias, q=_rnd(g, dev, B, K, D),
                k=_rnd(g, dev, B, K, D), v=_rnd(g, dev, B, K, D), do=_rnd(g, dev, B, K, D))


def ffn_inputs(geo, g, dev):
    N, D, F = geo["N"], geo["D"], geo["F"]
    return dict(x=_rnd(g, dev, N, D), o=_rnd(g, dev, N, D),
                wout=_rnd(g, dev, D, D, std=D ** -0.5), bout=_rnd(g, dev, D, std=0.1),
                wn1=1 + _rnd(g, dev, D, std=0.1), w1=_rnd(g, dev, D, F, std=D ** -0.5),
                b1=_rnd(g, dev, F, std=0.1), w2=_rnd(g, dev, F, D, std=F ** -0.5),
                b2=_rnd(g, dev, D, std=0.1), wn2=1 + _rnd(g, dev, D, std=0.1),
                dy=_rnd(g, dev, N, D))


def _bf16(t, keep_fp32=()):
    return {k: (v if k in keep_fp32 else v.to(torch.bfloat16)) for k, v in t.items()}


# ---- the checks ----


def kernel_cases(geo, a, f):
    """(name, forward, backward, oracle, row inputs, shared inputs, mask,
    cotangent) for the eight kernels, by the names of ``a`` (attention
    inputs) and ``f`` (FFN inputs); the backward returns the gradients of
    the row inputs, then of the shared ones.  Each forward and backward
    takes ``blocks`` where its grid is persistent."""
    H, pa, pf = geo["H"], geo["p_attn"], geo["p_ffn"]
    tail = ("x", "o", "wout", "bout", "wn1", "w1", "b1", "w2", "b2", "wn2")
    return (
        ("fused_mha_qkv",
         lambda t, blocks=None: fa.fused_mha_qkv_fwd(t["x"], t["wqkv"], t["bqkv"], t["bias"], H,
                                                     pa, SEED, blocks=blocks),
         lambda t, blocks=None: fa.fused_mha_qkv_bwd(t["x"], t["wqkv"], t["bqkv"], t["bias"],
                                                     t["do"], H, pa, SEED, blocks=blocks),
         mha_qkv_oracle, ("x",), ("wqkv", "bqkv", "bias"), "attn", "do"),
        ("fused_mha",
         lambda t, blocks=None: fa.fused_mha_fwd(t["q"], t["k"], t["v"], t["bias"], H, pa, SEED,
                                                 blocks=blocks),
         lambda t, blocks=None: fa.fused_mha_bwd(t["q"], t["k"], t["v"], t["bias"], t["do"], H,
                                                 pa, SEED, blocks=blocks),
         mha_oracle, ("q", "k", "v"), ("bias",), "attn", "do"),
        ("fused_block_tail",
         lambda t, blocks=None: ff.fused_block_tail_fwd(*(t[n] for n in tail), pf, SEED),
         lambda t, blocks=None: ff.fused_block_tail_bwd(*(t[n] for n in tail), t["dy"], pf,
                                                        SEED, blocks=blocks),
         block_tail_oracle, ("x", "o"), tail[2:], "ffn", "dy"),
        ("fused_ffn",
         lambda t, blocks=None: ff.fused_ffn_fwd(t["x"], t["w1"], t["b1"], t["w2"], t["b2"], pf,
                                                 SEED),
         lambda t, blocks=None: ff.fused_ffn_bwd(t["x"], t["w1"], t["b1"], t["w2"], t["dy"], pf,
                                                 SEED, blocks=blocks),
         ffn_oracle, ("x",), ("w1", "b1", "w2", "b2"), "ffn", "dy"),
    )


def masks_and_rates(geo, dev) -> tuple:
    """Dump both masks (and at the next seed), hold them to the plain
    masks, and measure the keep rates and the independence shares.  ->
    (attention mask, FFN mask, report)."""
    B, K, H, N, F = geo["B"], geo["K"], geo["H"], geo["N"], geo["F"]
    pa, pf, band = geo["p_attn"], geo["p_ffn"], geo["rate_band"]
    rep = {}
    keep_a = dump_attention_keep(B, K, H, pa, SEED, dev)
    keep_f = dump_ffn_keep(N, F, pf, SEED, dev)
    rep["attention_dump_equal"] = torch.equal(keep_a, attention_keep(B, K, H, pa, SEED,
                                                                     device=dev))
    rep["ffn_dump_equal"] = torch.equal(keep_f, ffn_keep(N, F, pf, SEED, device=dev))
    if not (rep["attention_dump_equal"] and rep["ffn_dump_equal"]):
        raise AssertionError(f"a dumped mask differs from its plain version: {rep}")
    ka, kf = keep_a != 0, keep_f != 0
    next_a = dump_attention_keep(B, K, H, pa, SEED + 1, dev) != 0
    next_f = dump_ffn_keep(N, F, pf, SEED + 1, dev) != 0

    def same(u, w):
        return float((u == w).double().mean())

    rates = {"attention": (float(ka.double().mean()), 1 - pa),
             "ffn": (float(kf.double().mean()), 1 - pf)}
    pairs = {"attention seeds": (same(ka, next_a), pa),
             "attention heads": (same(ka[:, :-1], ka[:, 1:]), pa),
             "attention rows": (same(ka[:-1], ka[1:]), pa),
             "ffn seeds": (same(kf, next_f), pf),
             "ffn rows": (same(kf[:-1], kf[1:]), pf),
             "ffn columns": (same(kf[:, :-1], kf[:, 1:]), pf)}
    del next_a, next_f
    rep["keep_rate"] = {k: dict(got=v, want=w, band=band) for k, (v, w) in rates.items()}
    rep["same_decisions"] = {k: dict(got=v, want=p * p + (1 - p) ** 2, band=band)
                             for k, (v, p) in pairs.items()}
    bad = [k for group in ("keep_rate", "same_decisions") for k, r in rep[group].items()
           if not abs(r["got"] - r["want"]) <= r["band"]]
    log(f"[dropout check] masks: dumps bit-equal to the plain masks; keep rate "
        + ", ".join(f"{k} {r['got']:.6f} (1-p {r['want']:.6f})"
                    for k, r in rep["keep_rate"].items())
        + "; equal decisions " + ", ".join(f"{k} {r['got']:.6f}"
                                           for k, r in rep["same_decisions"].items())
        + f" (p^2+(1-p)^2 {pa * pa + (1 - pa) ** 2:.6f} attention, "
        f"{pf * pf + (1 - pf) ** 2:.6f} FFN); band {band}")
    if bad:
        raise AssertionError(f"keep rate or independence outside {band}: {bad}")
    return keep_a, keep_f, rep


def kernels_against_oracle(geo, a, f, keep_a, keep_f) -> dict:
    """Each kernel in fp32 against the float64 oracle on the dumped mask:
    -> {kernel: {output or gradient: relative error}}."""
    out = {}
    for name, fwd, bwd, oracle, rows, shared, kind, cot in kernel_cases(geo, a, f):
        t = a if kind == "attn" else f
        keep = keep_a if kind == "attn" else keep_f
        chunk = ORACLE_ROWS // geo["K"] if kind == "attn" else ORACLE_ROWS
        want, want_rows, want_shared = oracle_vjp(
            oracle, [t[n] for n in rows], [t[n] for n in shared], keep, t[cot], chunk,
            geo["H"])
        errs = {"out": rel_err(fwd(t), want)}
        for n, g, w in zip(rows + shared, bwd(t), want_rows + want_shared):
            errs[f"d{n}"] = rel_err(g, w)
        bad = [k for k, e in errs.items()
               if not e <= (WGRAD_BAND if k[1:] in shared else ACT_BAND)]
        log(f"[dropout check] {name} fp32 against the float64 oracle on the dumped mask: "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (relative to the largest; bands {ACT_BAND} outputs and activation gradients, "
            f"{WGRAD_BAND} weight gradients)")
        if bad:
            raise AssertionError(f"{name} disagrees with the masked oracle: {bad}")
        out[name] = errs
        del want, want_rows, want_shared
        torch.cuda.empty_cache()
    return out


def grid_invariance(geo, a, f) -> dict:
    """The persistent kernels in bf16 with their default grid against
    GRID_BLOCKS blocks.  -> {kernel: {"bit_equal": [...], "wgrad": err}}."""
    fp32 = ("bqkv", "bout", "wn1", "b1", "b2", "wn2")
    a16, f16 = _bf16(a, fp32), _bf16(f, fp32)
    out = {}
    for name, fwd, bwd, _, rows, shared, kind, _ in kernel_cases(geo, a16, f16):
        t = a16 if kind == "attn" else f16
        res = {"bit_equal": [], "wgrad": 0.0}
        if kind == "attn":  # the attention forwards' grids are persistent
            if not torch.equal(fwd(t), fwd(t, blocks=GRID_BLOCKS)):
                raise AssertionError(f"{name}: the forward depends on its grid")
            res["bit_equal"].append("out")
        for n, u, w in zip(rows + shared, bwd(t), bwd(t, blocks=GRID_BLOCKS)):
            if n in rows:
                if not torch.equal(u, w):
                    raise AssertionError(f"{name}: d{n} depends on the grid")
                res["bit_equal"].append(f"d{n}")
            else:
                res["wgrad"] = max(res["wgrad"], rel_err(w, u))
        log(f"[dropout check] {name} bf16, default grid against {GRID_BLOCKS} blocks: "
            f"{', '.join(res['bit_equal'])} bit-equal; weight gradients within "
            f"{res['wgrad']:.3g} of the largest (band {GRID_WGRAD_BAND})")
        if not res["wgrad"] <= GRID_WGRAD_BAND:
            raise AssertionError(f"{name}: weight gradients move with the grid")
        out[name] = res
        torch.cuda.empty_cache()
    return out


def run_geometry(tag: str, dev) -> dict:
    """Every check at the geometry ``geometries()[tag]`` -> its report."""
    geo = geometries()[tag]
    t0 = time.time()
    log(f"[dropout check] {tag}: " + ", ".join(f"{k}={v}" for k, v in geo.items()))
    g = torch.Generator(device=dev).manual_seed(5)
    a, f = attention_inputs(geo, g, dev), ffn_inputs(geo, g, dev)
    keep_a, keep_f, rep = masks_and_rates(geo, dev)
    rep["oracle"] = kernels_against_oracle(geo, a, f, keep_a, keep_f)
    del keep_a, keep_f
    torch.cuda.empty_cache()
    rep["grid"] = grid_invariance(geo, a, f)
    rep["geometry"], rep["seconds"] = dict(geo), time.time() - t0
    log(f"[dropout check] {tag}: every check held ({rep['seconds']:.1f} s)")
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("hw_dropout_device_check: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[dropout check] device {torch.cuda.get_device_name(0)}")
    reports = {tag: run_geometry(tag, dev) for tag in geometries()}
    log(json.dumps({"dropout_check": reports}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
