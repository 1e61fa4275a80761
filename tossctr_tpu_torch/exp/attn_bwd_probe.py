"""Card probe: where the bf16 attention backwards' time goes.

At the flagship's shapes (B = 8192, K = 64, D = 64, H = 8, bf16), at the
K = 120 config's (``--k 120``: the wider form, K padded to 128) or at the
K = 148 config's (``--k 152``: B = 4096, K padded to 160: 10 warps,
dbias in device memory, each unit's bias rows staged), it times, with
CUDA events, on one card and in turns (as built, variants, variants, as
built; twice):

  A. ``fused_mha_qkv_bwd`` and ``fused_mha_bwd`` as built, with dropout
     (p = 0.1) and without: the gap is the keep hash's cost with the
     products by the mask;
  B. each built with ``__fdiv_rn`` in place of the softmax's ``div_rn``
     (mha_mma.cuh): every output must be bit-equal to A's, so the two
     divisions agree on every probability of the call (268M at K = 64),
     and the gap is what ``__fdiv_rn`` would cost;
  C. ``fused_mha_bwd`` without its key-tile units (dk and dv wrong, timed
     only; dq and dbias held bit-equal to A's): the gap is what the dk, dv
     products over the P and dS buffers cost;
  D. ``fused_mha_qkv_bwd`` without the attention core (timed only): what
     the projection, dWqkv, dx and the staging cost;
  E. ``fused_mha_qkv_bwd`` without the dWqkv and dx products (timed only;
     dbias held bit-equal to A's);
  F. at ``--k 152`` both kernels with the unit reading its bias straight
     from device memory in the softmax (the form before the staging:
     every output bit-equal to A's), without the dbias atomics (dbias
     wrong, timed only; the rest held bit-equal), and without the bias
     rows' copy (timed only);

beside the autograd backwards of the PyTorch yardsticks
``chip_smoke.py`` times.  The last line is a JSON object of the times.

    python -m tossctr_tpu_torch.exp.attn_bwd_probe [--k 120 | --k 152]

The variants build in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.dropout import kernel_args
from ._timing import cuda_time_ms, log

D, H = 64, 8
BATCH = {64: 8192, 120: 8192, 152: 4096}  # K -> B: the flagship's and the configs'
MASKED = 4  # the last key columns masked: the configs' top_k padded to a multiple of 8
P_DROP = 0.1
SEED = 1234567
QKV, MHA = "fused_mha_qkv_bwd", "fused_mha_bwd"
FDIV = ("mha_mma.cuh",
        "p[j][i] = i < 2 ? div_rn(p[j][i], l0, rl0) : div_rn(p[j][i], l1, rl1);",
        "p[j][i] = __fdiv_rn(p[j][i], i < 2 ? l0 : l1);")
# variant: (library, [(file, source, replacement)], outputs held bit-equal
# to the kernel's as built: indices into (dx, dwqkv, dbqkv, dbias) or (dq,
# dk, dv, dbias))
VARIANTS = {
    "qkv_fdiv": (QKV, [FDIV], (0, 1, 2, 3)),
    "mha_fdiv": (MHA, [FDIV], (0, 1, 2, 3)),
    "mha_no_key_tiles": (MHA, [("mha_mma.cuh", "    if (on)\n      key_tile_grads<KP, DHP>(",
                                "    if (false)\n      key_tile_grads<KP, DHP>(")], (0, 3)),
    "qkv_no_core": (QKV, [("mha_mma.cuh",
                           "for (int grp = half; grp < gr.n; grp += halves)",
                           "for (int grp = half; grp < 0; grp += halves)")], ()),
    "qkv_no_wgrad_dx": (QKV, [(f"{QKV}.cu",
                               "for (int u = warp; u < mt * npairs; u += kWarpsF) {",
                               "for (int u = warp; u < 0; u += kWarpsF) {"),
                              (f"{QKV}.cu", "for (int u = warp; u < QT * mt; u += kWarpsF)",
                               "for (int u = warp; u < 0; u += kWarpsF)")], (3,)),
}
# the KP = 160 form's parts (K > 128)
BIAS_GLOBAL = ("mha_mma.cuh", "  if constexpr (KP > kMaxKPRegs) {\n    // the bias rows",
               "  if constexpr (false) {\n    // the bias rows")
NO_ATOMICS = ("mha_mma.cuh", "    if (qr >= K || kc >= K) return;", "    return;")
NO_COPY = ("mha_mma.cuh", "for (int i = lane; i < rows * per_row; i += 32) {",
           "for (int i = lane; i < 0; i += 32) {")
WIDE_VARIANTS = {
    "qkv_bias_global": (QKV, [BIAS_GLOBAL], (0, 1, 2, 3)),
    "mha_bias_global": (MHA, [BIAS_GLOBAL], (0, 1, 2, 3)),
    "qkv_no_dbias_atomics": (QKV, [NO_ATOMICS], (0, 1, 2)),
    "mha_no_dbias_atomics": (MHA, [NO_ATOMICS], (0, 1, 2)),
    "qkv_no_bias_copy": (QKV, [NO_COPY], ()),
    "mha_no_bias_copy": (MHA, [NO_COPY], ()),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=64, choices=sorted(BATCH),
                    help="K: 64 (the flagship), 120 or 152")
    K = ap.parse_args(argv).k
    B = BATCH[K]
    variants = dict(VARIANTS, **(WIDE_VARIANTS if K > 128 else {}))
    if not torch.cuda.is_available():
        log("attn_bwd_probe needs a CUDA card")
        return 1
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    dev = torch.device("cuda", torch.cuda.current_device())
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    _build.build([QKV, MHA])
    with ThreadPoolExecutor(len(variants)) as ex:
        fns = dict(zip(variants, ex.map(lambda n: _build.build_variant(
            variants[n][0], variants[n][1], f"probe_{n}"), variants)))
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    x, do, q, k, v = (rnd(B, K, D) for _ in range(5))
    w, b = rnd(D, 3 * D, std=D ** -0.5), rnd(3 * D, std=0.1, dtype=torch.float32)
    bias = rnd(K, K, std=0.5, dtype=torch.float32)
    bias[:, K - MASKED:] = -1e9
    bias = bias.to(bf)
    scale, stream = fa.attention_scale(D // H), _build.stream_of(x)
    blocks = _build.persistent_blocks(x, per_sm=fa.BWD_BLOCKS_PER_SM)
    n_part = {QKV: D * 3 * D + 3 * D + K * K, MHA: K * K}
    out = {QKV: (torch.empty_like(x), torch.empty(blocks, n_part[QKV], device=dev),
                 torch.empty(n_part[QKV], device=dev)),
           MHA: (torch.empty_like(q), torch.empty_like(q), torch.empty_like(q),
                 torch.empty(blocks, K * K, device=dev), torch.empty(K, K, device=dev))}

    def variant(name):
        lib = variants[name][0]
        if lib == QKV:
            ptrs = [t.data_ptr() for t in (x, w, b, bias, do, *out[QKV])]
            rc = fns[name](*ptrs, blocks, B, K, D, H, scale, *kernel_args(P_DROP, SEED), 0, 1,
                           dev.index, stream)
        else:
            ptrs = [t.data_ptr() for t in (q, k, v, bias, do, *out[MHA])]
            rc = fns[name](*ptrs, blocks, B, K, D, H, scale, *kernel_args(P_DROP, SEED), 1,
                           dev.index, stream)
        if rc:
            raise RuntimeError(f"the {name} build failed to launch: {rc}")

    def outputs(lib):
        if lib == QKV:
            dx, _, grads = out[QKV]
            return (dx, *grads.split([D * 3 * D, 3 * D, K * K]))
        dq, dk, dv, _, dbias = out[MHA]
        return dq, dk, dv, dbias.flatten()

    built = {QKV: lambda p=P_DROP: fa.fused_mha_qkv_bwd(x, w, b, bias, do, H, p, SEED),
             MHA: lambda p=P_DROP: fa.fused_mha_bwd(q, k, v, bias, do, H, p, SEED)}
    for name, (lib, _, same) in variants.items():
        variant(name)
        torch.cuda.synchronize()
        want = [t.flatten() for t in built[lib]()]
        for i in same:
            if not torch.equal(outputs(lib)[i].flatten(), want[i]):
                raise AssertionError(f"{name}: output {i} differs from the kernel's as built")
    qkv_leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    mha_leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def heads(t):
        return t.view(B, K, H, D // H).transpose(1, 2)

    def sdpa(q, k, v):
        o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=bias)
        return o.transpose(1, 2).reshape(B, K, D)

    ys = {QKV: sdpa(*(torch.matmul(qkv_leaves[0], qkv_leaves[1])
                      + qkv_leaves[2].to(bf)).split(D, -1)),
          MHA: sdpa(*mha_leaves)}
    leaves = {QKV: qkv_leaves, MHA: mha_leaves}
    times = {}
    for _ in range(2):
        for lib in (QKV, MHA):
            names = [n for n, v in variants.items() if v[0] == lib]
            for turn in ("built", *names, *names[::-1], "built"):
                if turn == "built":
                    times.setdefault(f"{lib} built", []).append(cuda_time_ms(built[lib]))
                    times.setdefault(f"{lib} built no dropout", []).append(
                        cuda_time_ms(lambda: built[lib](0.0)))
                else:
                    times.setdefault(turn, []).append(cuda_time_ms(lambda: variant(turn)))
            times.setdefault(f"{lib} library", []).append(cuda_time_ms(
                lambda: torch.autograd.grad(ys[lib], leaves[lib], do, retain_graph=True)))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    for lib, short in ((QKV, "qkv"), (MHA, "mha")):
        a = ms[f"{lib} built"]
        log(f"[attn_bwd_probe] {lib} B={B} K={K} D={D} H={H} bf16: as built {a:.4f} ms "
            f"(p={P_DROP}), {ms[f'{lib} built no dropout']:.4f} without dropout (the hash "
            f"{a - ms[f'{lib} built no dropout']:.4f}); library call {ms[f'{lib} library']:.4f}; "
            + "; ".join(f"{n} {ms[n]:.4f} ({ms[n] - a:+.4f})"
                        for n in variants if n.startswith(short)))
    log(json.dumps({"attn_bwd_probe": dict(B=B, K=K, D=D, H=H, ms=ms, runs=times)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
