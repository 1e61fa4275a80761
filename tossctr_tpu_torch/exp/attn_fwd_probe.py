"""Card probe: the bf16 attention forwards' tensor-core kernels against
their block shapes.

At the flagship's shapes (B = 8192, K = 64), the K = 120 config's (B =
8192) and the K = 152 config's (B = 4096; D = 64, H = 8, bf16, the last 4
key columns masked) it times, with CUDA events, on one card and in turns
(as built, variants, variants, as built), ``fused_mha_qkv`` and
``fused_mha`` forward with dropout (p = 0.1) and without, each as built
and built with another number of warps a block or of blocks an SM that
its registers are sized for (``Form`` in ``csrc/fused_mha.cu`` and
``csrc/fused_mha_qkv.cu``), whose output must be bit-equal to the
kernel's as built (a unit's arithmetic does not depend on the block
shape); and ``fused_mha_qkv`` built without its projection or without its
attention units (timed only: what the other part costs).  Beside them
the PyTorch yardsticks ``chip_smoke.py`` times (``torch.matmul`` +
``F.scaled_dot_product_attention`` with the bias as ``attn_mask``; the
latter alone).  The last line is a JSON object of the
times (ms).

    python -m tossctr_tpu_torch.exp.attn_fwd_probe
"""

from __future__ import annotations

import importlib
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.dropout import kernel_args
from ._timing import cuda_time_ms, log

D, H = 64, 8
SHAPES = ((64, 8192), (120, 8192), (152, 4096))  # (K, B)
MASKED = 4
P_DROP = 0.1
SEED = 1234567
QKV, MHA = "fused_mha_qkv", "fused_mha"
FORM = ("  static constexpr int kWarps = KP == 64 ? 8 : 16;\n"
        "  static constexpr int kBlocks = KP == 64 ? 2 : 1;\n")


def form(w64, b64, w_wide, b_wide):
    """``Form`` with (warps a block, blocks an SM the registers are sized
    for) at KP = 64, then at KP = 128 and 160."""
    return (f"  static constexpr int kWarps = KP == 64 ? {w64} : {w_wide};\n"
            f"  static constexpr int kBlocks = KP == 64 ? {b64} : {b_wide};\n")


# variant: (libraries, [(file, source, replacement)], output held bit-equal
# to the kernel's as built): other block forms, and fused_mha_qkv with its
# projection or its attention units taken out (timed only)
BOTH = (QKV, MHA)
VARIANTS = {
    "w8b1": (BOTH, [("{lib}.cu", FORM, form(8, 1, 8, 1))], True),
    "w16": (BOTH, [("{lib}.cu", FORM, form(16, 1, 16, 1))], True),
    "w8": (BOTH, [("{lib}.cu", FORM, form(8, 2, 8, 1))], True),
    "no_proj": ((QKV,), [(f"{QKV}.cu", "    project_qkv_chain(",
                          "    if (false) project_qkv_chain(")], False),
    "no_units": ((QKV,), [(f"{QKV}.cu", "for (int u = warp; u < units; u += kWarpsF) {",
                           "for (int u = warp; u < 0; u += kWarpsF) {")], False),
}


def main() -> int:
    if not torch.cuda.is_available():
        log("attn_fwd_probe needs a CUDA card")
        return 1
    fa = importlib.import_module("tossctr_tpu_torch.ops.fused_attention")
    dev = torch.device("cuda", torch.cuda.current_device())
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    _build.build([QKV, MHA])
    jobs = [(lib, v) for v, (libs, _, _) in VARIANTS.items() for lib in libs]

    def build(job):
        lib, name = job
        subs = [(f.format(lib=lib), old, new) for f, old, new in VARIANTS[name][1]]
        return _build.build_variant(lib, subs, f"probe_fwd_{lib}_{name}")

    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc a variant, all at once
        fns = dict(zip(jobs, pool.map(build, jobs)))
    for lib, name in [(lib, "built") for lib in (QKV, MHA)] + jobs:
        path = (_build.BUILD_DIR / f"{lib}.ptxas.txt" if name == "built"
                else _build.BUILD_DIR / f"probe_fwd_{lib}_{name}" / f"{lib}.ptxas.txt")
        for fn, r in sorted(_build.parse_ptxas(path.read_text()).items()):
            if "fwd_mma" in fn or "fwd_chain" in fn:
                log(f"{lib} {name} {fn}: {r['registers']} registers, spill stores "
                    f"{r['spill_stores']} / loads {r['spill_loads']} bytes")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    times = {}
    for K, B in SHAPES:
        x, q, k, v = (rnd(B, K, D) for _ in range(4))
        w, b = rnd(D, 3 * D, std=D ** -0.5), rnd(3 * D, std=0.1, dtype=torch.float32)
        bias = rnd(K, K, std=0.5, dtype=torch.float32)
        bias[:, K - MASKED:] = -1e9
        bias = bias.to(bf)
        out = torch.empty_like(x)
        scale, stream = fa.attention_scale(D // H), _build.stream_of(x)
        ins = {QKV: (x, w, b, bias), MHA: (q, k, v, bias)}
        built = {QKV: lambda p: fa.fused_mha_qkv_fwd(x, w, b, bias, H, p, SEED),
                 MHA: lambda p: fa.fused_mha_fwd(q, k, v, bias, H, p, SEED)}

        def variant(lib, name, p):
            ptrs = [t.data_ptr() for t in ins[lib]]
            rc = fns[(lib, name)](*ptrs, out.data_ptr(), B, K, D, H, scale,
                                  *kernel_args(p, SEED), 0, 1, 1, dev.index, stream)
            if rc:
                raise RuntimeError(f"the {lib} {name} build failed to launch: {rc}")
            return out

        for lib, name in jobs:
            for p in (0.0, P_DROP):
                got = variant(lib, name, p).clone()
                if VARIANTS[name][2] and not torch.equal(got, built[lib](p)):
                    raise AssertionError(f"{lib} {name} K={K} p={p}: output differs from the "
                                         "kernel's as built")

        def heads(t):
            return t.view(B, K, H, D // H).transpose(1, 2)

        def sdpa(q, k, v):
            o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=bias)
            return o.transpose(1, 2).reshape(B, K, D)

        library = {QKV: lambda: sdpa(*(torch.matmul(x, w) + b.to(bf)).split(D, -1)),
                   MHA: lambda: sdpa(q, k, v)}
        for _ in range(2):
            for lib in (QKV, MHA):
                names = [n for n, (libs, _, _) in VARIANTS.items() if lib in libs]
                order = ["built", *names, *reversed(names), "built"]
                for name in order:
                    for p in (P_DROP, 0.0):
                        fn = ((lambda p=p: built[lib](p)) if name == "built"
                              else (lambda p=p, name=name: variant(lib, name, p)))
                        key = f"{lib} K={K} {name} p={p}"
                        times.setdefault(key, []).append(cuda_time_ms(fn))
                times.setdefault(f"{lib} K={K} library", []).append(cuda_time_ms(library[lib]))
        for lib in (QKV, MHA):
            for name in ["built"] + [n for n, (libs, _, _) in VARIANTS.items() if lib in libs]:
                log(f"{lib} K={K} B={B} {name}: "
                    + ", ".join(f"p={p} {sum(t) / len(t):.4f} ms ({min(t):.4f}-{max(t):.4f})"
                                for p in (P_DROP, 0.0)
                                for t in [times[f'{lib} K={K} {name} p={p}']]))
            t = times[f"{lib} K={K} library"]
            log(f"{lib} K={K} B={B} library call: {sum(t) / len(t):.4f} ms")
        del x, q, k, v, out, ins, built, library
        torch.cuda.empty_cache()
    print(json.dumps({k: sum(t) / len(t) for k, t in times.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
