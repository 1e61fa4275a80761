"""Card probe: where the bf16 ``fused_ffn`` backward's time goes beyond its
epilogue.

At the flagship's shapes (N = 8192 x 64 rows, D = 64, F = 384, bf16) it
times, with CUDA events, on one card and in turns (A, B, B, A, twice):

  A. the backward kernel as built (``ops.fused_ffn_bwd``), with dropout
     (p = 0.1) and without: the gap is the counter hash's cost;
  B. the same source built with the flush of the weight-gradient partials
     removed (the float2 atomics into the block's partial buffer once a
     super-tile and chunk): the gap to A is what the flush costs.  B's
     weight gradients are wrong, so it is timed only; its dx is held
     bit-equal to A's;

beside the autograd backward of the three-call composite (``F.linear``,
tanh ``F.gelu``, ``F.linear``), the yardstick ``chip_smoke.py`` times.
The last line is a JSON object of the times.

    python -m tossctr_tpu_torch.exp.ffn_bwd_probe
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.dropout import kernel_args
from ._timing import cuda_time_ms, log

N, D, FH = 8192 * 64, 64, 384
P_DROP = 0.1
SEED = 1234567
# the flush in fused_ffn_bwd.cu, and what stands in for it in variant B
# (a use of the accumulators that never stores, so the products stay)
FLUSH = """      if (warp < kChunk / kWarpRows)
        add_block<DP / 8>(part + P.dw2, D, f0 + warp * kWarpRows, 0, F, D, acc);
      else if (warp - kChunk / kWarpRows < DP / 16)
        add_block<8>(part + P.dw1, F, (warp - kChunk / kWarpRows) * kWarpRows, f0, D, F, acc);"""
NO_FLUSH = "      if (acc[0][0] == 12345.f) part[0] = acc[1][1];"


def main() -> int:
    if not torch.cuda.is_available():
        log("ffn_bwd_probe needs a CUDA card")
        return 1
    ff = importlib.import_module("tossctr_tpu_torch.ops.fused_ffn")
    dev = torch.device("cuda", torch.cuda.current_device())
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    no_flush = _build.build_variant("fused_ffn_bwd", [("fused_ffn_bwd.cu", FLUSH, NO_FLUSH)],
                                    "fused_ffn_bwd_no_flush")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    x, dy = rnd(N, D), rnd(N, D)
    w1, w2 = rnd(D, FH, std=D ** -0.5), rnd(FH, D, std=FH ** -0.5)
    b1 = rnd(FH, std=0.1, dtype=torch.float32)
    blocks = _build.persistent_blocks(x)
    n = 2 * D * FH + FH + D
    dx = torch.empty_like(x)
    partials = torch.empty(blocks, n, device=dev)
    grads = torch.empty(n, device=dev)

    def variant_b(p):
        rc = no_flush(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
                      dx.data_ptr(), partials.data_ptr(), grads.data_ptr(), blocks, N, D, FH,
                      *kernel_args(p, SEED), 1, dev.index, _build.stream_of(x))
        if rc:
            raise RuntimeError(f"the no-flush build failed to launch: {rc}")

    variant_b(P_DROP)
    torch.cuda.synchronize()
    if not torch.equal(dx, ff.fused_ffn_bwd(x, w1, b1, w2, dy, P_DROP, SEED)[0]):
        raise AssertionError("the no-flush build's dx differs from the kernel's")
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2)]
    out = F.linear(F.gelu(F.linear(leaves[0], leaves[1].t(), leaves[2].to(torch.bfloat16)),
                          approximate="tanh"), leaves[3].t())
    times = {k: [] for k in ("built", "built_no_dropout", "no_flush", "library")}
    for _ in range(2):
        for name in ("built", "no_flush", "no_flush", "built"):
            if name == "built":
                times[name].append(cuda_time_ms(lambda: ff.fused_ffn_bwd(x, w1, b1, w2, dy,
                                                                         P_DROP, SEED)))
                times["built_no_dropout"].append(
                    cuda_time_ms(lambda: ff.fused_ffn_bwd(x, w1, b1, w2, dy)))
            else:
                times[name].append(cuda_time_ms(lambda: variant_b(P_DROP)))
        times["library"].append(cuda_time_ms(
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"[ffn_bwd_probe] N={N} D={D} F={FH} bf16: as built {ms['built']:.4f} ms (p={P_DROP}), "
        f"{ms['built_no_dropout']:.4f} ms without dropout (the hash "
        f"{ms['built'] - ms['built_no_dropout']:.4f}); without the flush "
        f"{ms['no_flush']:.4f} ms (the flush {ms['built'] - ms['no_flush']:.4f}); library call "
        f"{ms['library']:.4f} ms")
    log(json.dumps({"ffn_bwd_probe": dict(N=N, D=D, F=FH, ms=ms, runs=times)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
