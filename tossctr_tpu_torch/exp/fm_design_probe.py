"""Card probe: where the bf16 FM-cross kernels' time goes, and the designs
they were chosen from, timed in turns on one card.

  1. The split of one call of each (``torch.profiler``, device time by
     kernel): the forward's tensor-core kernel; the backward's main
     kernel, the dV pass (``fm_dv_kernel``) and the two reductions.
  2. ``csrc/fm_cross_bwd.cu`` and ``fm_cross.cu`` as built against
     builds with a part changed (``VARIANTS``, built with
     ``_build.build_variant``): the forward's first form (a deeper ring,
     one block an SM), both kernels at the flagship with their loop counts
     bounded as for any shape instead of fixed, each held bit-equal to the
     build first; the backward with the flagship's A, dz or dU products
     on ``mma.sync`` as for any shape instead of ``wgmma`` (timed only:
     their sums run in another order); and, timed only (their results are wrong
     by design), the backward with its dU products, its dz products or its
     first sweep's sums taken out, to show what each costs.  Each
     variant is timed against the build in turns (built, variant,
     variant, built), with ptxas's registers and spills of its kernel.

At the flagship's QNN shapes (B = 8192, F = 200, D = 64, H = 6, R = 16,
P = 192, bf16).  Prints the card's name and power limit, a line a
measurement, and last one JSON object of them all.

    python -m tossctr_tpu_torch.exp.fm_design_probe
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops.fm_cross import fm_cross_pallas_bwd, fm_cross_pallas_fwd, launch_bwd, launch_fwd
from ._timing import cuda_time_ms, log

B, F, D, H, R, P = 8192, 200, 64, 6, 16, 192
FWD, BWD, HDR = "fm_cross.cu", "fm_cross_bwd.cu", "fm_mma.cuh"
# {name: (library, source changes, held bit-equal to the build)}
VARIANTS = {
    "forward: 4 ring stages, 1 block an SM": (
        "fm_cross", [(HDR, "kFwdStages = 3;", "kFwdStages = 4;"),
                     (FWD, "__launch_bounds__(mm::kThreads, 2)\nfm_fwd_mma_kernel",
                      "__launch_bounds__(mm::kThreads, 1)\nfm_fwd_mma_kernel")], True),
    "forward: loop counts bounded, not fixed": (
        "fm_cross", [(HDR, "return L.NT == 12 && L.DT == 4;", "return false;")], True),
    "backward: loop counts bounded, not fixed": (
        "fm_cross_bwd", [(HDR, "return L.NT == 12 && L.DT == 4;", "return false;")], True),
    "backward: A = z U on mma.sync, as for any shape (timed only)": (
        "fm_cross_bwd", [(BWD, "constexpr bool kAWgmma = EXACT;",
                          "constexpr bool kAWgmma = false;")], False),
    "backward: dz products on mma.sync, as for any shape (timed only)": (
        "fm_cross_bwd", [(BWD, "constexpr bool kDzWgmma = EXACT;",
                          "constexpr bool kDzWgmma = false;")], False),
    "backward: dU products on mma.sync, as for any shape (timed only)": (
        "fm_cross_bwd", [(BWD, "constexpr bool kDuWgmma = EXACT;",
                          "constexpr bool kDuWgmma = false;")], False),
    "backward: dU products out (timed only)": (
        "fm_cross_bwd", [(BWD, "for (int ws = 0; ws < kWarps; ++ws) {",
                          "for (int ws = 0; ws < 0; ++ws) {")], False),
    "backward: dz products out (timed only)": (
        "fm_cross_bwd", [(BWD, "        mm::wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>"
                               "(&dzacc[0][0]), hi, b);\n"
                               "        mm::wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>"
                               "(&dzacc[0][0]), lo, b);\n", "")], False),
    "backward: sweep 1's sums out (timed only)": (
        "fm_cross_bwd", [(BWD, "if (p < n_groups) {  // ---- sweep 1",
                          "if (false) {  // ---- sweep 1")], False),
}


def kernel_split(fn, keys):
    """Device ms of one call of ``fn`` by kernel (name -> ms), for the
    kernels whose names hold one of ``keys``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if t and any(k in e.key for k in keys):
            out[e.key[:60]] = t / 5 / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("fm_design_probe needs a CUDA card")
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    z = torch.randn(B, F, D, generator=g, device=dev).to(bf)
    U = (torch.randn(H, D, R, generator=g, device=dev) * 0.1).to(bf)
    V = (torch.randn(H, R, P, generator=g, device=dev) * 0.1).to(bf)
    gz = torch.randn(B, H * P, generator=g, device=dev).to(bf)
    res = {"shape": dict(B=B, F=F, D=D, H=H, R=R, P=P)}

    res["split_fwd"] = kernel_split(lambda: fm_cross_pallas_fwd(z, U, V), ("fm_",))
    res["split_bwd"] = kernel_split(lambda: fm_cross_pallas_bwd(z, U, V, gz),
                                    ("fm_", "reduce_partials"))
    for part in ("split_fwd", "split_bwd"):
        for k, v in res[part].items():
            log(f"[split] {k}: {v:.4f} ms")

    built = {"fm_cross": _build.load_library("fm_cross").tossctr_fm_cross_fwd,
             "fm_cross_bwd": _build.load_library("fm_cross_bwd").tossctr_fm_cross_bwd}

    def call(lib, fn):
        rc, out = (launch_fwd(fn, z, U, V) if lib == "fm_cross" else launch_bwd(fn, z, U, V, gz))
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    def flat(out):
        return out if isinstance(out, torch.Tensor) else torch.cat(
            [t.flatten().float() for t in out])

    ref = {lib: flat(call(lib, fn)) for lib, fn in built.items()}
    res["variants"] = {}
    for i, (name, (lib, subs, exact)) in enumerate(VARIANTS.items()):
        fn = _build.build_variant(lib, subs, f"fm_probe{i}")
        regs = _build.parse_ptxas((_build.BUILD_DIR / f"fm_probe{i}" / f"{lib}.ptxas.txt")
                                  .read_text())
        regs = {k: v for k, v in regs.items() if "_mma" in k}
        if exact and not torch.equal(flat(call(lib, fn)), ref[lib]):
            raise AssertionError(f"{name} differs from the build")
        t = [cuda_time_ms(lambda f=f: call(lib, f))
             for f in (built[lib], fn, fn, built[lib])]
        row = dict(built_ms=[t[0], t[3]], variant_ms=[t[1], t[2]], ptxas=list(regs.values()))
        res["variants"][name] = row
        log(f"[variant] {name}: built {t[0]:.4f} / {t[3]:.4f} ms, variant {t[1]:.4f} / "
            f"{t[2]:.4f} ms; ptxas {row['ptxas']}" + ("; bit-equal" if exact else ""))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
