"""Card diagnostic: ``chip_smoke.py``'s bf16 ``vs_plain`` check of the K =
148 config's step, split by kernel.

The K = 148 phase of ``chip_smoke.py`` holds the card's bf16 train step
(``cfgs/v3_k148_s1_tpu.yaml``: K = 152, 4 RMS encoder layers) against
the same step with the kernels' plain versions on the card, every ReLU
pinned (``PinnedPlain``).  On the same cache, batch and weights as that
phase, this prints the perturbation witnesses (each RMS encoder kernel's
bf16 outputs moved by an ulp on 0.05% of them, and all four at once)
and then, each against the plain step, both pinned:

  as built           every kernel on the card;
  key-tiled          the same with ``fused_mha_qkv_bwd`` at K = 152 on
                     its key-tiled CUDA-core kernel (a build with the
                     tensor-core form capped at K = 128: the kernel
                     before the K = 160 form);
  only <kernel>      one RMS encoder kernel on the card, the others'
                     plain versions (``fused_mha_qkv_bwd`` both ways).

So it says which kernels the step's distance comes from, and whether the
qkv backward's tensor-core form moves it.  Each case runs twice (the
kernels repeat bit for bit).  It reuses ``chip_smoke.py``'s step records
and comparison, so run it from the root of a checkout, on a card:

    python -m tossctr_tpu_torch.exp.step_kernel_split
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import importlib
import os
import subprocess
import sys
import tempfile

import torch

from ..config import Config
from ..config.flagship import v3_k148_config_dict
from ..data import BatchIterator, ShardCache
from ..data.synth import write_synth_cache_for
from ..models import init_params
from ..ops import _build
from ..train.trainer import build_model
from ._timing import log

QKV_BWD = "fused_mha_qkv_bwd"
# the tensor-core backwards capped at K = 128: fused_mha_qkv_bwd at K = 152
# on its key-tiled kernel
TILED = ("mha_mma.cuh", "return g.K <= kMaxKP && head_ok(g.dh) && (g.K <= kMaxKPRegs ||",
         "return g.K <= kMaxKPRegs && head_ok(g.dh) && (g.K <= kMaxKPRegs ||")


def key_tiled_library() -> ctypes.CDLL:
    """``fused_mha_qkv_bwd``'s library built with TILED, its entry point
    declared as ``_build.load_library`` declares it."""
    _build.build_variant(QKV_BWD, [TILED], "split_key_tiled")
    lib = ctypes.CDLL(str(_build.BUILD_DIR / "split_key_tiled" / f"{QKV_BWD}.so"))
    lib.tossctr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tossctr_cuda_error_string.restype = ctypes.c_char_p
    name, argtypes = _build.SIGNATURES[QKV_BWD]
    getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("step_kernel_split: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the one-step check's records and comparison

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    tiled_lib = key_tiled_library()

    @contextlib.contextmanager
    def key_tiled():
        built = _build.load_library(QKV_BWD)
        _build._libs[QKV_BWD] = tiled_lib
        try:
            yield
        finally:
            _build._libs[QKV_BWD] = built

    wrappers = {k: (importlib.import_module(m), a) for k, (m, a) in cs.ENCODER_WRAPPERS.items()}
    kernels = {k: getattr(mod, a) for k, (mod, a) in wrappers.items()}

    def only(kernel, *extra):
        mod, attr = wrappers[kernel]
        return lambda: cs.plain_versions_on_card(cs.swapped(mod, attr, kernels[kernel]),
                                                 *(f() for f in extra))

    d = v3_k148_config_dict()
    base = Config.from_dict(copy.deepcopy(d))
    d = cs.no_kernel_dropouts(d)
    d["amp"], d["model"]["table_dtype"] = "bf16", "float32"
    cfg = Config.from_dict(d)
    with tempfile.TemporaryDirectory() as tmp:  # the K = 148 phase's train cache
        cache = ShardCache(write_synth_cache_for(
            base, os.path.join(tmp, "train"), 4 * base.train.batch_size, num_dim=cs.N_NUM,
            seed=15))
        batch = next(iter(BatchIterator(cache, batch_size=cs.CHECK_ROWS, train=True)))
        model = init_params(build_model(cfg, cache.dims, dev), seed=77)
    init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    sel = cs.selected_ids(model, cs.to_device(batch, dev)).cpu()
    rows = (sel != cfg.sequence.pad_id).any(dim=1)
    ids = torch.unique(sel[rows])
    ids = ids[ids != cfg.sequence.pad_id]
    pin = cs.PinnedPlain(cfg, model, init, {k: v[rows.numpy()] for k, v in batch.items()}, dev,
                         ids)
    held = cs.K148_BANDS["vs_plain"]
    _, wit = pin.witness(held, together=True)
    for k, g in wit.items():
        log(f"[split] witness {k}: " + ", ".join(f"{m} {g[m]:.6g}" for m in held))
    cases = [("as built", contextlib.nullcontext), ("key-tiled", key_tiled),
             *((f"only {k}", only(k)) for k in cs.RMS_ENCODER),
             (f"only {QKV_BWD}, key-tiled", only(QKV_BWD, key_tiled))]
    for label, ctx in cases:
        for _ in range(2):
            g = pin.compare(ctx)
            log(f"[split] {label}: " + ", ".join(f"{m} {g[m]:.6g}" for m in held))
    return 0


if __name__ == "__main__":
    sys.exit(main())
