"""Card diagnostic: where the bf16 train step parts from the CPU's.

``chip_smoke.py``'s one-step check holds the card's bf16 step to the
CPU's (``vs_cpu``) and sets both beside the card's fp32 step
(``bf16_witnesses``).  This bisects that gap on the same synthetic batch
and parameters, on the rows with a history whose ordered selection the
card's bf16, the CPU's bf16 and the card's fp32 forward all share:

  1. the forward, module by module: each module's output on the card
     against the CPU's, and each against the card's fp32 forward, as the
     norm of the difference over the norm of the second;
  2. the step with one group of Dense layers at a time computed in fp32
     (inputs and weights in fp32, the result cast back to bf16) on both
     sides: the card against the CPU, as ``chip_smoke.py`` reports
     ``vs_cpu``, beside the same step with no group in fp32.

It reuses ``chip_smoke.py``'s step records and comparison, so run it from
the root of a checkout, on a card:

    python -m tossctr_tpu_torch.exp.bf16_bisect
"""

from __future__ import annotations

import contextlib
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
from ..models import layers as L
from ..models.layers import DropoutRNG
from ..train.trainer import build_model, step_seed
from ._timing import log

# the groups of Dense layers moved to fp32, by module-name prefix
DENSE_GROUPS = {"none": (), "embeddings": ("num_embed", "mask_embed", "cat_embed"),
                "encoder": ("dare.",), "context MLP": ("ctx_mlp",), "QNN head": ("qnn.",),
                "all": ("",)}


@contextlib.contextmanager
def dense_in_fp32(names: dict, prefixes: tuple):
    """Every Dense layer whose module name (``names``: id -> name) starts
    with one of ``prefixes`` computes in fp32 and returns the compute
    dtype."""
    plain = L.Dense.forward

    def forward(self, x, dtype):
        if dtype != torch.float32 and names.get(id(self), "").startswith(prefixes):
            return plain(self, x.float(), torch.float32).to(dtype)
        return plain(self, x, dtype)

    L.Dense.forward = forward
    try:
        yield
    finally:
        L.Dense.forward = plain


def activations(model, init, batch) -> list:
    """(module name, output in float64 on the CPU) for every module with a
    floating-point output, in the order they ran, in one forward of
    ``batch`` from ``init``."""
    out, hooks = [], []
    for name, mod in model.named_modules():
        def hook(_, __, o, name=name):
            t = o[0] if isinstance(o, (tuple, list)) else o
            if torch.is_tensor(t) and t.is_floating_point():
                out.append((name or "<model>", t.detach().double().cpu()))
        hooks.append(mod.register_forward_hook(hook))
    model.load_state_dict(init)
    try:
        with torch.no_grad():
            model(batch, rng=DropoutRNG(step_seed(1, 0), batch["y"].device))
    finally:
        for h in hooks:
            h.remove()
    return out


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bisect(cs, cfg, f_cfg, cache, dev) -> None:
    """Both steps of the bisect on ``cache``'s first check batch, with
    ``chip_smoke.py`` as ``cs``."""
    cpu = torch.device("cpu")
    batch = next(iter(BatchIterator(cache, batch_size=cs.CHECK_ROWS, train=True)))
    card = init_params(build_model(cfg, cache.dims, dev), seed=77)
    init = {k: v.to("cpu", copy=True) for k, v in card.state_dict().items()}
    on_cpu, fp32 = build_model(cfg, cache.dims, cpu), build_model(f_cfg, cache.dims, dev)
    for m in (on_cpu, fp32):
        m.load_state_dict(init)
    sides = {"card": (card, dev), "cpu": (on_cpu, cpu), "fp32": (fp32, dev)}
    sel = {n: cs.selected_ids(m, cs.to_device(batch, x)).cpu() for n, (m, x) in sides.items()}
    held = ((sel["card"] == sel["cpu"]).all(1) & (sel["fp32"] == sel["cpu"]).all(1)
            & (sel["cpu"] != cfg.sequence.pad_id).any(1))
    rows = {k: v[held.numpy()] for k, v in batch.items()}
    ids = torch.unique(sel["cpu"][held])
    ids = ids[ids != cfg.sequence.pad_id]
    log(f"[bisect] {int(held.sum())} of {cs.CHECK_ROWS} rows held, {ids.numel()} ids")

    log("[bisect] forward outputs, |diff|/|ref|: card bf16 vs CPU bf16 | card bf16 vs card "
        "fp32 | CPU bf16 vs card fp32")
    acts = [activations(m, init, cs.to_device(rows, x)) for m, x in sides.values()]
    for (name, a), (_, b), (_, t) in zip(*acts):
        log(f"[bisect]   {name} {tuple(a.shape)}: {rel(a, b):.3e} | {rel(a, t):.3e} | "
            f"{rel(b, t):.3e}")

    names = {id(mod): n for m in (card, on_cpu) for n, mod in m.named_modules()}
    for group, prefixes in DENSE_GROUPS.items():
        with dense_in_fp32(names, prefixes):
            g = cs._compare_steps(cs._step_record(cfg, card, init, rows, dev, ids),
                                  cs._step_record(cfg, on_cpu, init, rows, cpu, ids))
        log(f"[bisect] Dense in fp32: {group}: card vs CPU loss {g['loss']:.3g}, dense "
            f"gradients {g['grads']:.4g}, worst tensor {g['grad_tensor']:.4g}, accumulator "
            f"{g['accum']:.4g}, row update {g['delta']:.4g}; worst "
            + ", ".join(f"{n} {e:.3g}" for n, e in g["worst"][:4]))


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_bisect: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs  # the one-step check's records and comparison

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Config.from_dict(flagship_config_dict())

    def config(amp):
        d = cs.no_kernel_dropouts(flagship_config_dict())
        d["amp"], d["model"]["table_dtype"] = amp, "float32"
        return Config.from_dict(d)

    with tempfile.TemporaryDirectory() as tmp:  # chip_smoke.py's train cache
        cache = ShardCache(write_synth_cache_for(
            base, os.path.join(tmp, "train"), cs.TRAIN_BATCHES * base.train.batch_size,
            num_dim=cs.N_NUM, seed=11))
        bisect(cs, config("bf16"), config("none"), cache, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
