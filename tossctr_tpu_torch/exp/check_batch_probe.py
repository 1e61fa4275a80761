"""Card diagnostic: ``chip_smoke.py``'s bf16 one-step check of the flagship
on other batches than its own.

``chip_smoke.py`` holds the card's bf16 flagship train step against the
CPU's on one 512-row batch (the first rows of its synthetic train cache)
with the bands of ``CHECK_BANDS["bf16"]``.  This runs the same check
(``train_reference_check``, the held comparisons) on 512-row batches of
synthetic caches written at other seeds and with the sequence
vocabulary cut to 131,072 rows, in the sparse-table step (the lane-fused
table, exact dedup) and in the dense ``adamw`` step with split tables,
the first case also with the fp32 witness (how far each side's bf16 step
lands from the card's fp32 step).  So it says whether the bands hold
beyond the batch they were set on, and whether the card's gap to the CPU
is its kernels' or rounding order.  Every case prints its distances and
whether it is within the bands; the probe fails only if a case errs.  It
reuses ``chip_smoke.py``'s step records and checks, so run it from the
root of a checkout, on a card:

    python -m tossctr_tpu_torch.exp.check_batch_probe
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import tempfile

import torch

CUT_VOCAB = 1 << 17
# (label, sequence vocabulary (None: the flagship's), cache seed, table
# layout and optimizer, with the fp32 witness)
CASES = (
    ("sparse fused, cut vocabulary, seed 29", CUT_VOCAB, 29, "sparse", True),
    ("sparse fused, 10M vocabulary, seed 11, 512 rows", None, 11, "sparse", False),
    ("sparse fused, cut vocabulary, seed 11", CUT_VOCAB, 11, "sparse", False),
    ("dense adamw split, cut vocabulary, seed 29", CUT_VOCAB, 29, "dense", False),
    ("dense adamw split, cut vocabulary, seed 11", CUT_VOCAB, 11, "dense", False),
)


def main() -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    import chip_smoke as cs

    from tossctr_tpu_torch.config import Config
    from tossctr_tpu_torch.config.flagship import flagship_config_dict
    from tossctr_tpu_torch.data import ShardCache
    from tossctr_tpu_torch.data.synth import write_synth_cache_for
    from tossctr_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("check_batch_probe: no CUDA device", file=sys.stderr)
        return 2
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="check_batches_", dir=build) as tmp:
        for label, vocab, seed, mode, witness in CASES:
            d = flagship_config_dict()
            if vocab:
                d["model"]["seq_vocab"] = vocab
            if mode == "dense":
                d["model"]["fused_seq_tables"] = False
                d["train"]["embedding_optimizer"] = "adamw"
            man = write_synth_cache_for(Config.from_dict(copy.deepcopy(d)),
                                        os.path.join(tmp, f"{label[:5]}_{seed}_{vocab}"),
                                        cs.CHECK_ROWS, num_dim=cs.N_NUM, seed=seed)
            cs.log(f"===== {label}")
            try:
                cs.train_reference_check(d, ShardCache(man), dev, "bf16", tag=label,
                                         held_only=not witness)
                cs.log(f"===== {label}: within the bands")
            except AssertionError as e:
                cs.log(f"===== {label}: out of the bands: {e}")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
