"""Card probe: one call of each kernel row at `chip_smoke.py`'s flagship
shapes (bf16, dropout p = 0.1 where the kernel drops), timed with CUDA
events, from the checkout named by ``--root`` (default: the one holding
this file).  Run it by path from two checkouts in turns (a, b, b, a) in
one call on one card to hold them against each other:

    python tossctr_tpu_torch/exp/kernel_times.py --root <checkout>

Prints the card's name and power limit, then one JSON line: {"root": ...,
"ms": {row: ms}, "fp32_sha1": {row: digest}}, the digests those of the
fp32 outputs (the CUDA-core kernels) of the two attention forwards and
of the block tail's forward and backward on the same inputs, so two
checkouts' fp32 bits can be held against each other.
It imports only the package of ``--root`` and reads only the kernels'
public wrappers, so any checkout since the port's tensor-core PRs can be
timed by it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

B, K, D, H, FH = 8192, 64, 64, 8, 384  # the flagship: K = 60 padded to 64
VALID_K = 60
N_NUM, N_CAT = 82, 35  # the QNN head's numeric and categorical fields
FM_HEADS, FM_RANK, FM_OUT = 6, 16, 192
TABLE_ROWS, TABLE_WIDTH = 10_000_000, 128
P_DROP, SEED = 0.1, 1234567


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="the checkout whose package is timed")
    root = ap.parse_args(argv).root
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times needs a CUDA card", flush=True)
        return 1
    from tossctr_tpu_torch import ops
    from tossctr_tpu_torch.exp._timing import cuda_time_ms
    from tossctr_tpu_torch.ops import dropout as masks
    from tossctr_tpu_torch.ops.fm_cross import fm_cross_pallas_fwd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    N = B * K
    x, do, q, k, v = (rnd(B, K, D) for _ in range(5))
    wqkv, bqkv = rnd(D, 3 * D, std=D ** -0.5), rnd(3 * D, std=0.1, dtype=f32)
    bias = rnd(K, K, std=0.5, dtype=f32)
    bias[:, VALID_K:] = -1e9
    bias = bias.to(bf)
    tail = (rnd(N, D), rnd(N, D), rnd(D, D, std=D ** -0.5), rnd(D, std=0.1, dtype=f32),
            1 + rnd(D, std=0.1, dtype=f32), rnd(D, FH, std=D ** -0.5),
            rnd(FH, std=0.1, dtype=f32), rnd(FH, D, std=FH ** -0.5), rnd(D, std=0.1, dtype=f32),
            1 + rnd(D, std=0.1, dtype=f32))
    dy = rnd(N, D)
    ffn = (rnd(N, D), rnd(D, FH, std=D ** -0.5), rnd(FH, std=0.1, dtype=f32),
           rnd(FH, D, std=FH ** -0.5), rnd(D, std=0.1, dtype=f32))
    z = rnd(B, 1 + 2 * N_NUM + N_CAT, D)
    U, V = rnd(FM_HEADS, D, FM_RANK, std=0.1), rnd(FM_HEADS, FM_RANK, FM_OUT, std=0.1)
    gz = rnd(B, FM_HEADS * FM_OUT)
    table = rnd(TABLE_ROWS, TABLE_WIDTH)
    ids = torch.randint(0, TABLE_ROWS, (N,), generator=g, device=dev)
    deltas = rnd(N, TABLE_WIDTH, std=0.01, dtype=f32)
    rows = {
        "fused_mha_qkv": lambda: ops.fused_mha_qkv(x, wqkv, bqkv, bias, H, P_DROP, SEED),
        "fused_mha_qkv_bwd": lambda: ops.fused_mha_qkv_bwd(x, wqkv, bqkv, bias, do, H, P_DROP,
                                                           SEED),
        "fused_block_tail": lambda: ops.fused_block_tail(*tail, P_DROP, SEED),
        "fused_block_tail_bwd": lambda: ops.fused_block_tail_bwd(*tail, dy, P_DROP, SEED),
        "fused_mha": lambda: ops.fused_mha(q, k, v, bias, H, P_DROP, SEED),
        "fused_mha_bwd": lambda: ops.fused_mha_bwd(q, k, v, bias, do, H, P_DROP, SEED),
        "fused_ffn": lambda: ops.fused_ffn(*ffn, P_DROP, SEED),
        "fused_ffn_bwd": lambda: ops.fused_ffn_bwd(*ffn[:4], dy, P_DROP, SEED),
        "fm_cross_pallas": lambda: fm_cross_pallas_fwd(z, U, V),
        "fm_cross_pallas_bwd": lambda: ops.fm_cross_pallas_bwd(z, U, V, gz),
        "sweep_rows_add": lambda: ops.sweep_rows_add([table], ids, [deltas]),
        "dump_attention_keep": lambda: masks.dump_attention_keep(B, K, H, P_DROP, SEED, dev),
        "dump_ffn_keep": lambda: masks.dump_ffn_keep(N, FH, P_DROP, SEED, dev),
    }
    ms = {n: cuda_time_ms(f) for n, f in rows.items()}
    f32 = {"fused_mha_qkv": ops.fused_mha_qkv(x.float(), wqkv.float(), bqkv, bias.float(), H,
                                              P_DROP, SEED),
           "fused_mha": ops.fused_mha(q.float(), k.float(), v.float(), bias.float(), H, P_DROP,
                                      SEED)}
    tail32 = [t.float() for t in tail]
    f32["fused_block_tail"] = ops.fused_block_tail(*tail32, P_DROP, SEED)
    f32["fused_block_tail_bwd"] = torch.cat(
        [t.flatten() for t in ops.fused_block_tail_bwd(*tail32, dy.float(), P_DROP, SEED)])
    sha1 = {n: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest() for n, t in f32.items()}
    print(json.dumps({"root": root, "ms": ms, "fp32_sha1": sha1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
