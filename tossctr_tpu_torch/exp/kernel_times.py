"""Card probe: one call of each kernel row at `chip_smoke.py`'s flagship
shapes (bf16, dropout p = 0.1 where the kernel drops), timed with CUDA
events, from the checkout named by ``--root`` (default: the one holding
this file).  Run it by path from two checkouts in turns (a, b, b, a) in
one call on one card to hold them against each other:

    python tossctr_tpu_torch/exp/kernel_times.py --root <checkout>

Prints the card's name and power limit, then one JSON line: {"root": ...,
"ms": {row: ms}, "fp32_sha1": {row: digest}, "bf16_sha1": {row: digest},
"sweep_parts_ms": {part: ms}}.  The rows ``*_k152`` time the two
attention backwards at the K = 148 config's shape (B = 4096, K = 152).
The fp32 digests are those of the fp32
outputs (the CUDA-core kernels) of the two attention forwards, of the
block tail's forward and backward and of the FM-cross forward and
backward (dz, dU, dV) on the same inputs, and of the (10M,
128) fp32 table after one ``sweep_rows_add``; the bf16 ones those of the
two bf16 attention backwards' outputs at the flagship's shape and of the
(10M, 128) bf16 table after one ``sweep_rows_add``, one ``dense_sweep``
or one ``sparse_sweep`` (W = 1024, the blocks the update's ids touch);
each table a fresh clone; so two checkouts' bits can be held against
each other.  The row ``sweep_rows_add_fp32`` times the update of the
fp32 table.  ``sweep_parts_ms`` splits ``sweep_rows_add``'s call (the
bf16 table) into the wrapper's sort, its search and the two kernels,
and for a checkout whose wrapper still packed the deltas (before the
kernel read them through the sort's permutation) the pack as well: the
split of the older call in PERF.md comes from that branch.
It imports only the package of ``--root`` and reads only the kernels'
public wrappers (the sweep's parts aside), so any checkout since the
port's tensor-core PRs can be timed by it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import pathlib
import subprocess
import sys

B, K, D, H, FH = 8192, 64, 64, 8, 384  # the flagship: K = 60 padded to 64
VALID_K = 60
B152, K152 = 4096, 152  # cfgs/v3_k148_s1_tpu.yaml: K = 148 padded to 152, its last 4 masked
N_NUM, N_CAT = 82, 35  # the QNN head's numeric and categorical fields
FM_HEADS, FM_RANK, FM_OUT = 6, 16, 192
TABLE_ROWS, TABLE_WIDTH = 10_000_000, 128
SWEEP_W = 1024  # the table sweeps' block width
P_DROP, SEED = 0.1, 1234567


def sha1(t) -> str:
    """The digest of a tensor's bytes, of any dtype."""
    import torch

    return hashlib.sha1(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()).hexdigest()


def sweep_parts(table, ids, deltas):
    """ms of each part of ``sweep_rows_add([table], ids, [deltas])``: the
    sort, the pack of the deltas (the older wrapper only), the search and
    the kernels, each timed alone on the outputs of the parts before it."""
    import torch

    from tossctr_tpu_torch.exp._timing import cuda_time_ms
    from tossctr_tpu_torch.ops._build import DTYPE_CODES, load_library, stream_of

    sw = importlib.import_module("tossctr_tpu_torch.ops.sweep_scatter")
    V, D = table.shape
    if hasattr(sw, "launch_sorted"):  # the kernel reads the deltas through the permutation
        ids_s, order = sw.sort_ids(ids, V)
        seg_end = sw.piece_ends(ids_s)
        return dict(sort=cuda_time_ms(lambda: sw.sort_ids(ids, V)),
                    search=cuda_time_ms(lambda: sw.piece_ends(ids_s)),
                    kernels=cuda_time_ms(lambda: sw.launch_sorted(
                        [table], [deltas], ids_s, order, seg_end, V, D)))
    # the older wrapper: sort, cast and permute the deltas, search, kernels
    lib, N = load_library("sweep_rows_add"), ids.numel()
    piece = lib.tossctr_sweep_piece()
    n_pieces = -(-N // piece)

    def sort():
        i32 = ids.reshape(-1).to(torch.int32)
        i32 = torch.where((i32 >= 0) & (i32 < V), i32, torch.full_like(i32, V))
        return torch.sort(i32, stable=True)

    def pack():
        return torch.cat([deltas.reshape(N, D).to(table.dtype)], dim=1).index_select(0, order)

    def search():
        last = torch.clamp(torch.arange(1, n_pieces + 1, device=ids.device) * piece - 1,
                           max=N - 1)
        return torch.searchsorted(ids_s, ids_s[last], right=True).to(torch.int32)

    ids_s, order = sort()
    packed, seg_end = pack(), search()
    ptrs = (ctypes.c_void_p * 1)(table.data_ptr())

    def kernels():
        head, tail = (torch.empty(n_pieces, D, dtype=torch.float32, device=ids.device)
                      for _ in range(2))
        lib.tossctr_sweep_rows_add(ptrs, 1, ids_s.data_ptr(), packed.data_ptr(),
                                   seg_end.data_ptr(), head.data_ptr(), tail.data_ptr(), N, V, D,
                                   DTYPE_CODES[table.dtype], ids.device.index, stream_of(ids))

    return dict(sort=cuda_time_ms(sort), pack=cuda_time_ms(pack), search=cuda_time_ms(search),
                kernels=cuda_time_ms(kernels))


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
    x152, do152, q152, k152, v152 = (rnd(B152, K152, D) for _ in range(5))
    bias152 = rnd(K152, K152, std=0.5, dtype=f32)
    bias152[:, K152 - 4:] = -1e9
    bias152 = bias152.to(bf)
    ffn = (rnd(N, D), rnd(D, FH, std=D ** -0.5), rnd(FH, std=0.1, dtype=f32),
           rnd(FH, D, std=FH ** -0.5), rnd(D, std=0.1, dtype=f32))
    z = rnd(B, 1 + 2 * N_NUM + N_CAT, D)
    U, V = rnd(FM_HEADS, D, FM_RANK, std=0.1), rnd(FM_HEADS, FM_RANK, FM_OUT, std=0.1)
    gz = rnd(B, FM_HEADS * FM_OUT)
    table = rnd(TABLE_ROWS, TABLE_WIDTH)
    table32 = rnd(TABLE_ROWS, TABLE_WIDTH, dtype=f32)
    ids = torch.randint(0, TABLE_ROWS, (N,), generator=g, device=dev)
    deltas = rnd(N, TABLE_WIDTH, std=0.01, dtype=f32)
    blocks = ops.touched_superblocks(ids, TABLE_ROWS, TABLE_WIDTH, SWEEP_W)
    fresh = table32.clone()
    ops.sweep_rows_add([fresh], ids, [deltas])
    sweep32_sha1 = sha1(fresh)
    del fresh
    bf16_sha1 = {
        "fused_mha_qkv_bwd": sha1(torch.cat([t.flatten().float() for t in ops.fused_mha_qkv_bwd(
            x, wqkv, bqkv, bias, do, H, P_DROP, SEED)])),
        "fused_mha_bwd": sha1(torch.cat([t.flatten().float() for t in ops.fused_mha_bwd(
            q, k, v, bias, do, H, P_DROP, SEED)])),
    }
    for name, fn in (("sweep_rows_add", lambda t: ops.sweep_rows_add([t], ids, [deltas])),
                     ("dense_sweep", lambda t: ops.dense_sweep(t, SWEEP_W)),
                     ("sparse_sweep", lambda t: ops.sparse_sweep(t, SWEEP_W, blocks))):
        fresh = table.clone()
        fn(fresh)
        bf16_sha1[name] = sha1(fresh)
        del fresh
    rows = {
        "fused_mha_qkv": lambda: ops.fused_mha_qkv(x, wqkv, bqkv, bias, H, P_DROP, SEED),
        "fused_mha_qkv_bwd": lambda: ops.fused_mha_qkv_bwd(x, wqkv, bqkv, bias, do, H, P_DROP,
                                                           SEED),
        "fused_block_tail": lambda: ops.fused_block_tail(*tail, P_DROP, SEED),
        "fused_block_tail_bwd": lambda: ops.fused_block_tail_bwd(*tail, dy, P_DROP, SEED),
        "fused_mha": lambda: ops.fused_mha(q, k, v, bias, H, P_DROP, SEED),
        "fused_mha_bwd": lambda: ops.fused_mha_bwd(q, k, v, bias, do, H, P_DROP, SEED),
        "fused_mha_qkv_bwd_k152": lambda: ops.fused_mha_qkv_bwd(
            x152, wqkv, bqkv, bias152, do152, H, P_DROP, SEED),
        "fused_mha_bwd_k152": lambda: ops.fused_mha_bwd(q152, k152, v152, bias152, do152, H,
                                                        P_DROP, SEED),
        "fused_ffn": lambda: ops.fused_ffn(*ffn, P_DROP, SEED),
        "fused_ffn_bwd": lambda: ops.fused_ffn_bwd(*ffn[:4], dy, P_DROP, SEED),
        "fm_cross_pallas": lambda: fm_cross_pallas_fwd(z, U, V),
        "fm_cross_pallas_bwd": lambda: ops.fm_cross_pallas_bwd(z, U, V, gz),
        "sweep_rows_add": lambda: ops.sweep_rows_add([table], ids, [deltas]),
        "sweep_rows_add_fp32": lambda: ops.sweep_rows_add([table32], ids, [deltas]),
        "dense_sweep": lambda: ops.dense_sweep(table, SWEEP_W),
        "sparse_sweep": lambda: ops.sparse_sweep(table, SWEEP_W, blocks),
        "dump_attention_keep": lambda: masks.dump_attention_keep(B, K, H, P_DROP, SEED, dev),
        "dump_ffn_keep": lambda: masks.dump_ffn_keep(N, FH, P_DROP, SEED, dev),
    }
    ms = {n: cuda_time_ms(f) for n, f in rows.items()}
    del table32
    f32 = {"fused_mha_qkv": ops.fused_mha_qkv(x.float(), wqkv.float(), bqkv, bias.float(), H,
                                              P_DROP, SEED),
           "fused_mha": ops.fused_mha(q.float(), k.float(), v.float(), bias.float(), H, P_DROP,
                                      SEED)}
    tail32 = [t.float() for t in tail]
    f32["fused_block_tail"] = ops.fused_block_tail(*tail32, P_DROP, SEED)
    f32["fused_block_tail_bwd"] = torch.cat(
        [t.flatten() for t in ops.fused_block_tail_bwd(*tail32, dy.float(), P_DROP, SEED)])
    zf, Uf, Vf = z.float(), U.float(), V.float()
    f32["fm_cross_pallas"] = fm_cross_pallas_fwd(zf, Uf, Vf)
    f32["fm_cross_pallas_bwd"] = torch.cat(
        [t.flatten().float() for t in ops.fm_cross_pallas_bwd(zf, Uf, Vf, gz.float())])
    del zf, Uf, Vf
    parts = sweep_parts(table, ids, deltas)
    fp32_sha1 = {n: sha1(t) for n, t in f32.items()}
    fp32_sha1["sweep_rows_add_fp32"] = sweep32_sha1
    print(json.dumps({"root": root, "ms": ms, "fp32_sha1": fp32_sha1,
                      "bf16_sha1": bf16_sha1, "sweep_parts_ms": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
