"""Card probe: the designs the table kernels were chosen from, timed in
turns on one card.

  1. ``csrc/table_sweep.cu`` as built (a CUDA block of 256 threads an
     item of 16 KB, 4 16-byte loads a thread) against the designs it was
     chosen over (``TABLE_VARIANTS``): the bulk-copy ring (a persistent
     grid, 1-D bulk copies through a ring of shared-memory stages) in
     four shapes and the register walk on a persistent grid, both built
     from ``exp/table_sweep_designs.cu``, and the kept kernel with deeper
     loads or 128 threads: the dense and the sparse sweep at W = 1024,
     4096 and 16384 on the scatter probe's three tables
     (``exp/scatter_probe.py`` ``TABLES``).  Each design is first held
     bit-equal to the plain version at each (table, W), then each variant
     is timed against the built kernel in turns (built, variant, variant,
     built).
  2. ``csrc/sweep_rows_add.cu`` as built (pass 1 issues the loads of 4
     sorted positions at once, at least 8 blocks of 128 threads an SM for
     bf16 tables, 4 for fp32 ones) against builds with other batches and
     blocks an SM (``UPDATE_VARIANTS`` on a bf16 table, ``F32_VARIANTS``
     on an fp32 one): the two kernels alone (``launch_sorted``'s work on
     the sorted ids) at the flagship's update with uniform, zipf:1.0 and
     hot-id ids (``chip_smoke.py``'s draws), each variant first held
     bit-equal to the build on the table as drawn, then timed in turns;
     with ptxas's registers and spills of each build's pass 1.

Prints the card's name and power limit, a line a measurement, and last
one JSON object of them all.

    python -m tossctr_tpu_torch.exp.sweep_design_probe [--part tables|update]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, dense_sweep_reference, sparse_sweep_reference, touched_superblocks
from ..ops._build import DTYPE_CODES, stream_of
from ..ops.table_sweep import marker
from . import scatter_probe as sp
from ._timing import PEAK_BYTES_PER_S, cuda_time_ms, log

TS = "table_sweep.cu"
DESIGNS = Path(__file__).with_name("table_sweep_designs.cu")
# the table sweep's other designs: {name: (the source in place of csrc's,
# or None for csrc's own, source changes)}
TABLE_VARIANTS = {
    "bulk ring 4 x 16 KB, 3 blocks an SM": (DESIGNS, []),
    "bulk ring 3 x 32 KB, 2 blocks an SM": (DESIGNS, [(TS, "kStages = 4;", "kStages = 3;"),
                                                      (TS, "kChunk = 8192;", "kChunk = 16384;"),
                                                      (TS, "kBlocksPerSM = 3;",
                                                       "kBlocksPerSM = 2;")]),
    "bulk ring 6 x 16 KB, 2 blocks an SM": (DESIGNS, [(TS, "kStages = 4;", "kStages = 6;"),
                                                      (TS, "kBlocksPerSM = 3;",
                                                       "kBlocksPerSM = 2;")]),
    "bulk ring 2 x 16 KB, 6 blocks an SM": (DESIGNS, [(TS, "kStages = 4;", "kStages = 2;"),
                                                      (TS, "kBlocksPerSM = 3;",
                                                       "kBlocksPerSM = 6;")]),
    "register pipeline, persistent (4 blocks an SM), 8 loads a thread": (
        DESIGNS, [(TS, "kBulk = true;", "kBulk = false;")]),
    "register pipeline, a block an item, 8 loads a thread": (None, [(TS, "kDepth = 4;",
                                                                     "kDepth = 8;")]),
    "register pipeline, 128 threads, a block an item, 8 loads a thread": (
        None, [(TS, "kDepth = 4;", "kDepth = 8;"), (TS, "kThreads = 256;", "kThreads = 128;")]),
}
SR = "sweep_rows_add.cu"
# sweep_rows_add's other pass-1 shapes: {name: source changes}
UPDATE_VARIANTS = {
    "batch 16, 3 blocks an SM": [(SR, "kBatch = 4;", "kBatch = 16;"),
                                 (SR, "kMinBlocks = 8;", "kMinBlocks = 3;")],
    "batch 8, 5 blocks an SM": [(SR, "kBatch = 4;", "kBatch = 8;"),
                                (SR, "kMinBlocks = 8;", "kMinBlocks = 5;")],
    "batch 8, 4 blocks an SM": [(SR, "kBatch = 4;", "kBatch = 8;"),
                                (SR, "kMinBlocks = 8;", "kMinBlocks = 4;")],
    "batch 4, 6 blocks an SM": [(SR, "kMinBlocks = 8;", "kMinBlocks = 6;")],
    "batch 2, 12 blocks an SM": [(SR, "kBatch = 4;", "kBatch = 2;"),
                                 (SR, "kMinBlocks = 8;", "kMinBlocks = 12;")],
}
# the same for fp32 tables, whose pass 1 has a launch bound of its own
F32_VARIANTS = {
    f"fp32 tables, {n} blocks an SM": [(SR, "kMinBlocksF32 = 4;", f"kMinBlocksF32 = {n};")]
    for n in (8, 6, 3, 2)}
FLAGSHIP_UPDATE = (10_000_000, 128, 8192 * 64)  # V, W of the lane-fused table, N = B x K
HOT = 150_000  # occurrences of the pad id 0 in the hot-id case
BUILT = "built (batch 4; 8 blocks an SM for bf16 tables, 4 for fp32)"


def in_turns(a, b, iters=10):
    """ms a call of ``a`` and of ``b``, timed a, b, b, a: -> (mean a, mean b,
    the four times)."""
    t = [cuda_time_ms(f, iters, 1) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def table_designs(dev) -> list:
    built = _build.load_library("table_sweep").tossctr_table_sweep
    variants = {name: _build.build_variant("table_sweep", subs, f"sweep_v{i}", source)
                for i, (name, (source, subs)) in enumerate(TABLE_VARIANTS.items())}
    c, recs = marker(), []
    for tag, (V, D, N, kind) in sp.TABLES.items():
        table, ids, _ = sp.make_inputs(V, D, N, kind, dev)
        for W in sp.WIDTHS:
            blocks = touched_superblocks(ids, V, D, W)

            def call(fn, t, listed):
                ptr, n_ids = (None, 0) if listed is None else (listed.data_ptr(), listed.numel())
                rc = fn(t.data_ptr(), t.numel(), W, c, ptr, n_ids, t.device.index, stream_of(t))
                if rc:
                    raise RuntimeError(f"table_sweep: CUDA error {rc}")

            for probe, listed, plain in (("dense", None, lambda t: dense_sweep_reference(t, W)),
                                         ("sparse", blocks,
                                          lambda t: sparse_sweep_reference(t, W, blocks))):
                want = table.clone()
                plain(want)
                for name, fn in (("built", built), *variants.items()):
                    got = table.clone()
                    call(fn, got, listed)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {probe} {tag} W={W}: not the plain version")
                    del got
                del want
                if listed is None:
                    n_bytes = 2 * table.numel() * table.element_size()
                else:
                    n_bytes = 2 * sp._block_bytes(table, W, listed)
                rec = dict(table=tag, W=W, sweep=probe, bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                           variants={})
                for name, fn in variants.items():
                    ms, other, four = in_turns(lambda: call(built, table, listed),
                                               lambda: call(fn, table, listed))
                    rec["variants"][name] = dict(built_ms=ms, ms=other, turns_ms=four)
                    log(f"[designs] {tag} {probe} W={W}: built (register pipeline, a block an "
                        f"item, 4 loads a thread) "
                        f"{ms:.4f} ms, {name} {other:.4f} ms (turns "
                        f"{', '.join(f'{x:.4f}' for x in four)}), bound {rec['bound_ms']:.4f} ms")
                recs.append(rec)
            log(f"[designs] {tag} W={W}: every design bit-equal to the plain version")
        del table, ids
        torch.cuda.empty_cache()
    return recs


def update_ids(kind, V, N, dev):
    """N update ids over V rows, as ``chip_smoke.py``'s sweep row draws
    them: uniform; zipf:1.0 (``bench.py``'s truncated-Pareto inverse CDF
    and multiplicative-hash shuffle); or uniform with the pad id 0 ``HOT``
    times."""
    g = torch.Generator(device=dev).manual_seed(8)
    if kind == "zipf":
        u = torch.rand(N, generator=g, device=dev, dtype=torch.float64)
        ranks = torch.clamp(torch.exp(u * np.log(float(V))).long(), max=V - 1)
        return (ranks * 2654435761) % V
    ids = torch.randint(0, V, (N,), generator=g, device=dev)
    if kind == "hot":
        ids[torch.randperm(N, generator=g, device=dev)[:HOT]] = 0
    return ids


def update_designs(dev) -> list:
    sw = importlib.import_module("tossctr_tpu_torch.ops.sweep_scatter")
    built = _build.load_library("sweep_rows_add").tossctr_sweep_rows_add
    reports = {BUILT: _build.ptxas_report("sweep_rows_add")}
    variants = {}
    for i, (name, subs) in enumerate({**UPDATE_VARIANTS, **F32_VARIANTS}.items()):
        variants[name] = _build.build_variant("sweep_rows_add", subs, f"sweep_rows_v{i}")
        reports[name] = _build.parse_ptxas(
            (_build.BUILD_DIR / f"sweep_rows_v{i}" / "sweep_rows_add.ptxas.txt").read_text())
    for name, rep in reports.items():
        for fn, r in rep.items():
            if "pieces" in fn:
                log(f"[designs] sweep_rows_add {name} {fn}: {r['registers']} registers, "
                    f"{r['spill_stores']} bytes spill stores")
    V, W, N = FLAGSHIP_UPDATE
    g = torch.Generator(device=dev).manual_seed(9)
    deltas = torch.randn(N, W, generator=g, device=dev) * 1e-3
    dels = (ctypes.c_void_p * 1)(deltas.data_ptr())
    tabs = (ctypes.c_void_p * 1)()
    recs = []
    for dtype, names in ((torch.bfloat16, UPDATE_VARIANTS), (torch.float32, F32_VARIANTS)):
        table = torch.randn(V, W, generator=g, device=dev).to(dtype)
        for kind in ("uniform", "zipf", "hot"):
            ids = update_ids(kind, V, N, dev)
            ids_s, order = sw.sort_ids(ids, V)
            seg_end = sw.piece_ends(ids_s)
            head, tail = (torch.empty(seg_end.numel(), W, dtype=torch.float32, device=dev)
                          for _ in range(2))

            def call(fn, t):
                tabs[0] = t.data_ptr()
                rc = fn(tabs, dels, 1, ids_s.data_ptr(), order.data_ptr(), seg_end.data_ptr(),
                        head.data_ptr(), tail.data_ptr(), N, V, W, DTYPE_CODES[t.dtype],
                        DTYPE_CODES[deltas.dtype], t.device.index, stream_of(t))
                if rc:
                    raise RuntimeError(f"sweep_rows_add: CUDA error {rc}")

            # every variant against the build on the table as drawn, before
            # any timed call changes it
            want = table.clone()
            call(built, want)
            for name in names:
                got = table.clone()
                call(variants[name], got)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"sweep_rows_add {kind}: {name} differs from the build")
                del got
            rec = dict(table=str(dtype), ids=kind, variants={})
            for name in names:
                ms, other, four = in_turns(lambda: call(built, table),
                                           lambda: call(variants[name], table))
                rec["variants"][name] = dict(built_ms=ms, ms=other, turns_ms=four)
                log(f"[designs] sweep_rows_add kernels {dtype} {kind}: {BUILT} {ms:.4f} ms, "
                    f"{name} {other:.4f} ms (turns {', '.join(f'{x:.4f}' for x in four)}); "
                    f"bit-equal")
            recs.append(rec)
            del ids, ids_s, order, seg_end, head, tail, want
        del table
        torch.cuda.empty_cache()
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("both", "tables", "update"), default="both",
                    help="time the table sweeps' designs, sweep_rows_add's, or both")
    part = ap.parse_args(argv).part
    if not torch.cuda.is_available():
        print("sweep_design_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    out = {}
    if part in ("both", "tables"):
        out["table_sweep"] = table_designs(dev)
    if part in ("both", "update"):
        out["sweep_rows_add"] = update_designs(dev)
    log(json.dumps({"sweep_designs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
