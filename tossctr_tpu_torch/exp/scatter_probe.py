"""Card probe: how fast can the card read, modify and write the (10M, D)
embedding table?

Port of the JAX package's TPU probe ``exp/scatter_probe.py``.  On a bf16
table it times, with CUDA events over an in-place chain (as the JAX probe
chains donated buffers):

  A. ``Tensor.index_add_`` of N bf16 deltas at N sorted ids: the
     library's scatter-add, the baseline (the JAX probe's XLA scatter).
  B. The dense sweep: a constant added to every (16, W) block of the
     table viewed as (V*D/W, W), W in {1024, 4096, 16384}: the least a
     sweep of the whole table costs (``ops.dense_sweep``).
  C. The sparse sweep: the same over the blocks the ids touch only, from
     the probe's padded list (``ops.sparse_sweep`` over
     ``ops.touched_superblocks``).
  D. ``sweep_rows_add``, the port's table-update kernel, on the same ids
     and deltas: each touched row read and written once.

on three tables: the JAX probe's own, V = 10M, D = 64, N = 4096 * 60
uniform ids drawn from ``default_rng(0)`` as it draws them; and the
port's flagship lane-fused table, (10M, 128), N = 8192 * 64, once with
uniform ids and once with zipf:1.0 ids (``bench.py``'s truncated-Pareto
draw and multiplicative-hash shuffle: a skewed batch touches fewer rows,
and maybe fewer blocks).  Before it is timed, each
kernel is held against its plain version on a copy: B and C bit-equal (C
leaves the untouched blocks as they were, and the list's padding repeats
add nothing), D within one bf16 ulp of each element (its sums run in
another order) with the untouched rows bit-equal.  Reports each
measurement's ms, the bytes it must move over its time against the
card's 3.35 TB/s, and the touched superblocks; the last line is a JSON
object of every record.

    python -m tossctr_tpu_torch.exp.scatter_probe
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..ops import (
    dense_sweep,
    dense_sweep_reference,
    sparse_sweep,
    sparse_sweep_reference,
    sweep_rows_add,
    sweep_rows_add_reference,
    touched_superblocks,
)
from ..ops.table_sweep import BLOCK_ROWS, marker, n_blocks
from ._timing import PEAK_BYTES_PER_S, cuda_time_ms, log

WIDTHS = (1024, 4096, 16384)
# name: (V, D, N, ids): the JAX probe's table and ids, and the flagship's
# lane-fused table with its update's ids (B = 8192 rows x K = 64 slots)
TABLES = {"probe": (10_000_000, 64, 4096 * 60, "uniform"),
          "flagship": (10_000_000, 128, 8192 * 64, "uniform"),
          "flagship_zipf": (10_000_000, 128, 8192 * 64, "zipf")}
ITERS, WARMUP = 10, 1  # a timed chain: calls in a row, after the warm ones
PLAIN_ITERS = 2  # the plain versions, slower by far


def cuda_ms(fn, iters: int = ITERS) -> float:
    return cuda_time_ms(fn, iters, WARMUP)


def _rate(n_bytes: float, ms: float) -> dict:
    return dict(bytes=n_bytes, ms=ms, gb_per_s=n_bytes / ms / 1e6,
                peak_share=n_bytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3)


def zipf_ids(rng, V: int, N: int) -> np.ndarray:
    """N ids over V rows at zipf:1.0, as ``bench.py`` draws them: ranks
    from the truncated-Pareto inverse CDF, shuffled by a multiplicative
    hash so that the hot ids are not the low rows."""
    ranks = np.minimum(np.exp(rng.random(N) * np.log(float(V))).astype(np.int64), V - 1)
    return (ranks * 2654435761) % V


def make_inputs(V: int, D: int, N: int, kind: str, device):
    """The table (V, D) bf16 ~ N(0, 0.01^2) from a seeded generator on the
    card; N sorted ids, uniform in [1, V) as the JAX probe draws them or
    ``zipf_ids``, then N (N, D) deltas ~ N(0, 1e-3^2), both from
    ``default_rng(0)``, the deltas in bf16.  -> (table, ids int64, deltas
    bf16)."""
    g = torch.Generator(device=device).manual_seed(0)
    table = (torch.randn(V, D, generator=g, device=device) * 0.01).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    draw = {"uniform": lambda: rng.integers(1, V, N), "zipf": lambda: zipf_ids(rng, V, N)}[kind]
    ids = np.sort(draw().astype(np.int32))
    delta = rng.normal(0, 1e-3, (N, D)).astype(np.float32)
    return (table, torch.from_numpy(ids).to(device, torch.int64),
            torch.from_numpy(delta).to(device).to(torch.bfloat16))


def _block_bytes(table, W, blocks) -> int:
    """Bytes in the distinct listed (16, W) blocks of ``table``, the
    partial last block at its size."""
    size = BLOCK_ROWS * W
    u = torch.unique(blocks.long())
    full = table.numel() // size
    n = int((u < full).sum()) * size
    if bool((u == full).any()):
        n += table.numel() - full * size
    return n * table.element_size()


def check_dense(table, W) -> None:
    got, want = table.clone(), table.clone()
    dense_sweep(got, W)
    dense_sweep_reference(want, W)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dense_sweep W={W} differs from its plain version")


def check_sparse(table, W, blocks) -> None:
    got, want = table.clone(), table.clone()
    sparse_sweep(got, W, blocks)
    sparse_sweep_reference(want, W, blocks)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"sparse_sweep W={W} differs from its plain version (which adds "
                             f"once to each distinct block)")
    size, n = BLOCK_ROWS * W, n_blocks(table, W)
    full = table.numel() // size
    listed = torch.zeros(n, dtype=torch.bool, device=table.device)
    listed[blocks.long()] = True
    g, t = got.view(-1), table.view(-1)
    same = torch.equal(*(x[:full * size].view(full, size)[~listed[:full]] for x in (g, t)))
    if full < n and not bool(listed[full]):  # the partial last block
        same = same and torch.equal(g[full * size:], t[full * size:])
    if not same:
        raise AssertionError(f"sparse_sweep W={W} changed an untouched block")


def check_sweep_rows_add(table, ids, delta) -> None:
    got, want = table.clone(), table.clone()
    sweep_rows_add([got], ids, [delta])
    sweep_rows_add_reference([want], ids, [delta])
    torch.cuda.synchronize()
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    touched[ids] = True
    if not torch.equal(got[~touched], table[~touched]):
        raise AssertionError("sweep_rows_add changed an untouched row")
    g, w = got[touched].float(), want[touched].float()
    excess = (g - w).abs() - (2.0 ** -7 * torch.maximum(g.abs(), w.abs())
                              + 1e-5 * float(w.abs().max()))
    if float(excess.max()) > 0:
        raise AssertionError("sweep_rows_add beyond one bf16 ulp of its plain version")


def check_table(table, ids, delta) -> None:
    """Each kernel of the probe against its plain version on copies of
    ``table``: the sweeps at every W on the ids' blocks, and the row
    update."""
    V, D = table.shape
    for W in WIDTHS:
        check_dense(table, W)
        check_sparse(table, W, touched_superblocks(ids, V, D, W))
    check_sweep_rows_add(table, ids, delta)


def _update_bytes(table, ids, delta) -> tuple:
    """-> (bytes a row update must move: the ids and deltas read once, each
    touched row read and written once; the touched rows)."""
    n_unique = int(torch.unique(ids).numel())
    return (ids.numel() * ids.element_size() + delta.numel() * delta.element_size()
            + 2 * n_unique * table.shape[1] * table.element_size()), n_unique


def probe_index_add(table, ids, delta) -> dict:
    """A: ``index_add_`` of the bf16 deltas, in place, chained."""
    n_bytes, n_unique = _update_bytes(table, ids, delta)
    ms = cuda_ms(lambda: table.index_add_(0, ids, delta))
    return dict(probe="A", name="index_add_", unique_rows=n_unique, **_rate(n_bytes, ms))


def probe_dense_sweep(table, W: int) -> dict:
    """B: the dense sweep at width W, in place, chained; with
    ``Tensor.add_`` of the marker (the same function in one PyTorch call)
    and the plain version timed beside it."""
    flat, c = table.view(-1), marker()
    n_bytes = 2 * table.numel() * table.element_size()
    rec = dict(probe="B", name="dense_sweep", W=W, blocks=n_blocks(table, W),
               rows_per_block=BLOCK_ROWS * W // table.shape[1],
               **_rate(n_bytes, cuda_ms(lambda: dense_sweep(table, W))))
    rec["plain_ms"] = cuda_ms(lambda: dense_sweep_reference(table, W), PLAIN_ITERS)
    rec["library_ms"] = cuda_ms(lambda: flat.add_(c))
    rec["library_call"] = "Tensor.add_ of the marker over the whole table"
    return rec


def probe_sparse(table, W: int, ids) -> dict:
    """C: the sparse sweep at width W over the blocks the ids touch, in
    place, chained (the wrapper checks the list's order in the warm call);
    with the list's own time (``touched_superblocks`` on the card),
    ``index_add_`` of marker rows over the distinct full blocks (the same
    function in one PyTorch call, given the distinct list) and the plain
    version."""
    V, D = table.shape
    blocks = touched_superblocks(ids, V, D, W)
    n_bytes = 2 * _block_bytes(table, W, blocks)
    distinct = torch.unique(blocks.long())
    rec = dict(probe="C", name="sparse_sweep", W=W, rows_per_block=BLOCK_ROWS * W // D,
               touched_blocks=int(distinct.numel()), blocks=n_blocks(table, W),
               grid=int(blocks.numel()),
               **_rate(n_bytes, cuda_ms(lambda: sparse_sweep(table, W, blocks))))
    rec["list_ms"] = cuda_ms(lambda: touched_superblocks(ids, V, D, W))
    rec["plain_ms"] = cuda_ms(lambda: sparse_sweep_reference(table, W, blocks), PLAIN_ITERS)
    size = BLOCK_ROWS * W
    full = table.numel() // size
    distinct = distinct[distinct < full]
    view = table.view(-1)[:full * size].view(full, size)
    src = torch.full((distinct.numel(), size), marker(), dtype=table.dtype, device=table.device)
    rec["library_ms"] = cuda_ms(lambda: view.index_add_(0, distinct, src))
    rec["library_call"] = ("Tensor.index_add_ of marker rows over the distinct full blocks "
                           "(blocks, 16*W) view")
    del src
    return rec


def probe_sweep_rows_add(table, ids, delta) -> dict:
    """D: ``sweep_rows_add`` of the deltas at the ids, in place, chained
    (the wrapper's sort and pack included)."""
    n_bytes, n_unique = _update_bytes(table, ids, delta)
    ms = cuda_ms(lambda: sweep_rows_add([table], ids, [delta]))
    return dict(probe="D", name="sweep_rows_add", unique_rows=n_unique, **_rate(n_bytes, ms))


def _line(tag, r) -> str:
    what = {"A": f"index_add_ {r.get('unique_rows')} unique rows",
            "B": f"dense sweep W={r.get('W')} ({r.get('blocks')} blocks of "
                 f"{r.get('rows_per_block')} rows)",
            "C": f"sparse sweep W={r.get('W')} ({r.get('touched_blocks')} of {r.get('blocks')} "
                 f"blocks touched, {r.get('rows_per_block')} rows a block, grid "
                 f"{r.get('grid')})",
            "D": f"sweep_rows_add {r.get('unique_rows')} unique rows"}[r["probe"]]
    extra = "".join(f", {k} {r[k]:.4f} ms" for k in ("list_ms", "plain_ms", "library_ms")
                    if k in r)
    return (f"[scatter probe] {tag} {r['probe']}. {what}: {r['ms']:.4f} ms, "
            f"{r['gb_per_s']:.1f} GB/s moved ({r['peak_share']:.1%} of 3.35 TB/s; bound "
            f"{r['bound_ms']:.4f} ms){extra}")


def run_table(tag: str, device, check: bool = True) -> list:
    """A, B, C and D on the table ``TABLES[tag]``, after ``check_table``
    unless ``check`` is off -> the records."""
    V, D, N, kind = TABLES[tag]
    t0 = time.time()
    table, ids, delta = make_inputs(V, D, N, kind, device)
    torch.cuda.synchronize()
    log(f"[scatter probe] {tag}: table ({V}, {D}) bf16, {N} sorted {kind} ids, set-up "
        f"{time.time() - t0:.1f} s")
    if check:
        check_table(table, ids, delta)
    recs = [probe_index_add(table, ids, delta)]
    recs += [probe_dense_sweep(table, W) for W in WIDTHS]
    recs += [probe_sparse(table, W, ids) for W in WIDTHS]
    recs.append(probe_sweep_rows_add(table, ids, delta))
    for r in recs:
        r.update(table=tag, V=V, D=D, N=N, ids=kind)
        log(_line(tag, r))
    if check:
        log(f"[scatter probe] {tag}: B and C bit-equal to their plain versions (C: untouched "
            f"blocks unchanged, padding repeats added nothing); D within one bf16 ulp, "
            f"untouched rows unchanged")
    del table, ids, delta
    torch.cuda.empty_cache()
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    log(f"[scatter probe] device {torch.cuda.get_device_name(0)}")
    recs = []
    for tag in TABLES:
        recs += run_table(tag, dev)
    log(json.dumps({"scatter_probe": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
