"""Row updates of the sequence table by a sorted merge: ``sweep_rows_add``.

Port of ``tossctr_tpu/ops/pallas_scatter.py``'s ``sweep_rows_add``:
``tables[t][ids] += deltas[t]`` for every table at once, in place;
kernel ``csrc/sweep_rows_add.cu``, plain version
``sweep_rows_add_reference``.  Duplicate ids are summed in fp32 in
sorted order, the deltas are cast to the table dtype first, each touched
row is rounded once, and out-of-range ids are dropped.  The row-wise
AdaGrad step built on it (``train.table_update: sweep``) is
``train/sparse_embed.rowwise_adagrad_update(sweep=True)``.

The wrapper does outside the kernel what the JAX wrapper does outside its
``pallas_call``: it maps out-of-range ids to the sentinel V, sorts the ids
once (stable), packs the deltas cast to the table dtype in sorted order,
and finds with ``torch.searchsorted`` the end of the run of equal ids at
the end of each piece of sorted positions the kernel's warps walk.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ._build import DTYPE_CODES, check_launch, load_library, stream_of


def _check(tables, ids, deltas) -> Tuple[int, int, int]:
    if not tables or len(tables) != len(deltas):
        raise ValueError(f"need one delta a table, got {len(tables)} tables, "
                         f"{len(deltas)} deltas")
    V, D = tables[0].shape
    N = ids.numel()
    for t in tables:
        if tuple(t.shape) != (V, D) or t.dtype != tables[0].dtype or t.device != ids.device:
            raise ValueError("the tables must share one (V, D) shape, dtype and the ids' device")
    if tables[0].dtype not in DTYPE_CODES:
        raise TypeError(f"table dtype must be float32 or bfloat16, got {tables[0].dtype}")
    for d in deltas:
        if d.numel() != N * D or d.shape[-1] != D or d.device != ids.device:
            raise ValueError(f"each delta must be ({N}, {D}) on {ids.device}, got "
                             f"{tuple(d.shape)} on {d.device}")
    return V, D, N


def _sorted_updates(tables, ids, deltas, V, D, N):
    """-> (ids (N,) int32 sorted, out-of-range ones as V; the deltas cast to
    the table dtype, packed (N, n_tables * D) in that order)."""
    ids = ids.reshape(-1).to(torch.int32)
    ids = torch.where((ids >= 0) & (ids < V), ids, torch.full_like(ids, V))
    ids_s, order = torch.sort(ids, stable=True)
    packed = torch.cat([d.reshape(N, D).to(tables[0].dtype) for d in deltas], dim=1)
    return ids_s, packed.index_select(0, order)


@torch.no_grad()
def sweep_rows_add_reference(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                             deltas: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain version of ``sweep_rows_add``, in place: the sorted deltas
    in the table dtype, each touched row's duplicates summed in fp32 in
    sorted order (``index_put_`` with ``accumulate``, which merges the runs
    of equal ids without atomics on the card), the row rounded once from
    fp32."""
    V, D, N = _check(tables, ids, deltas)
    ids_s, packed = _sorted_updates(tables, ids, deltas, V, D, N)
    keep = ids_s < V
    uids, inv = torch.unique_consecutive(ids_s[keep].long(), return_inverse=True)
    sums = torch.zeros(uids.numel(), packed.shape[1], dtype=torch.float32, device=ids.device)
    sums.index_put_((inv,), packed[keep].float(), accumulate=True)
    for t, table in enumerate(tables):
        new = table[uids].float() + sums[:, t * D:(t + 1) * D]
        table.index_copy_(0, uids, new.to(table.dtype))
    return list(tables)


@torch.no_grad()
def sweep_rows_add(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   deltas: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tables[t][ids] += deltas[t]`` for every table at once, in place:
    tables (V, D) of one dtype, ids (N,) int in any order (duplicates
    summed in fp32 in sorted order; out-of-range ids dropped), deltas[t]
    (N, D) cast to the table dtype before the sum.  -> the tables.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  The kernel adds without atomics: it repeats bit for bit."""
    V, D, N = _check(tables, ids, deltas)
    if ids.device.type == "cpu":
        return sweep_rows_add_reference(tables, ids, deltas)
    if ids.device.type != "cuda":
        raise RuntimeError(f"sweep_rows_add: unsupported device {ids.device}")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError("sweep_rows_add: the tables must be contiguous")
    if D % 4 or len(tables) > 8:
        raise ValueError(f"sweep_rows_add kernel takes D % 4 == 0 and at most 8 tables; "
                         f"got D={D}, {len(tables)} tables")
    if N == 0:
        return list(tables)
    lib = load_library("sweep_rows_add")
    ids_s, packed = _sorted_updates(tables, ids, deltas, V, D, N)
    piece = lib.tossctr_sweep_piece()
    n_pieces = -(-N // piece)
    last = torch.clamp(torch.arange(1, n_pieces + 1, device=ids.device) * piece - 1, max=N - 1)
    seg_end = torch.searchsorted(ids_s, ids_s[last], right=True).to(torch.int32)
    head, tail = (torch.empty(n_pieces, packed.shape[1], dtype=torch.float32, device=ids.device)
                  for _ in range(2))
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    rc = lib.tossctr_sweep_rows_add(
        ptrs, len(tables), ids_s.data_ptr(), packed.data_ptr(), seg_end.data_ptr(),
        head.data_ptr(), tail.data_ptr(), N, V, D, DTYPE_CODES[tables[0].dtype],
        ids.device.index, stream_of(ids),
    )
    check_launch(lib, rc, "sweep_rows_add")
    sweep_rows_add.launches += 1
    return list(tables)


sweep_rows_add.launches = 0
