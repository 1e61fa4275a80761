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
``pallas_call``: it maps out-of-range ids to the sentinel V and sorts the
ids once (stable, ``sort_ids``), and finds with ``torch.searchsorted``
the end of the run of equal ids at the end of each piece of sorted
positions the kernel's warps walk (``piece_ends``).  The deltas go to the
kernel as the caller made them, (N, D) contiguous, fp32 or the table
dtype: the kernel reads each through the sort's permutation and casts it
itself (``launch_sorted``), so the CUDA path never writes a sorted or
cast copy of them.
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


def _sorted_ids(ids, V):
    """-> (ids (N,) int32 sorted stably, out-of-range ones as V; the sort's
    permutation (N,) int64)."""
    ids = ids.reshape(-1).to(torch.int32)
    # -1 and V both become V: (-1) mod (V + 1) == V
    return torch.sort(ids.clamp(-1, V).remainder(V + 1), stable=True)


def _sorted_updates(tables, ids, deltas, V, D, N):
    """-> (``_sorted_ids``' ids; the deltas cast to the table dtype, packed
    (N, n_tables * D) in that order)."""
    ids_s, order = _sorted_ids(ids, V)
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


def sort_ids(ids: torch.Tensor, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sorted ids: -> (ids (N,) int32 sorted stably,
    out-of-range ones as V; ``order`` (N,) int32, sorted position i holding
    the caller's id ``order[i]``)."""
    ids_s, order = _sorted_ids(ids, V)
    return ids_s, order.to(torch.int32)


def piece_ends(ids_s: torch.Tensor) -> torch.Tensor:
    """For each piece of the kernel's walk (``tossctr_sweep_piece()`` sorted
    positions), the end of the run of equal ids that holds its last
    position -> (n_pieces,) int32."""
    piece = load_library("sweep_rows_add").tossctr_sweep_piece()
    last = ids_s[piece - 1::piece]
    if ids_s.numel() % piece:  # a partial last piece
        last = torch.cat([last, ids_s[-1:]])
    return torch.searchsorted(ids_s, last, right=True, out_int32=True)


def launch_sorted(tables, deltas, ids_s, order, seg_end, V: int, D: int) -> None:
    """The kernel on ``sort_ids``' and ``piece_ends``' outputs (N > 0): the
    deltas read where they lie, through ``order``."""
    lib = load_library("sweep_rows_add")
    n_pieces = seg_end.numel()
    dev = ids_s.device
    head, tail = (torch.empty(n_pieces, len(tables) * D, dtype=torch.float32, device=dev)
                  for _ in range(2))
    tabs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    dels = (ctypes.c_void_p * len(deltas))(*(d.data_ptr() for d in deltas))
    rc = lib.tossctr_sweep_rows_add(
        tabs, dels, len(tables), ids_s.data_ptr(), order.data_ptr(), seg_end.data_ptr(),
        head.data_ptr(), tail.data_ptr(), ids_s.numel(), V, D, DTYPE_CODES[tables[0].dtype],
        DTYPE_CODES[deltas[0].dtype], dev.index, stream_of(ids_s),
    )
    check_launch(lib, rc, "sweep_rows_add")
    sweep_rows_add.launches += 1


def _check_kernel_layout(tables, deltas, D: int) -> None:
    """Raise on what the kernel does not take: it reads four elements a lane
    from each table row and each delta row."""
    dt = tables[0].dtype
    if D % 4 or len(tables) > 8:
        raise ValueError(f"sweep_rows_add kernel takes D % 4 == 0 and at most 8 tables; "
                         f"got D={D}, {len(tables)} tables")
    ddt = deltas[0].dtype
    if ddt not in (torch.float32, dt) or any(d.dtype != ddt for d in deltas):
        raise TypeError(f"sweep_rows_add kernel takes deltas of one dtype, float32 or the "
                        f"tables' {dt}; got {[d.dtype for d in deltas]}")
    for x in (*tables, *deltas):
        if not x.is_contiguous() or x.data_ptr() % (4 * x.element_size()):
            raise ValueError("sweep_rows_add kernel takes contiguous tables and deltas "
                             "aligned to four elements")


@torch.no_grad()
def sweep_rows_add(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   deltas: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tables[t][ids] += deltas[t]`` for every table at once, in place:
    tables (V, D) of one dtype, ids (N,) int in any order (duplicates
    summed in fp32 in sorted order; out-of-range ids dropped), deltas[t]
    (N, D) cast to the table dtype before the sum.  -> the tables.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  The kernel takes the deltas contiguous, all float32 or all in
    the table dtype.  It adds without atomics: it repeats bit for bit."""
    V, D, N = _check(tables, ids, deltas)
    if ids.device.type == "cpu":
        return sweep_rows_add_reference(tables, ids, deltas)
    if ids.device.type != "cuda":
        raise RuntimeError(f"sweep_rows_add: unsupported device {ids.device}")
    _check_kernel_layout(tables, deltas, D)
    if N == 0:
        return list(tables)
    ids_s, order = sort_ids(ids, V)
    launch_sorted(tables, deltas, ids_s, order, piece_ends(ids_s), V, D)
    return list(tables)


sweep_rows_add.launches = 0
