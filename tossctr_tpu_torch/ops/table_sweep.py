"""The scatter probe's in-place sweeps of a bf16 table: a constant added
to every (16, W) block (``dense_sweep``) or to the blocks a list names
(``sparse_sweep``).

Port of the two Pallas kernels of ``exp/scatter_probe.py``:
``_sweep_kernel`` in ``probe_dense_sweep`` and ``_sparse_kernel`` in
``probe_sparse``; kernel ``csrc/table_sweep.cu``, plain versions
``dense_sweep_reference`` / ``sparse_sweep_reference``.  They measure how
fast the card can read, modify and write the embedding table
(``tossctr_tpu_torch/exp/scatter_probe.py``), beside ``sweep_rows_add``
and ``Tensor.index_add_``; nothing on the training path calls them.

The (V, D) table is viewed as (V*D/W, W) and cut into blocks of 16 such
rows, 16*W consecutive elements; where V*D is not a multiple of 16*W the
last block is partial.  A swept element x becomes bf16(x + c), c the
probe's marker 0.001 rounded to bf16.  A block of the table holds
``superblock_rows(W, D)`` = 16*W/D table rows, so the blocks a batch of
ids touches are ``touched_superblocks(ids, ...)``: the probe's list,
padded with repeats of its last block, which the sparse sweep skips.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library, stream_of

BLOCK_ROWS = 16  # rows of W elements a block: the probe's BlockSpec (16, W)
MARKER = 0.001  # the probe's constant


def marker() -> float:
    """The probe's marker 0.001 rounded to bf16, as the fp32 value both the
    kernel and the plain version add."""
    return float(torch.tensor(MARKER, dtype=torch.bfloat16))


def superblock_rows(W: int, D: int) -> int:
    """Table rows of D elements in one (16, W) block."""
    if (BLOCK_ROWS * W) % D:
        raise ValueError(f"a (16, {W}) block must hold whole rows of D={D}")
    return BLOCK_ROWS * W // D


def n_blocks(table: torch.Tensor, W: int) -> int:
    """The table's (16, W) blocks, a partial last one included."""
    return -(-table.numel() // (BLOCK_ROWS * W))


def touched_superblocks(ids: torch.Tensor, V: int, D: int, W: int) -> torch.Tensor:
    """The (16, W) blocks that hold the rows ``ids`` of a (V, D) table, as
    ``probe_sparse`` lists them: ``unique(ids // (16*W/D))`` ascending,
    padded to ``min(blocks, len(ids))`` entries with repeats of the last ->
    int32 on ids' device (empty for no ids)."""
    rows = superblock_rows(W, D)
    sb = torch.unique(ids.reshape(-1).long() // rows)
    cap = min(-(-V // rows), ids.numel())
    out = torch.empty(cap, dtype=torch.int32, device=ids.device)
    if cap:
        out.fill_(int(sb[-1]))
        out[:sb.numel()] = sb.to(torch.int32)
    return out


def _check(table: torch.Tensor, W: int) -> None:
    if table.dim() != 2 or table.dtype != torch.bfloat16:
        raise TypeError(f"the table must be (V, D) bfloat16, got {tuple(table.shape)} "
                        f"{table.dtype}")
    if W < 1:
        raise ValueError(f"W must be positive, got {W}")


def _check_ascending(blocks: torch.Tensor) -> None:
    """Raise unless ``blocks`` is ascending.  The check is one reduction
    and one wait for the card, so a list found ascending is marked with its
    version counter (which every in-place change bumps) and not checked
    again until it changes: the probe sweeps one list many times."""
    if getattr(blocks, "_ascending_at", None) == blocks._version:
        return
    if bool((blocks[1:] < blocks[:-1]).any()):
        raise ValueError("sparse_sweep: the block list must be ascending")
    blocks._ascending_at = blocks._version


def _add(x: torch.Tensor) -> torch.Tensor:
    return (x.float() + marker()).to(x.dtype)


@torch.no_grad()
def dense_sweep_reference(table: torch.Tensor, W: int):
    """The plain version of ``dense_sweep``: every element += ``marker()``,
    rounded to bf16, in place.  -> the table."""
    _check(table, W)
    flat = table.view(-1)
    flat.copy_(_add(flat))
    return table


@torch.no_grad()
def sparse_sweep_reference(table: torch.Tensor, W: int, blocks: torch.Tensor):
    """The plain version of ``sparse_sweep``: each distinct block of the
    ascending list ``blocks`` inside the table, once, += ``marker()``, in
    place.  -> the table."""
    _check(table, W)
    _check_ascending(blocks)
    flat, size, n = table.view(-1), BLOCK_ROWS * W, n_blocks(table, W)
    ids = torch.unique(blocks.long())
    ids = ids[(ids >= 0) & (ids < n)]
    full = flat.numel() // size
    whole = ids[ids < full]
    if whole.numel():
        view = flat[:full * size].view(full, size)
        view.index_copy_(0, whole, _add(view.index_select(0, whole)))
    if full < n and bool((ids == full).any()):  # the partial last block
        flat[full * size:] = _add(flat[full * size:])
    return table


def _launch(table, W, blocks):
    if table.device.type != "cuda":
        raise RuntimeError(f"table_sweep: unsupported device {table.device}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table_sweep: the table must be contiguous and 16-byte aligned")
    lib = load_library("table_sweep")
    ptr, n_ids = None, 0
    if blocks is not None:
        if blocks.dtype != torch.int32 or blocks.device != table.device or blocks.dim() != 1:
            raise ValueError("table_sweep: the block list must be 1-D int32 on the table's "
                             "device")
        blocks = blocks.contiguous()
        ptr, n_ids = blocks.data_ptr(), blocks.numel()
    rc = lib.tossctr_table_sweep(table.data_ptr(), table.numel(), W, marker(), ptr, n_ids,
                                 table.device.index, stream_of(table))
    check_launch(lib, rc, "table_sweep")


@torch.no_grad()
def dense_sweep(table: torch.Tensor, W: int):
    """Every (16, W) block of the bf16 table += the probe's marker, in
    place.  -> the table.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    _check(table, W)
    if table.device.type == "cpu":
        return dense_sweep_reference(table, W)
    _launch(table, W, None)
    dense_sweep.launches += 1
    return table


@torch.no_grad()
def sparse_sweep(table: torch.Tensor, W: int, blocks: torch.Tensor):
    """The (16, W) blocks of the bf16 table that the ascending int32 list
    ``blocks`` names += the probe's marker, in place; an entry equal to its
    predecessor is skipped (the padding of ``touched_superblocks``), and so
    is one outside the table.  -> the table.  A list that is not ascending
    raises, as in the plain version: the kernel skips a repeat only next to
    its predecessor, and two equal entries apart would sweep one block
    twice at once.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    _check(table, W)
    if table.device.type == "cpu":
        return sparse_sweep_reference(table, W, blocks)
    _check_ascending(blocks)
    if blocks.numel() == 0:
        return table
    _launch(table, W, blocks)
    sparse_sweep.launches += 1
    return table


dense_sweep.launches = 0
sparse_sweep.launches = 0
