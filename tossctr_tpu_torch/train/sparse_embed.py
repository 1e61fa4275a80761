"""Row-sparse updates of the sequence tables: row-wise AdaGrad and sparse
SGD.

Port of ``tossctr_tpu/train/sparse_embed.py``.  The train step reads the
gradient of the gathered rows of each sequence table (``models/dare.py``
taps: (B, K, 2D) of the lane-fused table, (B, K, D) of each split one),
masks the pad row's occurrences (the pad row never changes, as torch's
padding_idx), and updates the rows it touched in place, table by table:

* ``rowwise_adagrad_update(exact_dedup=True)``: sort the touched ids, sum
  duplicate rows' gradients in fp32, then one row-wise AdaGrad step a
  unique row (its per-half accumulator, lazy weight decay) written back.
  Nothing here waits on the card: the number of unique ids stays a device
  scalar, and the padding slots of the sorted order repeat the last
  unique row with the same values (the JAX version drops them with
  ``mode="drop"``), so writing them is harmless.
* ``rowwise_adagrad_update(exact_dedup=False)``, the JAX default: the
  streaming scatter path.  Each occurrence's per-half mean g^2 is
  scatter-added into the accumulator, each occurrence is scaled by its
  row's post-accumulation statistic, the decay applies per occurrence,
  and the deltas are scatter-added in the table dtype.  No sort.
* ``sparse_sgd_update``: the same scatter, without an accumulator.

The lane-fused (V, 2D) table keeps one accumulator column per D-wide
half, (V, 2), so the fused update equals updating the att and rep tables
apart; a split (V, D) table keeps a (V,) accumulator (``halves``).
The scatter-adds (``scatter_add_rows``): on the CPU duplicates add one
at a time in index order, in the destination's dtype, as XLA's scatter
adds them; on the card with ``index_add_``'s atomics, whose order varies
from run to run (PyTorch's sorted merge, ``index_put_`` with
``accumulate``, costs tens of ms a step at the flagship's shapes on an
H100: PERF.md).  An fp32 atomic add flushes a subnormal square to zero,
which leaves the AdaGrad step unchanged: eps (1e-8) dwarfs the square
root of any subnormal.  ``rowwise_adagrad_sweep_update``
(``train.table_update: sweep``; the JAX function of that name) merges
the deltas of every table touched at the same ids (the split pair's
two) with one ``ops/sweep_scatter.sweep_rows_add`` launch instead:
duplicates summed in fp32 in sorted order, each row rounded once, no
atomics; its decay always reads fresh rows of the tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import sweep_scatter

_INT64_MAX = torch.iinfo(torch.int64).max


@dataclass
class RowwiseAdagradState:
    # fp32 grad-square accumulator: (V,) for a table of one logical table,
    # (V, halves) for a table that lane-fuses ``halves`` of them
    accum: torch.Tensor


def init_rowwise_adagrad(table: torch.Tensor, halves: int = 1) -> RowwiseAdagradState:
    shape = (table.shape[0],) if halves == 1 else (table.shape[0], halves)
    return RowwiseAdagradState(torch.zeros(shape, dtype=torch.float32, device=table.device))


def _accum_2d(state: RowwiseAdagradState) -> torch.Tensor:
    """The accumulator as a (V, halves) view of its storage."""
    return state.accum.view(state.accum.shape[0], -1)


def dedup_rows(ids: torch.Tensor, grads: torch.Tensor,
               drop_index: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort + segment-sum duplicates.  ids (N,), grads (N, W) ->
    (uids (N,) int64, g (N, W) fp32, n_unique device scalar): the first
    ``n_unique`` slots hold the unique ids ascending and their summed
    gradients; padding slots carry ``drop_index + k`` and zero gradients
    (the JAX ``dedup_rows``)."""
    n = ids.shape[0]
    ids = ids.long()
    ids_s, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first.long(), 0) - 1  # ascending segment ids
    g_uniq = torch.zeros(n, grads.shape[1], dtype=torch.float32, device=grads.device)
    g_uniq.index_add_(0, seg, grads[order].float())
    # the j-th unique id is the j-th smallest: one sort compacts them
    uid = torch.sort(torch.where(first, ids_s, torch.full_like(ids_s, _INT64_MAX))).values
    n_unique = first.sum()
    k = torch.arange(n, device=ids.device)
    return torch.where(k < n_unique, uid, drop_index + k), g_uniq, n_unique


def scatter_add_rows(dst: torch.Tensor, ids: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[ids] += src`` in ``dst``'s dtype, in place, duplicate ids
    summed (module docstring)."""
    if dst.device.type == "cpu":
        dst.index_put_((ids,), src.to(dst.dtype), accumulate=True)
    else:
        dst.index_add_(0, ids, src.to(dst.dtype))


def _decay_rows(table, ids, mask, rows):
    """The fp32 rows the lazy weight decay multiplies: the forward rows when
    given (pad-masked already), else a fresh gather, pad-masked."""
    if rows is not None:
        return rows.float().reshape(ids.numel(), -1)
    return table[ids].float() * mask


@torch.no_grad()
def rowwise_adagrad_update(table: torch.Tensor, state: RowwiseAdagradState, ids: torch.Tensor,
                           row_grads: torch.Tensor, *, lr: float, pad_row: int,
                           eps: float = 1e-8, weight_decay: float = 0.0,
                           exact_dedup: bool = True,
                           rows: Optional[torch.Tensor] = None) -> RowwiseAdagradState:
    """One row-wise AdaGrad step on ``table`` (V, W), in place.  ids (...,)
    int and row_grads (..., W): the per-occurrence gradients of the
    gathered rows, duplicates allowed.  ``pad_row`` (the sequence pad id)
    never changes, as torch's padding_idx.  The table holds as many
    W/halves-wide logical tables as ``state``'s accumulator has columns
    ((V,): one), each with its own second moment.

    ``exact_dedup``: sum each row's duplicates first, then one step a row
    (textbook AdaGrad); else the streaming scatter path (module
    docstring), which scales each occurrence by the row's shared
    post-accumulation statistic and equals the exact step for a row that
    occurs once.  ``rows``: the table's rows at ``ids`` as the forward
    gathered them (pad-masked), reused by the streaming path's weight
    decay instead of a second gather.  The streaming path with the rows
    merged by ``sweep_rows_add`` is ``rowwise_adagrad_sweep_update``."""
    V, W = table.shape
    acc = _accum_2d(state)
    Dh = W // acc.shape[1]
    g = row_grads.reshape(-1, W)
    ids = ids.reshape(-1)
    g = g * (ids != pad_row)[:, None].to(g.dtype)
    if not exact_dedup:
        delta = _streaming_delta(table, acc, ids.long(), g.float(), lr=lr, pad_row=pad_row,
                                 eps=eps, weight_decay=weight_decay, rows=rows)
        scatter_add_rows(table, ids.long(), delta)
        return state
    uids, gu, n_unique = dedup_rows(ids, g, drop_index=V)
    # padding slots repeat the last unique slot, so their writes are
    # copies of its values
    slot = torch.minimum(torch.arange(uids.shape[0], device=uids.device), n_unique - 1)
    uids, gu = uids[slot], gu[slot]
    # the mean square of each half, and each half's step size widened to its lanes
    acc_new = acc[uids] + (gu * gu).reshape(-1, acc.shape[1], Dh).mean(dim=2)
    scale = (lr / (torch.sqrt(acc_new) + eps)).repeat_interleave(Dh, dim=1)
    rows = table[uids].float()
    decay = 1.0 - lr * weight_decay * (uids != pad_row)[:, None].float()
    new_rows = rows * decay - scale * gu
    table.index_copy_(0, uids, new_rows.to(table.dtype))
    acc.index_copy_(0, uids, acc_new)
    return state


def _streaming_delta(table, acc, ids, g, *, lr, pad_row, eps, weight_decay, rows):
    """The no-sort path of ``rowwise_adagrad_update`` up to the row merge:
    ids (N,) int64, g (N, W) fp32 pad-masked; adds each occurrence's
    per-half mean square into ``acc`` (V, halves) -> the deltas (N, W)
    fp32 to add to the table's rows."""
    V, W = table.shape
    Dh = W // acc.shape[1]
    # each half's mean square, as the sum of its lanes over Dh
    scatter_add_rows(acc, ids, (g * g).reshape(-1, acc.shape[1], Dh).sum(dim=2) / Dh)
    scale = (lr / (torch.sqrt(acc[ids]) + eps)).repeat_interleave(Dh, dim=1)
    delta = -scale * g
    if weight_decay:
        mask = (ids != pad_row)[:, None].float()
        delta = delta - (lr * weight_decay) * _decay_rows(table, ids, mask, rows)
    return delta


@torch.no_grad()
def rowwise_adagrad_sweep_update(tables: Sequence[torch.Tensor],
                                 states: Sequence[RowwiseAdagradState], ids: torch.Tensor,
                                 row_grads: Sequence[torch.Tensor], *, lr: float, pad_row: int,
                                 eps: float = 1e-8, weight_decay: float = 0.0) -> List:
    """The streaming row-wise AdaGrad step (``exact_dedup=False``) on
    several tables of one shape touched at the same ids (the split att /
    rep pair, or the one lane-fused table), in place, the rows of all of
    them merged by ONE ``sweep_rows_add`` launch: the JAX
    ``rowwise_adagrad_sweep_update``.  Per table as
    ``rowwise_adagrad_update``'s streaming path, the decay on fresh rows.
    -> the states."""
    ids = ids.reshape(-1).long()
    mask = (ids != pad_row)[:, None]
    deltas = []
    for table, state, g in zip(tables, states, row_grads):
        g = g.float().reshape(ids.numel(), table.shape[1]) * mask
        deltas.append(_streaming_delta(table, _accum_2d(state), ids, g, lr=lr, pad_row=pad_row,
                                       eps=eps, weight_decay=weight_decay, rows=None))
    sweep_scatter.sweep_rows_add(list(tables), ids, deltas)
    return list(states)


@torch.no_grad()
def sparse_sgd_update(table: torch.Tensor, ids: torch.Tensor, row_grads: torch.Tensor, *,
                      lr: float, pad_row: int, weight_decay: float = 0.0,
                      rows: Optional[torch.Tensor] = None) -> None:
    """Plain sparse SGD on ``table`` (V, W), in place: the pad-masked
    per-occurrence gradients (plus the lazy decay, from ``rows`` when
    given, as ``rowwise_adagrad_update``'s) times -lr, scatter-added in the
    table dtype; duplicates add up in the scatter."""
    V, W = table.shape
    ids = ids.reshape(-1).long()
    mask = (ids != pad_row)[:, None].float()
    g = row_grads.float().reshape(-1, W) * mask
    if weight_decay:
        g = g + weight_decay * _decay_rows(table, ids, mask, rows)
    scatter_add_rows(table, ids, -lr * g)
