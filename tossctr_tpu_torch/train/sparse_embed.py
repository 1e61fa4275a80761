"""Row-sparse updates of the sequence table: row-wise AdaGrad and sparse
SGD.

Port of ``tossctr_tpu/train/sparse_embed.py``.  The train step reads the
gradient of the gathered (B, K, 2D) rows (``models/dare.py`` taps), masks
the pad row's occurrences (the pad row never changes, as torch's
padding_idx), and updates the rows it touched in place:

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
half, so the fused update equals updating the att and rep tables apart.
The scatter-adds (``scatter_add_rows``): on the CPU duplicates add one
at a time in index order, in the destination's dtype, as XLA's scatter
adds them; on the card with ``index_add_``'s atomics, whose order varies
from run to run (PyTorch's sorted merge, ``index_put_`` with
``accumulate``, costs tens of ms a step at the flagship's shapes on an
H100: PERF.md).  An fp32 atomic add flushes a subnormal square to zero,
which leaves the AdaGrad step unchanged: eps (1e-8) dwarfs the square
root of any subnormal.  ``sweep=True`` (``train.table_update: sweep``)
merges the deltas with ``ops/sweep_scatter.sweep_rows_add`` instead:
duplicates summed in fp32 in sorted order, each row rounded once, no
atomics; its decay always reads fresh rows of the table, as the JAX
``rowwise_adagrad_sweep_update`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops import sweep_scatter

_INT64_MAX = torch.iinfo(torch.int64).max
HALVES = 2  # the att and rep halves of the lane-fused table


@dataclass
class RowwiseAdagradState:
    accum: torch.Tensor  # (V, 2) fp32 grad-square accumulator, one column a half


def init_rowwise_adagrad(table: torch.Tensor) -> RowwiseAdagradState:
    return RowwiseAdagradState(torch.zeros(table.shape[0], HALVES, dtype=torch.float32,
                                           device=table.device))


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
                           rows: Optional[torch.Tensor] = None,
                           sweep: bool = False) -> RowwiseAdagradState:
    """One row-wise AdaGrad step on ``table`` (V, W), in place.  ids (...,)
    int and row_grads (..., W): the per-occurrence gradients of the
    gathered rows, duplicates allowed.  ``pad_row`` (the sequence pad id)
    never changes, as torch's padding_idx.

    ``exact_dedup``: sum each row's duplicates first, then one step a row
    (textbook AdaGrad); else the streaming scatter path (module
    docstring), which scales each occurrence by the row's shared
    post-accumulation statistic and equals the exact step for a row that
    occurs once.  ``rows``: the table's rows at ``ids`` as the forward
    gathered them (pad-masked), reused by the streaming path's weight
    decay instead of a second gather.  ``sweep``: the streaming path with
    the rows merged by ``sweep_rows_add`` (module docstring); it takes no
    ``rows`` and no ``exact_dedup``."""
    if sweep and (exact_dedup or rows is not None):
        raise ValueError("the sweep update is the streaming path: exact_dedup=False, no rows")
    V, W = table.shape
    g = row_grads.reshape(-1, W)
    ids = ids.reshape(-1)
    g = g * (ids != pad_row)[:, None].to(g.dtype)
    if not exact_dedup:
        row_add = _sweep_add if sweep else scatter_add_rows
        return _streaming_adagrad(table, state, ids.long(), g.float(), lr=lr, pad_row=pad_row,
                                  eps=eps, weight_decay=weight_decay, rows=rows,
                                  row_add=row_add)
    uids, gu, n_unique = dedup_rows(ids, g, drop_index=V)
    # padding slots repeat the last unique slot, so their writes are
    # copies of its values
    slot = torch.minimum(torch.arange(uids.shape[0], device=uids.device), n_unique - 1)
    uids, gu = uids[slot], gu[slot]
    # the mean square of each half, and each half's step size widened to its lanes
    acc_new = state.accum[uids] + (gu * gu).reshape(-1, HALVES, W // HALVES).mean(dim=2)
    scale = (lr / (torch.sqrt(acc_new) + eps)).repeat_interleave(W // HALVES, dim=1)
    rows = table[uids].float()
    decay = 1.0 - lr * weight_decay * (uids != pad_row)[:, None].float()
    new_rows = rows * decay - scale * gu
    table.index_copy_(0, uids, new_rows.to(table.dtype))
    state.accum.index_copy_(0, uids, acc_new)
    return state


def _sweep_add(table, ids, delta):
    sweep_scatter.sweep_rows_add([table], ids, [delta])


def _streaming_adagrad(table, state, ids, g, *, lr, pad_row, eps, weight_decay, rows, row_add):
    """The no-sort path of ``rowwise_adagrad_update``: ids (N,) int64, g (N,
    W) fp32 pad-masked; ``row_add(table, ids, delta)`` adds the deltas."""
    V, W = table.shape
    Dh = W // HALVES
    # each half's mean square, as the sum of its lanes over Dh
    scatter_add_rows(state.accum, ids, (g * g).reshape(-1, HALVES, Dh).sum(dim=2) / Dh)
    scale = (lr / (torch.sqrt(state.accum[ids]) + eps)).repeat_interleave(Dh, dim=1)
    delta = -scale * g
    if weight_decay:
        mask = (ids != pad_row)[:, None].float()
        delta = delta - (lr * weight_decay) * _decay_rows(table, ids, mask, rows)
    row_add(table, ids, delta)
    return state


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
