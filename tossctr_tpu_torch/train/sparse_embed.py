"""Row-sparse AdaGrad for the sequence table.

Port of ``tossctr_tpu/train/sparse_embed.py``, its ``exact_dedup=True``
path: the train step reads the gradient of the gathered (B, K, 2D) rows
(``models/dare.py`` taps), and this module

  1. masks the pad row's occurrences,
  2. sorts the touched ids and sums duplicate rows' gradients in fp32,
  3. gathers each unique row and its per-half second-moment accumulator,
  4. applies one row-wise AdaGrad step with lazy weight decay (the pad
     row never decays),
  5. writes the rows and accumulators back in place.

The lane-fused (V, 2D) table keeps one accumulator column per D-wide
half, so the fused update equals updating the att and rep tables apart.
Nothing here waits on the card: the number of unique ids stays a device
scalar, and the padding slots of the sorted order repeat the last unique
row with the same values (the JAX version drops them with
``mode="drop"``), so writing them is harmless.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

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


@torch.no_grad()
def rowwise_adagrad_update(table: torch.Tensor, state: RowwiseAdagradState, ids: torch.Tensor,
                           row_grads: torch.Tensor, *, lr: float, pad_row: int,
                           eps: float = 1e-8, weight_decay: float = 0.0) -> RowwiseAdagradState:
    """One exact (deduplicated) row-wise AdaGrad step on ``table`` (V, W),
    in place.  ids (...,) int and row_grads (..., W): the per-occurrence
    gradients of the gathered rows, duplicates allowed.  ``pad_row``
    (the sequence pad id) never changes, as torch's padding_idx."""
    V, W = table.shape
    g = row_grads.reshape(-1, W)
    ids = ids.reshape(-1)
    g = g * (ids != pad_row)[:, None].to(g.dtype)
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
