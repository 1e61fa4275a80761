"""DARE top-k selection: the dense pass, the streaming (``select_chunk``)
pass and the proxy prefilter (``select_proxy``).

Port of ``tossctr_tpu/ops/topk_select.py`` (``recency_log_decay``,
``log_decay_at``, ``take_along_rows``, ``_streaming_topk_ids``,
``_proxy_topk_ids`` and ``dare_select_ids``' dispatch): every sequence
position is scored by ``<att_emb, query> + log(recency decay)`` with pads
at -1e9, and the K best positions are kept in score order.

Selection is a stable ascending sort on -score, so ties go to the
earliest position and pads come last, as with the JAX package's variadic
``lax.sort``.  ``torch.topk``'s tie order is unspecified, so the
streaming pass merges its carry and each chunk with the same stable sort
(the carry first, as the JAX merge puts it before ``lax.top_k``, which is
stable).  Every pass scores with one op form, ``torch.bmm`` of (B, n, D)
rows by the (B, D, 1) query in the compute dtype, so in fp32 on the CPU
the streaming ids are the dense ids bit for bit.  The decay is computed
in the compute dtype, as the JAX package does (``cdt = query.dtype``):
under bf16 even the positions ``arange(L)`` are rounded to bf16.  That
rounding is part of the model's behaviour and is reproduced, not
corrected.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function


def _log_decay(pos: torch.Tensor, L: int, tau: float) -> torch.Tensor:
    tau_t = torch.tensor(max(1.0, float(tau)), dtype=pos.dtype, device=pos.device)
    decay = torch.exp(-((L - 1) - pos) / tau_t)
    return torch.log(decay + 1e-8)


def recency_log_decay(L: int, tau: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """log(exp(-(L-1-pos)/tau) + 1e-8) for pos = 0..L-1, in ``dtype``."""
    return _log_decay(torch.arange(L, dtype=dtype, device=device), L, tau)


def log_decay_at(idx: torch.Tensor, L: int, tau: float, dtype=torch.float32) -> torch.Tensor:
    """recency_log_decay(L, tau)[idx], computed elementwise (same values)."""
    return _log_decay(idx.to(dtype), L, tau)


def take_along_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b, k]]`` for a (B, L) tensor and (B, K) positions."""
    return torch.gather(a, 1, idx.long())


def _score(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(B, n, D) rows . (B, D) query -> (B, n), one op form for every pass."""
    return torch.bmm(rows, query[:, :, None])[..., 0]


def _masked_rows(table: torch.Tensor, ids: torch.Tensor, pad_id: int, cdt) -> torch.Tensor:
    nonpad = (ids != pad_id)[..., None].to(cdt)
    return table[ids].to(cdt) * nonpad


def _first_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k best scores, ties to the earliest."""
    return torch.sort(-scores, dim=-1, stable=True).indices[:, :k]


def _streaming_topk_ids(table, seq_ids, query, log_decay, pad_id: int, K: int,
                        chunk: int) -> torch.Tensor:
    """Running top-K over L-chunks: only (B, chunk, D) rows are gathered at
    a time, scored, and merged into a (B, K) carry that starts at -inf
    with positions 0.  Phantom positions past L carry ``pad_id`` (so
    -1e9) and a zero decay; they sit after every real position in merge
    order, so with K <= L they are never kept."""
    B, L = seq_ids.shape
    cdt = query.dtype
    n_chunks = -(-L // chunk)
    Lp = n_chunks * chunk
    if Lp > L:
        seq_ids = torch.nn.functional.pad(seq_ids, (0, Lp - L), value=pad_id)
        log_decay = torch.nn.functional.pad(log_decay, (0, Lp - L))
    best_v = torch.full((B, K), float("-inf"), dtype=cdt, device=query.device)
    best_p = torch.zeros((B, K), dtype=torch.int64, device=query.device)
    for c0 in range(0, Lp, chunk):
        ids_c = seq_ids[:, c0:c0 + chunk]
        s = _score(_masked_rows(table, ids_c, pad_id, cdt), query)
        s = s + log_decay[c0:c0 + chunk][None, :].to(cdt)
        s = torch.where(ids_c != pad_id, s, torch.full_like(s, -1e9))
        merged_v = torch.cat([best_v, s], dim=1)
        merged_p = torch.cat([best_p, torch.arange(c0, c0 + chunk, device=query.device)
                              .expand(B, chunk)], dim=1)
        j = _first_k(merged_v, K)
        best_v, best_p = torch.gather(merged_v, 1, j), torch.gather(merged_p, 1, j)
    return best_p


def _proxy_topk_ids(table, seq_ids, query, log_decay, tau: float, pad_id: int, K: int,
                    block: int, candidates: int):
    """The hierarchical prefilter: score every position against a proxy
    table (the fp32 mean of each block of ``block`` att rows, stored in the
    table dtype, recomputed every forward; cluster(id) = min(id // block,
    C - 1)), keep the ``min(candidates, L)`` best positions, then score
    those exactly and keep the K best.  Both sorts are stable, and the
    second runs over the candidates in their stage-1 order, so at block > 1
    exact-score ties break in proxy order; at block 1 the proxy is the att
    table and the ids are the dense pass's.  -> (idx (B, K), sel_ids (B, K))."""
    B, L = seq_ids.shape
    cdt = query.dtype
    V = table.shape[0]
    C = V // block
    C2 = min(candidates, L)
    # the three parts are named for the profiler, as the dense and streaming
    # passes are (chip_smoke.py's "[select]")
    with record_function("select.proxy_build"):
        # a (C, block, D) view of the att rows (for the fused table's att half
        # the (C, block, 2D)[..., :D] view): no fp32 copy of the table
        proxy = table.unflatten(0, (C, block)).mean(dim=1, dtype=torch.float32).to(table.dtype)
    with record_function("select.proxy_stage1"):
        cl = torch.clamp(seq_ids // block, max=C - 1)
        s1 = _score(proxy[cl].to(cdt), query) + log_decay[None, :]
        s1 = torch.where(seq_ids == pad_id, torch.full_like(s1, -1e9), s1)
        cpos = _first_k(s1, C2)
        cids = torch.gather(seq_ids, 1, cpos)
    with record_function("select.proxy_stage2"):
        s2 = _score(_masked_rows(table, cids, pad_id, cdt), query)
        s2 = s2 + log_decay_at(cpos, L, tau, cdt)
        s2 = torch.where(cids != pad_id, s2, torch.full_like(s2, -1e9))
        j = _first_k(s2, K)
        return torch.gather(cpos, 1, j), torch.gather(cids, 1, j)


@torch.no_grad()
def dare_select_ids(att_table: torch.Tensor, seq_ids: torch.Tensor, query: torch.Tensor,
                    *, top_k: int, tau: float, pad_id: int = 0,
                    select_chunk: Optional[int] = None, select_proxy: Optional[dict] = None):
    """-> (idx (B, K) positions into L, sel_ids (B, K) token ids,
    log_decay (L,)), K = min(top_k, L).

    ``att_table`` (V, D) may be a strided view, such as the att half of
    the lane-fused (V, 2D) table; only the selected columns are gathered.
    ``select_proxy`` ({"block", "candidates"}) takes the proxy prefilter
    when candidates < L; else ``select_chunk`` < L the streaming pass;
    else the dense pass."""
    B, L = seq_ids.shape
    K = min(top_k, L)
    cdt = query.dtype
    log_decay = recency_log_decay(L, tau, cdt, device=query.device)
    if select_proxy and select_proxy.get("candidates", L) < L:
        idx, sel_ids = _proxy_topk_ids(att_table, seq_ids, query, log_decay, float(tau), pad_id,
                                       K, int(select_proxy["block"]),
                                       int(select_proxy["candidates"]))
    elif select_chunk and select_chunk < L:
        with record_function("select.streaming"):
            idx = _streaming_topk_ids(att_table, seq_ids, query, log_decay, pad_id, K,
                                      int(select_chunk))
            sel_ids = take_along_rows(seq_ids, idx)
    else:
        with record_function("select.dense"):
            scores = _score(_masked_rows(att_table, seq_ids, pad_id, cdt), query)
            scores = scores + log_decay[None, :]
            scores = torch.where(seq_ids != pad_id, scores, torch.full_like(scores, -1e9))
            idx = _first_k(scores, K)
            sel_ids = take_along_rows(seq_ids, idx)
    return idx, sel_ids, log_decay
