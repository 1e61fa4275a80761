"""Training losses.

Port of ``tossctr_tpu/train/loss.py``: ``bce_wll_style``, and the
optional auxiliaries ``logit_l2`` and ``pairwise_auc_loss``
(``loss.apply_extra_losses``).  The reference's boolean-indexing branches
become masked reductions with the same empty-class semantics (an absent
class contributes 0), so no reduction waits on the card.

``pairwise_auc_loss`` draws its random negatives from a ``torch.Generator``
(the JAX package from ``jax.random.categorical``): the same distribution,
uniform with replacement over the batch's negatives, not the same draws.
Its hard negatives (``hard_frac``) are the same.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_wll_style(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WLL(50:50) = 0.5 * mean_pos softplus(-z) + 0.5 * mean_neg softplus(z),
    in fp32.  ``valid`` masks the padded rows of a partial batch."""
    z = logits.float()
    pos = labels.float() > 0.5
    neg = ~pos
    if valid is not None:
        v = valid.bool()
        pos = pos & v
        neg = neg & v
    n_pos = pos.sum()
    n_neg = neg.sum()
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    pos_loss = torch.where(pos, F.softplus(-z), zero).sum() / n_pos.clamp(min=1)
    neg_loss = torch.where(neg, F.softplus(z), zero).sum() / n_neg.clamp(min=1)
    pos_loss = torch.where(n_pos > 0, pos_loss, zero)
    neg_loss = torch.where(n_neg > 0, neg_loss, zero)
    return 0.5 * (pos_loss + neg_loss)


def logit_l2(logits: torch.Tensor) -> torch.Tensor:
    """Mean squared logit, in fp32."""
    return (logits.float() ** 2).mean()


def draw_negatives(neg_mask: torch.Tensor, shape, generator: torch.Generator) -> torch.Tensor:
    """Positions of ``neg_mask`` (B,) drawn uniformly with replacement ->
    int64 of ``shape``, without waiting on the card: the negatives'
    positions sorted first, then a uniform pick among the first n_neg of
    them.  Without a negative every pick is a position outside the mask."""
    n_neg = neg_mask.sum()
    negatives = torch.argsort((~neg_mask).to(torch.uint8), stable=True)
    u = torch.rand(shape, generator=generator, device=neg_mask.device)
    return negatives[torch.minimum((u * n_neg).long(), (n_neg - 1).clamp(min=0))]


def pairwise_auc_loss(logits: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
                      num_neg_per_pos: int = 8, hard_frac: float = 0.0,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-batch pairwise logistic loss: every row is paired with
    ``num_neg_per_pos`` negatives (the ``int(hard_frac * r)`` (at least 1
    when ``hard_frac`` > 0) highest-logit negatives, the rest drawn
    uniformly with replacement from ``generator``, which lies on the
    logits' device); pair (i, j) adds softplus(-(z_i - z_j)) weighted by
    pos_i * neg_j, normalised by the pair count.  ``valid`` masks padded
    rows out of both classes, the draw and the hard negatives.  0 when the
    batch has no positive or no negative."""
    z = logits.float().reshape(-1)
    y = labels.float().reshape(-1) > 0.5
    B = z.shape[0]
    r = max(1, int(num_neg_per_pos))
    neg_mask = ~y
    if valid is not None:
        v = valid.reshape(-1).bool()
        y = y & v
        neg_mask = neg_mask & v
    n_neg = neg_mask.sum()
    k_hard = max(1, int(hard_frac * r)) if hard_frac > 0.0 else 0
    parts = []
    if k_hard:
        z_neg = torch.where(neg_mask, z, torch.full_like(z, -torch.inf))
        parts.append(torch.topk(z_neg, k_hard).indices[None, :].expand(B, k_hard))
    if r > k_hard:
        parts.append(draw_negatives(neg_mask, (B, r - k_hard), generator))
    idx = torch.cat(parts, dim=1)  # (B, r)
    w = y.float()[:, None] * neg_mask[idx].float()
    margin = z[:, None] - z[idx]
    total = w.sum()
    loss = (w * F.softplus(-margin)).sum() / total.clamp(min=1.0)
    any_pair = (y.sum() > 0) & (n_neg > 0)
    return torch.where(any_pair, loss, torch.zeros_like(loss))
