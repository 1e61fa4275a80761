"""Training loss.

Port of ``tossctr_tpu/train/loss.py`` ``bce_wll_style``: the reference's
boolean-indexing branches become masked reductions with the same
empty-class semantics (an absent class contributes 0), so no reduction
waits on the card.
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
