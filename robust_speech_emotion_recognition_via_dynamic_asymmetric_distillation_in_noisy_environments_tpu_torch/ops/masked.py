"""Masked reductions used throughout the compute path.

Boolean indexing (``scores[member]``) would give data-dependent shapes and
a host sync for every subset; these keep every shape fixed and weight out
the rows that do not take part, with the same numbers.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def masked_mean_pool(x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
    """Mean over time of valid frames.

    x: (B, T, D); padding_mask: (B, T) bool with True = pad. The count is
    clipped at 1, so an all-padded row pools to 0.
    """
    keep = (~padding_mask).to(x.dtype)[..., None]
    total = torch.sum(x * keep, dim=1)
    count = torch.clamp(torch.sum(keep, dim=1), min=1.0)
    return total / count


def masked_quantile(
    scores: torch.Tensor,  # (..., B)
    member: torch.Tensor,  # (..., B) bool: which samples take part
    q: Union[float, torch.Tensor],  # level in [0, 1]
    fallback: torch.Tensor,  # (...) used where no member exists
) -> torch.Tensor:
    """Linear-interpolation quantile over the masked subset of the last
    axis (``torch.quantile``'s default on ``scores[member]``), ``fallback``
    where the subset is empty. Leading axes are independent subsets, so
    one call serves every class of a batch."""
    B = scores.shape[-1]
    filled = torch.where(member, scores, torch.full_like(scores, float("inf")))
    s = torch.sort(filled, dim=-1).values  # members ascending, +inf tail
    n = member.sum(dim=-1)
    pos = q * torch.clamp(n - 1, min=0).to(scores.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(scores.dtype)
    lo_v = torch.gather(s, -1, torch.clamp(lo, 0, B - 1)[..., None])[..., 0]
    hi_v = torch.gather(s, -1, torch.clamp(hi, 0, B - 1)[..., None])[..., 0]
    val = lo_v + frac * (hi_v - lo_v)
    return torch.where(n > 0, val, fallback)


def masked_softmax_stats(
    probs: torch.Tensor, row_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_prob, argmax) per row with invalid rows forced to 0.0 / class 0."""
    max_p = probs.max(dim=-1).values * row_valid
    preds = probs.argmax(dim=-1) * row_valid.long()
    return max_p, preds
