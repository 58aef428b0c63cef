"""Masked reductions used throughout the compute path."""

from __future__ import annotations

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
