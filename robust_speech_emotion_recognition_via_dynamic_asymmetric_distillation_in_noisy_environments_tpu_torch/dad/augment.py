"""Feature-space weak/strong augmentation with explicit random draws.

Reference semantics:
- weak: x + N(0, weak_std^2);
- strong: x + N(0, strong_std^2), then one feature-channel dropout mask
  shared across the batch and all timesteps, then a contiguous temporal
  mask of ``int(t * ratio)`` frames per sample at a random start, ``t``
  being the batch's longest valid length (taken from ``padding_mask``, not
  from the bucket-padded shape, which would strengthen the augmentation).

Draws come from ``generator`` (on x's device) unless they are passed in
ready-made, which is how the tests feed both frameworks the same numbers.
Every shape is fixed and nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs import AugmentConfig


class StrongDraws(NamedTuple):
    noise: torch.Tensor  # (B, T, D) standard normal
    feat_u: torch.Tensor  # (D,) uniform [0, 1): channel dropout
    start: torch.Tensor  # (B,) int temporal mask starts


def weak_augment(generator: Optional[torch.Generator], x: torch.Tensor,
                 cfg: AugmentConfig, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * cfg.weak_noise_std


def _mask_length(t_valid: torch.Tensor, ratio: float) -> torch.Tensor:
    return torch.floor(t_valid.float() * ratio).long()


def _valid_max(x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if padding_mask is None:
        return torch.tensor(x.shape[1], device=x.device)
    return torch.amax(torch.sum(~padding_mask, dim=1))


def start_upper_bound(x: torch.Tensor, cfg: AugmentConfig,
                      padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exclusive upper bound of the temporal mask's start: max(1, t - len + 1)."""
    t_valid = _valid_max(x, padding_mask)
    mask_len = _mask_length(t_valid, cfg.temporal_mask_ratio)
    return torch.clamp(t_valid - mask_len + 1, min=1)


def draw_strong(generator: Optional[torch.Generator], x: torch.Tensor,
                cfg: AugmentConfig,
                padding_mask: Optional[torch.Tensor] = None) -> StrongDraws:
    """The strong view's random numbers, drawn on x's device."""
    B, _T, D = x.shape
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    feat_u = torch.rand(D, generator=generator, device=x.device)
    # uniform integer in [0, hi) without reading hi back to the host
    hi = start_upper_bound(x, cfg, padding_mask)
    u = torch.rand(B, generator=generator, device=x.device, dtype=torch.float64)
    start = torch.minimum((u * hi).long(), hi - 1)
    return StrongDraws(noise, feat_u, start)


def strong_augment(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    cfg: AugmentConfig,
    padding_mask: Optional[torch.Tensor] = None,
    draws: Optional[StrongDraws] = None,
) -> torch.Tensor:
    """x: (B, T, D); padding_mask (B, T) bool True=pad (optional: without it
    the padded length T stands in for the batch max)."""
    if draws is None:
        draws = draw_strong(generator, x, cfg, padding_mask)
    _B, T, _D = x.shape

    out = x + draws.noise * cfg.strong_noise_std

    if cfg.feature_dropout_rate > 0:
        out = out * (draws.feat_u > cfg.feature_dropout_rate).to(x.dtype)

    if cfg.temporal_mask_ratio > 0:
        mask_len = _mask_length(_valid_max(x, padding_mask), cfg.temporal_mask_ratio)
        start = draws.start.to(x.device)[:, None]
        idx = torch.arange(T, device=x.device)[None, :]
        tmask = (idx >= start) & (idx < start + mask_len) & (mask_len > 0)
        out = torch.where(tmask[:, :, None], torch.zeros((), dtype=out.dtype,
                                                         device=out.device), out)
    return out
