"""Masking for d2v self-supervised pretraining, with the same number of
masked positions in every row, so that the student's kept-token batch has
one shape per crop size.

Counterparts of the JAX package's functions of the same names: span masks
(fairseq ``compute_mask_indices`` with the union of spans padded up to the
target count by random extra positions), MAE-style random masks, the
``MaskInfo`` bookkeeping, and the gathers that remove and restore masked
tokens. Each sampler draws its uniforms from ``generator``, or takes them
ready-made (``uniforms``), so that a test can feed it the JAX draws and
compare masks bit for bit. Every argsort here is stable, as ``jnp.argsort``
is: kept tokens stay in temporal order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class MaskInfo(NamedTuple):
    mask: torch.Tensor  # (B, T) bool, True = masked
    ids_keep: torch.Tensor  # (B, len_keep) int64: original indices of kept tokens
    ids_restore: torch.Tensor  # (B, T) int64: the inverse permutation


def span_mask_counts(t: int, mask_prob: float, mask_length: int) -> Tuple[int, int]:
    """(num_spans, num_masked) as Python ints: fairseq's span count rounded
    deterministically, the union padded up to num_spans * mask_length."""
    n_spans = max(1, int(mask_prob * t / float(mask_length) + 0.5))
    n_masked = min(n_spans * mask_length, t - 1)
    return n_spans, n_masked


def span_mask_uniforms(batch: int, t: int, mask_length: int,
                       generator: Optional[torch.Generator], device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of ``sample_span_mask``: span-start noise
    (B, T - L + 1) and fill noise (B, T)."""
    u_starts = torch.rand((batch, t - mask_length + 1), generator=generator, device=device)
    return u_starts, torch.rand((batch, t), generator=generator, device=device)


def sample_span_mask(
    batch: int,
    t: int,
    mask_prob: float,
    mask_length: int,
    inverse_mask: bool = False,
    lengths: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device=None,
) -> Tuple[torch.Tensor, int]:
    """Span mask with exactly the same masked count per row. Returns
    (mask (B, T) bool, num_masked).

    ``inverse_mask`` masks the complement of (1 - p) spans. ``lengths``
    (B,) restricts span starts and fills to each row's valid frames; a row
    shorter than the budget overflows into its padding (the count stays
    fixed). ``uniforms``: the (starts, fill) draws of
    ``span_mask_uniforms``, else drawn from ``generator``."""
    p = 1.0 - mask_prob if inverse_mask else mask_prob
    n_spans, n_masked = span_mask_counts(t, p, mask_length)
    if uniforms is None:
        uniforms = span_mask_uniforms(batch, t, mask_length, generator, device)
    noise, fill = uniforms
    n_starts = t - mask_length + 1
    if lengths is not None:
        start_pos = torch.arange(n_starts, device=noise.device)
        valid_start = start_pos[None, :] < torch.clamp(lengths[:, None] - mask_length + 1, min=1)
        noise = noise + 2.0 * (~valid_start)  # invalid starts rank last
    starts = torch.argsort(noise, dim=1, stable=True)[:, :n_spans]  # (B, S)
    pos = torch.arange(t, device=noise.device)
    inside = (pos[None, None, :] >= starts[:, :, None]) & (
        pos[None, None, :] < starts[:, :, None] + mask_length
    )
    union = inside.any(dim=1)  # (B, T): may cover fewer than n_masked (overlaps)
    # union positions win the ranking; random valid positions fill up to
    # n_masked; padding only overflows
    score = union.to(torch.float32) * 2.0 + fill
    if lengths is not None:
        score = score - 8.0 * (pos[None, :] >= lengths[:, None])
    ranks = torch.argsort(torch.argsort(-score, dim=1, stable=True), dim=1, stable=True)
    mask = ranks < n_masked
    if inverse_mask:
        mask = ~mask
        n_masked = t - n_masked
    return mask, n_masked


def sample_random_mask(batch: int, t: int, mask_prob: float,
                       generator: Optional[torch.Generator] = None,
                       uniform: Optional[torch.Tensor] = None, device=None
                       ) -> Tuple[torch.Tensor, int]:
    """MAE-style per-token masking (the mask_length == 1 path):
    int(T * (1 - p)) tokens kept per row. ``uniform``: the (B, T) draw."""
    len_keep = int(t * (1.0 - mask_prob))
    if uniform is None:
        uniform = torch.rand((batch, t), generator=generator, device=device)
    ids_shuffle = torch.argsort(uniform, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask_sorted = torch.arange(t, device=uniform.device)[None, :] >= len_keep
    mask = torch.gather(mask_sorted.expand(batch, t), 1, ids_restore)
    return mask, t - len_keep


def make_mask_info(mask: torch.Tensor, num_masked: int) -> MaskInfo:
    """Kept-token indices (in temporal order) and the inverse permutation
    of a mask with ``num_masked`` masked positions in every row."""
    len_keep = mask.shape[1] - num_masked
    ids_shuffle = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    return MaskInfo(mask=mask, ids_keep=ids_shuffle[:, :len_keep], ids_restore=ids_restore)


def apply_mask(x: torch.Tensor, info: MaskInfo, encoder_zero_mask: bool = True,
               mask_noise_std: float = 0.01, generator: Optional[torch.Generator] = None,
               normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked positions zeroed, or replaced by N(0, std) noise (``normal``:
    the standard normal draw of x's shape)."""
    m = info.mask[..., None]
    if encoder_zero_mask:
        return x * (1.0 - m.to(x.dtype))
    if normal is None:
        normal = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.where(m, mask_noise_std * normal.to(x.dtype), x)


def _gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return torch.gather(x, 1, ids)
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def gather_unmasked(x: torch.Tensor, info: MaskInfo) -> torch.Tensor:
    """(B, T, D) -> (B, len_keep, D)."""
    return _gather_rows(x, info.ids_keep)


def gather_unmasked_mask(m: torch.Tensor, info: MaskInfo) -> torch.Tensor:
    """(B, T) -> (B, len_keep)."""
    return _gather_rows(m, info.ids_keep)


def restore_with_mask_tokens(x_enc: torch.Tensor, info: MaskInfo, mask_noise_std: float,
                             generator: Optional[torch.Generator] = None,
                             normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decoder input: the encoder's kept tokens and N(0, std) mask tokens
    (``normal``: the (B, T - len_keep, D) standard normal draw), put back
    in temporal order. Returns (B, T, D)."""
    b, len_keep, d = x_enc.shape
    t = info.ids_restore.shape[1]
    if normal is None:
        normal = torch.randn((b, t - len_keep, d), generator=generator, device=x_enc.device,
                             dtype=x_enc.dtype)
    x_full = torch.cat([x_enc, mask_noise_std * normal.to(x_enc.dtype)], dim=1)
    return _gather_rows(x_full, info.ids_restore)
