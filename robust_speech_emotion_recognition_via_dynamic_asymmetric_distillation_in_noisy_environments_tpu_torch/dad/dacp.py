"""DACP (Dynamic Adaptive Confidence Pruning) as functional state.

stage 1  certainty s = p_max * (1 - H(p)/log2 C)
stage 2  per-epoch per-class quality EMA (beta), at epoch end
stage 3  class weights W_c = sigmoid(k * (Q_c - mean Q)); the quantile
         level gamma_e ramps q_start -> q_end over the epochs
stage 4  per-class batch quantile threshold (the EMA threshold where the
         class is absent), + lambda * (W_c - 0.5), floored at the
         calibrated anchors, then EMA-smoothed with alpha: every batch

The per-epoch score buffers are running (sum, count) pairs per class, with
the same epoch-mean semantics as lists of scores. All of it stays on the
device: no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs import DACPConfig
from ..ops.masked import masked_quantile


class DACPState(NamedTuple):
    quality: torch.Tensor  # (C,) Q_c, init 0.5
    ema_thresholds: torch.Tensor  # (C,) tau_c, init 0.5
    score_sums: torch.Tensor  # (C,) running per-epoch score sums
    score_counts: torch.Tensor  # (C,) running per-epoch score counts


def init_dacp(num_classes: int, device=None) -> DACPState:
    def full(v):
        return torch.full((num_classes,), v, dtype=torch.float32, device=device)

    return DACPState(full(0.5), full(0.5), full(0.0), full(0.0))


def certainty_scores(
    probs: torch.Tensor, use_entropy: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1. probs (B, C) -> (scores, preds)."""
    max_probs = probs.amax(dim=-1)
    preds = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
    if not use_entropy:
        return max_probs, preds
    entropy = -torch.sum(probs * torch.log2(probs + 1e-8), dim=-1)
    return max_probs * (1.0 - entropy / math.log2(probs.shape[-1])), preds


def dacp_mask(
    state: DACPState,
    teacher_probs: torch.Tensor,  # (B, C)
    row_valid: torch.Tensor,  # (B,) bool
    gamma_e: float,  # quantile level for this epoch
    anchors: torch.Tensor,  # (C,) calibrated anchor floors
    cfg: DACPConfig,
) -> Tuple[DACPState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One training batch's DACP update. Returns
    (new_state, mask (B,) bool, scores (B,), class_weights (C,))."""
    C = teacher_probs.shape[-1]
    scores, preds = certainty_scores(teacher_probs, cfg.use_entropy_in_score)

    # stage 3: class weights from relative quality gaps
    wce = torch.sigmoid(cfg.sensitivity_k * (state.quality - state.quality.mean()))

    # per-class batch threshold: quantile of this batch's scores among the
    # rows predicted c, the EMA threshold where no row is
    onehot = F.one_hot(preds, C).to(scores.dtype) * row_valid[:, None]
    member = onehot.T > 0  # (C, B)
    batch_thr = masked_quantile(scores.expand(C, -1), member, gamma_e,
                                state.ema_thresholds)

    # stage 4: dynamic adjustment + anchor floor + threshold EMA
    dynamic = batch_thr + cfg.calibration_strength_lambda * (wce - 0.5)
    floored = torch.maximum(dynamic, anchors.to(dynamic.dtype))
    alpha = cfg.threshold_smoothing_alpha
    new_thr = alpha * state.ema_thresholds + (1.0 - alpha) * floored

    mask = (scores >= new_thr[preds]) & row_valid

    # buffer every valid row's score by predicted class for the epoch end
    sums = state.score_sums + onehot.T @ scores
    counts = state.score_counts + onehot.sum(dim=0)
    return DACPState(state.quality, new_thr, sums, counts), mask, scores, wce


def fixed_threshold_mask(
    teacher_probs: torch.Tensor, row_valid: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """USE_DACP=False: plain max-prob confidence against a fixed threshold.
    Returns (mask, raw scores, class_weights = ones(C))."""
    scores = teacher_probs.max(dim=-1).values
    mask = (scores >= threshold) & row_valid
    wce = torch.ones(teacher_probs.shape[-1], dtype=teacher_probs.dtype,
                     device=teacher_probs.device)
    return mask, scores, wce


def dacp_epoch_update(state: DACPState, cfg: DACPConfig) -> DACPState:
    """Stage 2 at epoch end: EMA the per-class epoch mean score into Q_c;
    classes with no samples keep their quality."""
    mean = torch.where(
        state.score_counts > 0,
        state.score_sums / torch.clamp(state.score_counts, min=1.0),
        state.quality,
    )
    beta = cfg.quality_smoothing_beta
    return DACPState(
        quality=beta * state.quality + (1.0 - beta) * mean,
        ema_thresholds=state.ema_thresholds,
        score_sums=torch.zeros_like(state.score_sums),
        score_counts=torch.zeros_like(state.score_counts),
    )
