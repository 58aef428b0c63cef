"""ECDA (Energy/Class-aware Distribution Alignment) loss, fixed-shape.

Per class c (class-aware branch):
  clean set  = clean embeddings with label c, weights 1
  noisy set  = noisy embeddings with pseudo-label c AND the DACP mask,
               weights = certainty scores
  MMD_c      = attention-weighted multi-kernel MMD
  compact_c  = mean ||x - centroid_c||^2 over the noisy set
  repulsion  = -mean pairwise distance between all class centroids
               (global, added to every class)
  ecda_c     = MMD_c + gamma * compact_c + delta * repulsion
  gate       : a class counts only with >= 2 clean and >= 2 masked noisy rows
  total      = sum_c a_c * ecda_c with a_c = exp(lambda * (mean(W) - W_c))

Boolean indexing of the subsets becomes zero-weight masking, which gives
the same numbers because every kernel term is weight-normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import ECDAConfig
from ..ops.mmd import pairwise_sq_dists, weighted_mmd_terms


def ecda_loss(
    clean_emb: torch.Tensor,  # (Bs, D)
    noisy_emb: torch.Tensor,  # (Bt, D)
    clean_labels: torch.Tensor,  # (Bs,) int
    noisy_pseudo: torch.Tensor,  # (Bt,) int teacher argmax
    noisy_mask: torch.Tensor,  # (Bt,) bool DACP gate
    noisy_scores: torch.Tensor,  # (Bt,) certainty scores
    class_weights: torch.Tensor,  # (C,) W_c from DACP
    clean_valid: torch.Tensor,  # (Bs,) bool real rows
    noisy_valid: torch.Tensor,  # (Bt,) bool real rows
    cfg: ECDAConfig,
) -> torch.Tensor:
    C = class_weights.shape[0]
    dtype = clean_emb.dtype
    zero = torch.zeros((), dtype=dtype, device=clean_emb.device)

    noisy_mask = noisy_mask & noisy_valid
    l2 = pairwise_sq_dists(torch.cat([clean_emb, noisy_emb], dim=0))

    if not cfg.use_class_aware_mmd:
        # ablation branch: one global unweighted MMD
        w_s = clean_valid.to(dtype)
        w_t = noisy_mask.to(dtype)
        ss, tt, st = weighted_mmd_terms(
            l2, torch.cat([w_s, torch.zeros_like(w_t)]),
            torch.cat([torch.zeros_like(w_s), w_t]),
            torch.cat([clean_valid, noisy_mask]), cfg.kernel_mul, cfg.kernel_num,
        )
        gate = (w_s.sum() >= 2) & (w_t.sum() >= 2)
        return torch.where(gate, ss + tt - 2.0 * st, zero)

    # class centroids of the masked noisy rows, and the global repulsion
    m_t = F.one_hot(noisy_pseudo.long(), C).to(dtype) * noisy_mask[:, None].to(dtype)
    counts_t = m_t.sum(dim=0)  # (C,)
    centroids = (m_t.T @ noisy_emb) / torch.clamp(counts_t, min=1.0)[:, None]
    has_centroid = counts_t >= 1
    cd = torch.sqrt(torch.clamp(pairwise_sq_dists(centroids), min=1e-12))
    upper = torch.triu(torch.ones(C, C, dtype=torch.bool, device=cd.device), diagonal=1)
    pair_valid = has_centroid[:, None] & has_centroid[None, :] & upper
    n_pairs = pair_valid.sum()
    repulsion = torch.where(
        n_pairs > 0, -torch.sum(cd * pair_valid) / torch.clamp(n_pairs, min=1), zero)

    # class-level attention
    attention = torch.exp(cfg.class_attention_lambda * (class_weights.mean() - class_weights))

    m_s = F.one_hot(torch.clamp(clean_labels.long(), min=0), C).to(dtype)
    m_s = m_s * (clean_valid & (clean_labels >= 0))[:, None].to(dtype)
    counts_s = m_s.sum(dim=0)
    zeros_s = torch.zeros(clean_emb.shape[0], dtype=dtype, device=clean_emb.device)
    zeros_t = torch.zeros(noisy_emb.shape[0], dtype=dtype, device=clean_emb.device)

    total = zero
    for c in range(C):
        w_s_c = m_s[:, c]
        sel_t = m_t[:, c]
        ss, tt, st = weighted_mmd_terms(
            l2,
            torch.cat([w_s_c, zeros_t]),
            torch.cat([zeros_s, noisy_scores * sel_t]),  # sample-level attention
            torch.cat([w_s_c > 0, sel_t > 0]),
            cfg.kernel_mul,
            cfg.kernel_num,
        )
        diff = noisy_emb - centroids[c][None, :]
        compact = torch.sum(torch.sum(diff * diff, dim=-1) * sel_t) / torch.clamp(
            counts_t[c], min=1.0)
        ecda_c = (ss + tt - 2.0 * st
                  + cfg.compactness_weight_gamma * compact
                  + cfg.repulsion_weight_delta * repulsion)
        gate = (counts_s[c] >= 2) & (counts_t[c] >= 2)
        total = total + torch.where(gate, attention[c] * ecda_c, zero)
    return total
