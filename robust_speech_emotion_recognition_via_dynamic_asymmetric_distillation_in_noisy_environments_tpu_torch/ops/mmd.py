"""Pairwise-distance and weighted multi-kernel MMD building blocks.

Distances come from the Gram matrix (one matmul) instead of an (N, N, D)
difference tensor, and sample masks and weights make the per-class subsets
fixed-shape.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) squared euclidean distances via the Gram expansion,
    clamped at zero against negative round-off on the diagonal."""
    sq = torch.sum(x * x, dim=-1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d, min=0.0)


def weighted_mmd_terms(
    l2: torch.Tensor,  # (N, N) pairwise sq dists over concat(source, target)
    w_s: torch.Tensor,  # (N,) source weights (0 outside the source subset)
    w_t: torch.Tensor,  # (N,) target weights (0 outside the target subset)
    member: torch.Tensor,  # (N,) bool: rows taking part in this MMD
    kernel_mul: float = 2.0,
    kernel_num: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention-weighted multi-kernel MMD terms (term_ss, term_tt,
    term_st); MMD = ss + tt - 2 * st.

    The bandwidth is the mean pairwise distance over the participating
    block (sum over n^2 - n pairs), detached from the graph, scaled into a
    geometric ladder of ``kernel_num`` kernels."""
    member_f = member.to(l2.dtype)
    pair = member_f[:, None] * member_f[None, :]
    n = torch.sum(member_f)
    denom = torch.clamp(n * n - n, min=1.0)
    bandwidth = torch.sum(l2.detach() * pair) / denom
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))

    kernel = torch.zeros_like(l2)
    for i in range(kernel_num):
        kernel = kernel + torch.exp(-l2 / (bandwidth * (kernel_mul**i) + 1e-8))

    def term(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        w = wa[:, None] * wb[None, :]
        return torch.sum(kernel * w) / (torch.sum(w) + 1e-8)

    return term(w_s, w_s), term(w_t, w_t), term(w_s, w_t)
