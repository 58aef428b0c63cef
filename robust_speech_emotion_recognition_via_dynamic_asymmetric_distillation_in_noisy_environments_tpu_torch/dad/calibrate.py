"""One-shot anchor calibration (reference train.py:317-357).

Runs the freshly initialised student over the clean TRAIN batches and the
noisy VAL batches (a reference quirk, preserved: _run_anchor_calibration
uses the noisy validation split, train.py:325), collects per-true-class
certainty statistics, and produces the anchor floors:

    anchor_c = clamp(mu_clean_c - k * sigma_clean_c, min=0)
               * (mu_noisy_c / (mu_clean_c + 1e-8))

Statistics use numpy ddof=0 like np.std in the reference; classes with no
samples get mean/std 0 (train.py:345-349). The scores stay on the device
until the pass ends and come back to the host in one copy.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch
from torch.func import functional_call

from ..configs import DADConfig
from ..data.batching import Batch
from ..data.prefetch import prefetch
from ..models.heads import DADHead
from .dacp import certainty_scores


def run_anchor_calibration(
    head: DADHead,
    student_params: Dict[str, torch.Tensor],
    clean_batches: Iterable[Batch],
    noisy_batches: Iterable[Batch],
    cfg: DADConfig,
    prefetch_depth: int = 2,
) -> np.ndarray:
    C = cfg.num_classes
    device = next(iter(student_params.values())).device

    @torch.no_grad()
    def collect(batches):
        scores, labels, valid = [], [], []
        for b in prefetch(batches, depth=prefetch_depth, to_device=True, device=device):
            logits, _ = functional_call(head, student_params, (b.feats, b.padding_mask))
            s, _ = certainty_scores(torch.softmax(logits, dim=-1),
                                    cfg.dacp.use_entropy_in_score)
            scores.append(s)
            labels.append(b.labels)
            valid.append(b.row_valid)
        if not scores:
            return [[] for _ in range(C)]
        s, y, v = (torch.cat(x).cpu().numpy() for x in (scores, labels, valid))
        keep = v & (y >= 0)
        return [[float(x) for x in s[keep & (y == c)]] for c in range(C)]

    clean_scores = collect(clean_batches)
    noisy_scores = collect(noisy_batches)

    mu_clean = np.array([np.mean(s) if s else 0.0 for s in clean_scores])
    sigma_clean = np.array([np.std(s) if s else 0.0 for s in clean_scores])
    mu_noisy = np.array([np.mean(s) if s else 0.0 for s in noisy_scores])

    shift_ratio = mu_noisy / (mu_clean + 1e-8)
    base = np.clip(mu_clean - cfg.dacp.anchor_std_k * sigma_clean, 0.0, None)
    return (base * shift_ratio).astype(np.float32)
