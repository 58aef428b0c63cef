"""Chunked execution of the DAD train step (``--scan-chunk N``).

The JAX package scans the jitted step over a chunk of batches stacked to
one shape, one dispatch per chunk. Here the runner loops over the chunk's
batches, each padded to the chunk-common frame count exactly as the JAX
package pads them (padded frames are masked, so this is numerically
inert), and averages the metrics over the chunk as the scan does. Each
step's weak/strong draws are given at the batch's own frame count and
zero-padded to the chunk's, so a chunked run takes the same draws as
per-step stepping and gives the same history.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import DADConfig
from ..data.batching import Batch
from ..models.heads import DADHead
from .train_step import DADTrainState, Optimizer, StepDraws, StepScalars, make_dad_train_step


def stack_batches(batches: List[Batch], t_pad: int) -> Batch:
    """Stacks per-batch arrays to (S, B, ...) with every batch padded to the
    same frame count ``t_pad`` (padding frames are masked)."""

    def pad_feats(x):
        return np.pad(x, ((0, 0), (0, t_pad - x.shape[1]), (0, 0)))

    def pad_mask(m):
        return np.pad(m, ((0, 0), (0, t_pad - m.shape[1])), constant_values=True)

    return Batch(
        feats=np.stack([pad_feats(b.feats) for b in batches]),
        padding_mask=np.stack([pad_mask(b.padding_mask) for b in batches]),
        labels=np.stack([b.labels for b in batches]),
        ids=np.stack([b.ids for b in batches]),
        row_valid=np.stack([b.row_valid for b in batches]),
    )


def pad_draws(draws: StepDraws, t_pad: int) -> StepDraws:
    """Zero-pads a feature step's (B, T, D) draws to ``t_pad`` frames."""

    def pad(x):
        return None if x is None else F.pad(x, (0, 0, 0, t_pad - x.shape[1]))

    strong = draws.strong
    if strong is not None:
        strong = strong._replace(noise=pad(strong.noise))
    return draws._replace(weak=pad(draws.weak), strong=strong)


def make_dad_epoch_runner(head: DADHead, tx: Optimizer, cfg: DADConfig):
    """Returns run(state, clean_stacked, noisy_stacked, scalars, anchors,
    generator, draws=None) -> (state', metrics_mean, tracking_stacked).

    ``draws(s)`` gives step s's ``StepDraws`` (or None: the step draws from
    ``generator``); it is called just before step s runs, so draws taken
    from ``generator`` interleave with the steps' own as in per-step
    stepping. Metrics are averaged over the chunk's steps; tracking comes
    back stacked (S, B)."""
    step = make_dad_train_step(head, tx, cfg)

    def run(
        state: DADTrainState,
        clean_stacked: Batch,
        noisy_stacked: Batch,
        scalars: StepScalars,
        anchors: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Callable[[int], Optional[StepDraws]]] = None,
    ):
        S, _B, t_pad = noisy_stacked.padding_mask.shape
        metrics, tracking = [], []
        for s in range(S):
            d = None if draws is None else draws(s)
            d = None if d is None else pad_draws(d, t_pad)
            state, m, tr = step(
                state,
                Batch(*(None if v is None else v[s] for v in clean_stacked)),
                Batch(*(None if v is None else v[s] for v in noisy_stacked)),
                scalars, anchors, generator, d,
            )
            metrics.append(m)
            tracking.append(tr)
        mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
        stacked = {k: None if tracking[0][k] is None else torch.stack([t[k] for t in tracking])
                   for k in tracking[0]}
        return state, mean, stacked

    return run
