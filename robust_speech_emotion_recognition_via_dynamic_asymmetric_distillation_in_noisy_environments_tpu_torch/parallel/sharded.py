"""The data-parallel DAD step: the batch split over the dp ranks, the
losses over the whole batch.

The JAX step is one SPMD program over the global batch, so DACP's
quantiles, ECDA's MMD and the loss normalisation see every row, and an
N-device run computes the single-device step at N times the batch. Plain
DDP would average per-rank losses and run DACP and ECDA per rank, another
algorithm. Here each rank:

1. takes its rows of the global batch (``mesh.batch_sharding``) and its
   rows of the global batch's random draws: every rank draws the whole
   batch's numbers from the same generator, in the single-process step's
   order, and slices them, so the N-process run draws what one process
   draws at N times the batch;
2. runs the head on its rows (``dad/train_step.py::head_outputs``; the
   strong view's temporal mask takes the whole batch's longest valid
   length);
3. gathers the per-row outputs (logits, pooled embeddings, teacher
   probabilities) over dp (``gather_rows``);
4. computes the losses, the DACP update and the metrics on the global
   batch, identically on every rank;
5. sums the head's gradients over dp.

The gather's backward hands each rank the gradient of its own rows from
its own copy of the global loss, and nothing else. Every rank computes
the same loss, so a backward that summed the ranks' gradients for each
slice (``torch.distributed.nn.functional.all_gather``'s) would give dp
times the true gradient, to be divided by dp again; this one needs no
collective and no division. (That function's gloo backward also scatters
from group-local ranks taken as global ones, which deadlocks a dp group
without rank 0, the (dp, tp) = (1, 2) grid.)

The head state is small and replicated (``shard_dad_state``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dad.augment import StrongDraws, draw_strong_shaped
from ..dad.train_step import (
    DADTrainState,
    HeadOutputs,
    StepDraws,
    head_outputs,
    losses_from_outputs,
    student_update,
)
from ..models.layers import draw_keep
from .mesh import Mesh, batch_rows, batch_sharding, replicated


def shard_dad_state(state: DADTrainState, mesh: Mesh) -> DADTrainState:
    """The (small) head, optimizer and DACP state, in full on every rank."""
    return replicated(mesh, state)


def as_tensor(x, device) -> torch.Tensor:
    """A host (numpy) or device array on ``device``."""
    return (torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x).to(device)


def valid_max(padding_mask: torch.Tensor) -> torch.Tensor:
    """The longest valid length of a (B, T) True = pad mask."""
    return torch.amax(torch.sum(~padding_mask, dim=1))


def slice_draws(draws: StepDraws, rows: slice) -> StepDraws:
    """A rank's rows of a global batch's draws (the strong view's channel
    dropout is one draw for the whole batch)."""
    def cut(x):
        return None if x is None else x[rows]

    strong = draws.strong
    if strong is not None:
        strong = StrongDraws(strong.noise[rows], strong.feat_u, strong.start[rows])
    return StepDraws(**{k: cut(v) for k, v in draws._asdict().items() if k != "strong"},
                     strong=strong)


def _keep(generator, rate: float, shape, device) -> Optional[torch.Tensor]:
    """A dropout keep mask, drawn only where ``layers.dropout`` would draw."""
    return draw_keep(shape, rate, generator, device) if 0 < rate < 1 else None


def draw_head(generator, cfg, given: StepDraws, B: int, feat_shape, device,
              t_valid: torch.Tensor, dropout_rate: float, trainer_order: bool) -> StepDraws:
    """The head's draws for a global batch of B rows: what ``given`` lacks
    comes from ``generator`` in the single-process order. ``trainer_order``:
    the feature trainer's (weak, strong, then the two dropouts:
    ``draw_feature_step`` before the step); else the step's own (clean
    dropout, weak, strong, strong-pass dropout)."""
    d = given
    hidden = (B, cfg.hidden_dim)

    def weak_strong(d):
        if d.weak is None:
            d = d._replace(weak=torch.randn(feat_shape, generator=generator, device=device))
        if d.strong is None:
            d = d._replace(strong=draw_strong_shaped(generator, feat_shape, torch.float32,
                                                     device, cfg.augment, t_valid))
        return d

    if trainer_order:
        d = weak_strong(d)
    if d.clean_keep is None:
        d = d._replace(clean_keep=_keep(generator, dropout_rate, hidden, device))
    if not trainer_order:
        d = weak_strong(d)
    if d.strong_keep is None:
        d = d._replace(strong_keep=_keep(generator, dropout_rate, hidden, device))
    return d


class _GatherRows(torch.autograd.Function):
    """All-gather over dp in the forward; in the backward, this rank's rows
    of the gradient (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, rank: int, world: int):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None, None, None


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(b, ...) rows of every dp rank -> (dp * b, ...), in rank order, with
    the gradient of the global loss flowing back to this rank's rows."""
    return _GatherRows.apply(x, mesh.dp_group, mesh.dp_rank, mesh.dp)


def gather_outputs(mesh: Mesh, out: HeadOutputs) -> HeadOutputs:
    """The global batch's head outputs from every rank's rows: one
    all-gather of the outputs side by side (the teacher's, as on one
    process, without a graph)."""
    widths = [t.shape[1] for t in out]
    both = HeadOutputs(*torch.split(gather_rows(mesh, torch.cat(list(out), dim=1)), widths,
                                    dim=1))
    return both._replace(teacher_probs=both.teacher_probs.detach())


def reduce_grads(mesh: Mesh, grads, group=None):
    """The sum of every dp rank's gradients (one all-reduce over a flat
    buffer): each rank's rows' part of the global batch's gradient. Over
    ``group`` instead of dp where given."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat, group=mesh.dp_group if group is None else group)
    out, i = {}, 0
    for k, g in grads.items():
        out[k] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


def dp_head_step(head, tx, cfg, mesh: Mesh, state: DADTrainState,
                 clean_feats, clean_fmask, noisy_feats, noisy_fmask,
                 clean_labels, clean_valid, noisy_valid, noisy_ids,
                 scalars, anchors, draws: StepDraws, t_valid: torch.Tensor):
    """Steps 2-5 of the module docstring on this rank's rows (features,
    masks and ``draws``) and the global batch's labels, valid flags and ids.
    Returns (state', metrics, tracking), the same on every rank."""
    student = {k: v.detach().requires_grad_(True) for k, v in state.ssrl.student.items()}
    out = head_outputs(head, cfg, student, state.ssrl.teacher, clean_feats, clean_fmask,
                       noisy_feats, noisy_fmask, None, draws, t_valid)
    out = gather_outputs(mesh, out)
    total, new_dacp, metrics, tracking = losses_from_outputs(
        cfg, out, state.dacp, clean_labels, clean_valid, noisy_valid, noisy_ids, scalars,
        anchors)
    new_state = student_update(state, total, student, new_dacp, scalars, tx, cfg,
                               reduce_grads=lambda g: reduce_grads(mesh, g))
    return new_state, {k: v.detach() for k, v in metrics.items()}, tracking


def make_sharded_dad_train_step(head, tx, cfg, mesh: Mesh):
    """The feature-level DAD step over the dp axis of ``mesh``:

    step(state, clean, noisy, scalars, anchors, generator=None, draws=None)
    -> (state', metrics, tracking)

    ``clean``/``noisy`` are the GLOBAL batches (``data.batching.Batch``, on
    the host or a device); the step takes this rank's rows. ``draws``: the
    global batch's draws, or None to draw them from ``generator`` as the
    feature trainer does (weak, strong, then the dropouts)."""
    dropout_rate = head.classifier.dropout_rate

    def step(state, clean, noisy, scalars, anchors, generator=None,
             draws: Optional[StepDraws] = None):
        dev = mesh.device
        B = noisy.feats.shape[0]
        rows = batch_rows(mesh, B)
        noisy_pm = as_tensor(noisy.padding_mask, dev)
        t_valid = valid_max(noisy_pm)
        given = replicated(mesh, draws or StepDraws())
        d = draw_head(generator, cfg, given, B, tuple(noisy.feats.shape), dev, t_valid,
                      dropout_rate, trainer_order=True)
        clean_feats, clean_pm, noisy_feats = batch_sharding(
            mesh, (clean.feats, clean.padding_mask, noisy.feats), B)
        return dp_head_step(
            head, tx, cfg, mesh, state, clean_feats.float(), clean_pm, noisy_feats.float(),
            noisy_pm[rows], as_tensor(clean.labels, dev), as_tensor(clean.row_valid, dev),
            as_tensor(noisy.row_valid, dev),
            None if noisy.ids is None else as_tensor(noisy.ids, dev),
            scalars, anchors, slice_draws(d, rows), t_valid)

    return step
