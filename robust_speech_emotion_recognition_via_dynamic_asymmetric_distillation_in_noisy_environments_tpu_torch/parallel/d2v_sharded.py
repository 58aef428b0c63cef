"""d2v pretraining over the (dp, tp) process grid: the counterpart of the
JAX package's ``parallel/d2v_sharded.py``.

JAX shards the batch over dp and the blocks' params over tp, and GSPMD
partitions the forward and the backward and inserts the collectives. Here
each rank writes them out:

- it holds its tp shard of the student, of the EMA blocks and of both
  AdamW moments (``place_d2v_state``, by the rule of
  ``mesh.encoder_leaf_split``); the decoder, the conv front end, the
  positional conv, the LNs and the scalars are replicated;
- it runs its dp rows of the global batch through its shard (the blocks'
  tp sums with a backward, ``models/layers.py``), draws every random number
  of the global batch and keeps its rows, and divides by the global batch's
  denominators (``models/d2v_pretrain.py::BatchCut``);
- it sums the gradients over dp (one flat all-reduce,
  ``parallel/sharded.py::reduce_grads``) and averages the replicated
  leaves' over tp (every tp rank computes them whole, but the card's
  kernels that add by atomics can part them in the last bits, and Adam
  would carry that apart), then clips by the global norm, the replicated
  leaves counted once and the sharded leaves' squares summed over tp, so
  that every rank clips by the same factor;
- AdamW and the EMA act on its shard elementwise;
- every rank of a tp group reads the metrics of its first rank, so that
  the collapse guards and the best state decide alike on every rank.

So an N-process run is the single-process step at N times the batch (JAX
``parallel/d2v_sharded.py:8-10``), not plain DDP's average of per-rank
losses. ``gather_d2v_state`` reassembles the single-process state for
checkpoints and exports.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.d2v_pretrain import (
    BatchCut,
    D2vAdamState,
    D2vDraws,
    D2vOptimizer,
    D2vPretrainModel,
    D2vTrainState,
    Params,
    check_trainable,
    d2v_update,
    make_d2v_eval_step,
    make_d2v_loss_fn,
)
from .mesh import (
    Mesh,
    batch_rows,
    batch_sharding,
    encoder_leaf_split,
    gather_encoder_state,
    replicated,
    shard_encoder_state,
)
from .sharded import reduce_grads


def _tree(state: D2vTrainState, fn) -> D2vTrainState:
    """``fn`` over the four params-keyed trees of a state; the counts as
    they are."""
    opt = state.opt_state
    return D2vTrainState(params=fn(state.params), ema_blocks=fn(state.ema_blocks),
                         opt_state=D2vAdamState(opt.count, fn(opt.mu), fn(opt.nu)),
                         step=state.step)


def place_d2v_state(state: D2vTrainState, mesh: Mesh) -> D2vTrainState:
    """A full (single-process) state on the grid: the student, its EMA
    blocks and both AdamW moments as this rank's tp shard, ``step`` and
    ``count`` replicated, all on the rank's device. On a mesh without tp
    everything is replicated."""
    placed = _tree(state, lambda tree: shard_encoder_state(tree, mesh))
    return replicated(mesh, placed)


def gather_d2v_state(state: D2vTrainState, mesh: Mesh) -> D2vTrainState:
    """The full single-process state from this rank's (a collective over
    the tp group: every rank of it calls this)."""
    return _tree(state, lambda tree: gather_encoder_state(tree, mesh))


def _rank_model(model: D2vPretrainModel, mesh: Mesh) -> D2vPretrainModel:
    """The model whose blocks hold this rank's tp shard (on the meta
    device: every call passes a params dict); ``model`` itself without tp."""
    if mesh.tp == 1:
        return model
    with torch.device("meta"):
        return D2vPretrainModel(model.cfg, model.pcfg, tp_group=mesh.tp_group)


def _reduce(mesh: Mesh):
    """The gradients summed over dp; under tp the replicated leaves'
    averaged over the tp group too (module docstring)."""

    def reduce(grads: Params) -> Params:
        grads = reduce_grads(mesh, grads)
        if mesh.tp > 1:
            whole = {k: g for k, g in grads.items() if encoder_leaf_split(k) is None}
            whole = reduce_grads(mesh, whole, group=mesh.tp_group)
            grads = {**grads, **{k: g / mesh.tp for k, g in whole.items()}}
        return grads

    return reduce


def _agree(mesh: Mesh, metrics):
    """The metrics of this rank's tp group's first rank (one broadcast)."""
    if mesh.tp == 1:
        return metrics
    values = torch.stack([v.float() for v in metrics.values()])
    dist.broadcast(values, src=mesh.dp_rank * mesh.tp, group=mesh.tp_group)
    return {k: v.to(metrics[k].dtype) for k, v in zip(metrics, values)}


def _grad_norm(mesh: Mesh):
    """The global gradient norm from a rank's (dp-summed) gradients; None
    without tp, where the optimizer takes it over the whole gradient."""
    if mesh.tp == 1:
        return None

    def norm(grads: Params) -> torch.Tensor:
        split = {k: encoder_leaf_split(k) is not None for k in grads}
        whole = sum(torch.sum(g * g) for k, g in grads.items() if not split[k])
        part = sum(torch.sum(g * g) for k, g in grads.items() if split[k])
        dist.all_reduce(part, group=mesh.tp_group)
        return torch.sqrt(whole + part)

    return norm


def _cut(mesh: Mesh, wav, wav_pad):
    """This rank's rows of a global batch on its device, and its cut."""
    B = wav.shape[0]
    rows = batch_rows(mesh, B)  # the JAX error for an indivisible batch
    wav, wav_pad = batch_sharding(mesh, (wav, wav_pad), B)
    return wav.float(), wav_pad, BatchCut(rows, B, mesh.dp_group)


def make_sharded_d2v_step(model: D2vPretrainModel, tx: D2vOptimizer, mesh: Mesh):
    """step(state, wav (B, T), pad (B, T), generator=None, draws=None) ->
    (state', metrics) over ``mesh``: ``wav``/``pad`` are the GLOBAL batch
    (host or device; B must divide by dp) and ``draws`` the global batch's
    ``D2vDraws`` (or None: the generator, the same on every rank); ``state``
    is this rank's (``place_d2v_state``). The metrics are the global
    batch's, the same on every rank."""
    check_trainable(model.cfg, model.pcfg)
    local = _rank_model(model, mesh)
    loss_fn = make_d2v_loss_fn(local, train=True)
    reduce, grad_norm = _reduce(mesh), _grad_norm(mesh)

    def step(state: D2vTrainState, wav, wav_pad, generator=None,
             draws: Optional[D2vDraws] = None):
        wav, wav_pad, cut = _cut(mesh, wav, wav_pad)
        state, metrics = d2v_update(local, tx, loss_fn, state, wav, wav_pad, generator,
                                    replicated(mesh, draws), cut, reduce_grads=reduce,
                                    grad_norm=grad_norm)
        return state, _agree(mesh, metrics)

    return step


def make_sharded_d2v_eval_step(model: D2vPretrainModel, mesh: Mesh):
    """``make_d2v_eval_step`` over ``mesh``: (params, ema_blocks, wav, pad,
    generator=None, draws=None) -> the global batch's metrics, from this
    rank's shard and a global batch."""
    eval_fn = make_d2v_eval_step(_rank_model(model, mesh))

    def step(params, ema_blocks, wav, wav_pad, generator=None, draws=None):
        wav, wav_pad, cut = _cut(mesh, wav, wav_pad)
        return _agree(mesh, eval_fn(params, ema_blocks, wav, wav_pad, generator,
                                    replicated(mesh, draws), cut))

    return step
