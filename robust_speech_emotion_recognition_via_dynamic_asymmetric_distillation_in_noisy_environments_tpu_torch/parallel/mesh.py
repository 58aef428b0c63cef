"""A (dp, tp) process grid over ``torch.distributed``, one process a device.

The JAX package builds a device mesh and lets XLA place the shards; here
each process is one cell of the grid and holds its own shard:

- ``dp``: the batch is split over the dp axis. Every process draws the
  global batch's random numbers and takes its rows, and the DAD losses see
  the whole batch (``parallel/sharded.py``), so an N-process run computes
  the single-process step at N times the batch.
- ``tp``: the frozen encoder's transformer blocks are split over the tp
  axis (``shard_encoder_state``): each process holds its ``H / tp`` heads of
  attention and its share of the MLP hidden width, and the partial outputs
  of the attention projection and of fc2 are summed over the tp group
  (``models/layers.py``). tp is the inner (fastest) axis, as JAX's
  ``reshape(n // tp, tp)``: rank r sits at (r // tp, r % tp).

``make_mesh`` reads ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the backend is NCCL for
CUDA devices and gloo for the CPU unless the caller names one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shlex
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.prefetch import tree_map

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
PKG = __name__.split(".")[0]


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's cell of a (dp, tp) grid and its two subgroups: the
    dp group holds the ranks with this rank's tp index, the tp group the
    ranks with its dp index."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: Any
    tp_group: Any

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints, reports and logs."""
        return self.rank == 0


def in_torchrun() -> bool:
    return all(k in os.environ for k in ENV)


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    n_devices: Optional[int] = None,
    tp: int = 1,
    axis_names: Sequence[str] = ("dp", "tp"),
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> Mesh:
    """The process grid of a ``torchrun`` launch: ``n_devices`` (default:
    the world size) processes as (n // tp, tp). Joins the default process
    group if it is not up yet. ``device`` defaults to ``cuda:LOCAL_RANK``;
    ``backend`` to NCCL for a CUDA device and gloo for the CPU."""
    axis_names = tuple(axis_names)
    if not dist.is_initialized() and not in_torchrun():
        raise RuntimeError(
            "make_mesh: no torch.distributed environment; launch with "
            "torchrun (it sets " + ", ".join(ENV) + ")")
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    n = n_devices or world
    if n % tp != 0:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    if world < n:
        raise ValueError(f"make_mesh: need {n} processes, have {world}; launch with "
                         f"torchrun --nproc_per_node {n}")
    if world > n:
        raise ValueError(f"make_mesh: n_devices={n} but the launch has {world} "
                         "processes; every process is a cell of the grid")
    if len(axis_names) == 1 and tp != 1:
        raise ValueError(f"a one-axis mesh {axis_names} has no tp axis (tp={tp})")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {}
        backend = backend or _default_backend(device)
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(backend, init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]), **kw)
    rank = dist.get_rank()
    dp = n // tp
    # every rank creates every group, in one order (torch.distributed's rule)
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    return Mesh(dp=dp, tp=tp, rank=rank, device=device, dp_group=dp_groups[rank % tp],
                tp_group=tp_groups[rank // tp])


def close_mesh() -> None:
    """Leaves the process group (the end of a command under ``torchrun``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class LaunchError(Exception):
    """``--dp``/``--tp`` asked for outside ``torchrun``, or at a world size
    that is not max(dp, 1) * tp: the command exits with status 2."""


def launch_command(n: int, argv: Sequence[str]) -> str:
    return (f"torchrun --standalone --nproc_per_node {n} -m {PKG} "
            + " ".join(shlex.quote(a) for a in argv))


@contextlib.contextmanager
def flag_mesh(dp: int, tp: int, device: str, argv: Sequence[str]):
    """The mesh of a command's ``--dp``/``--tp`` (the JAX meaning: dp 0 is
    off, tp 1 is off) for the length of the command, or None when both are
    off; the process group is left at its end. The command must run under
    ``torchrun`` with max(dp, 1) * tp processes; otherwise ``LaunchError``
    names the launch to use. ``device`` "cuda" places rank r on
    ``cuda:LOCAL_RANK``; "cpu" runs over gloo. Ranks other than 0 log
    warnings only."""
    if dp <= 0 and tp <= 1:
        yield None
        return
    n = max(dp, 1) * tp
    if not in_torchrun():
        raise LaunchError(f"--dp/--tp run one process a device; launch with "
                          f"{launch_command(n, argv)}")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise LaunchError(f"--dp {dp} --tp {tp} needs {n} processes, the launch has "
                          f"{world}; launch with {launch_command(n, argv)}")
    from ..utils.device import resolve_device

    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)  # the CPU-only error, before any process group
    mesh = make_mesh(n, tp=tp, device=None if device == "cuda" else dev)
    if not mesh.is_writer:
        logging.getLogger(PKG).setLevel(logging.WARNING)
    try:
        yield mesh
    finally:
        close_mesh()


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size`` (dim 0 split
    over dp, replicated over tp)."""
    if batch_size % mesh.dp != 0:
        raise ValueError(f"batch_size={batch_size} must divide by dp={mesh.dp}")
    b = batch_size // mesh.dp
    return slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)


def batch_sharding(mesh: Mesh, tree, batch_size: Optional[int] = None):
    """This rank's rows of every array of ``tree`` (a tensor, a numpy array,
    or NamedTuples / tuples / dicts of them) on the rank's device; 0-d
    leaves and None pass through. ``batch_size`` defaults to dim 0 of the
    first array."""
    leaves = []
    tree_map(lambda x: leaves.append(x) if getattr(x, "ndim", 0) >= 1 else None, tree)
    if not leaves:
        return tree
    rows = batch_rows(mesh, batch_size or leaves[0].shape[0])

    def one(x):
        if getattr(x, "ndim", 0) < 1:
            return x
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x[rows]))
            return x.to(mesh.device)
        return x[rows].to(mesh.device)

    return tree_map(one, tree)


def replicated(mesh: Mesh, tree):
    """Every tensor of ``tree`` in full on the rank's device (numpy leaves
    become tensors)."""
    def one(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(mesh.device)
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    return tree_map(one, tree)


def encoder_leaf_split(name: str) -> Optional[int]:
    """The tensor-parallel layout of one encoder state-dict entry (the
    JAX ``_encoder_leaf_spec``, in torch's (out, in) weight layout): the dim
    split over tp, or None for a replicated entry.

    - attention qkv weight (3C, C) and bias: output features, by head
      within each of q, k and v (``shard_encoder_state``);
    - attention proj weight (C, C): input features; its bias is replicated
      and added once, after the sum over tp;
    - MLP fc1 weight (hidden, C) and bias: output (hidden) features;
    - MLP fc2 weight (C, hidden): input features; bias replicated;
    - the cosine-attention per-head ``logit_scale`` (H, 1, 1): heads;
    - everything else (conv stacks, norms, the input projection):
      replicated."""
    if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
        return 0
    if name.endswith("attn.proj.weight") or name.endswith("mlp.fc2.weight"):
        return 1
    if name.endswith("mlp.fc1.weight") or name.endswith("mlp.fc1.bias"):
        return 0
    if name.endswith("attn.logit_scale"):
        return 0
    return None


def encoder_param_sharding(mesh: Mesh, state: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """The split dim of every entry of an encoder state dict under ``mesh``
    (None: replicated); on a mesh without tp everything is replicated."""
    return {k: (encoder_leaf_split(k) if mesh.tp > 1 else None) for k in state}


def _shard(x: torch.Tensor, dim: int, rank: int, parts: int) -> torch.Tensor:
    if x.shape[dim] % parts:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split into {parts}")
    return x.chunk(parts, dim=dim)[rank]


def shard_encoder_state(state: Mapping[str, torch.Tensor], mesh: Mesh,
                        tp_rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The tp shard of a full encoder state dict (the port's layout, as
    ``models/convert.py::fairseq_to_torch_encoder`` gives it) that rank
    ``tp_rank`` (default: this rank's) holds. The fused qkv weight is split
    by head: a rank gets its ``H / tp`` heads of each of q, k and v, not a
    contiguous third of the fused rows (that would be all of q and part of
    k at tp 2)."""
    r = mesh.tp_rank if tp_rank is None else tp_rank
    out = {}
    for (k, v), dim in zip(state.items(), encoder_param_sharding(mesh, state).values()):
        if dim is None:
            out[k] = v
        elif k.endswith("attn.qkv.weight") or k.endswith("attn.qkv.bias"):
            q, kk, vv = v.chunk(3, dim=0)
            out[k] = torch.cat([_shard(t, 0, r, mesh.tp) for t in (q, kk, vv)], dim=0)
        else:
            out[k] = _shard(v, dim, r, mesh.tp)
    return out
