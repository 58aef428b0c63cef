"""d2v's optimizer step and EMA update as one multi-tensor pass on the card:
the wrapper of ``csrc/d2v_update.cu`` and its launch plan.

``fused_update`` takes the student's leaves (f32), their gradients (f32, or
None for a leaf without one, read as zeros), Adam's moments (the first in
f32 or bf16, the second in f32), the teacher's EMA copies of some leaves
(f32 or bf16), Adam's constants (``Hyper``), the step's scalars on the
device (-lr, the bias corrections and the EMA decay, which the caller
computes with the per-leaf code's functions) and, where the gradients are
a shard, their global norm. It returns the new leaves, moments and EMA
copies, computed on the device without a host-device sync. The
arithmetic is ``models/d2v_pretrain.py``'s per-leaf update
(``D2vOptimizer.update`` and the EMA of ``optimizer_and_ema_per_leaf``),
operation for operation; that code is the plain version, which the CPU
runs and the card tests hold the kernel to. For tensors off the card this
raises; ``models/d2v_pretrain.py::optimizer_and_ema`` chooses.

The outputs are one flat buffer each for the leaves, the two moments and
the EMA copies, handed back as per-leaf views; no input is written. The
leaf table goes to the kernels as their parameters, cut by ``update_plan``
into launches of at most ``MAX_LEAVES`` leaves, so nothing is copied to the
device for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._utils import _unflatten_dense_tensors

from . import cuda_build

Params = Dict[str, torch.Tensor]

# csrc/d2v_update.cu's constants of the same names
CHUNK = 16384  # elements a block
MAX_LEAVES = 52  # leaves a launch (the kernel parameters' table)
# the constants' order in csrc/d2v_update.cu's HyperIndex
HYPER = ("one_minus_b1", "b1_mu", "one_minus_b2", "b2", "eps", "weight_decay", "max_norm")
STORED = (torch.float32, torch.bfloat16)  # the first moment's and the EMA's types


class Hyper(NamedTuple):
    """Adam's constants and the clip (``D2vOptimizer``'s fields)."""

    b1: float
    b2: float
    eps: float
    weight_decay: float
    max_norm: float


def hyper_values(h: Hyper, mu_dtype: torch.dtype) -> np.ndarray:
    """The kernel's f32 constants in ``HYPER`` order: each Python number
    of the per-leaf code rounded to f32, as PyTorch's kernels take it; b1
    also rounded to the first moment's type (optax's weakly typed
    scalar)."""
    values = dict(one_minus_b1=1 - h.b1, b1_mu=float(torch.tensor(h.b1, dtype=mu_dtype)),
                  one_minus_b2=1 - h.b2, b2=h.b2, eps=h.eps, weight_decay=h.weight_decay,
                  max_norm=h.max_norm)
    return np.array([values[k] for k in HYPER], dtype=np.float32)


def update_plan(numels: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The launches over leaves of these sizes: (first_block, launches).
    ``launches`` has a row (first leaf, end leaf, grid, first partial) a
    launch, the leaves cut into equal runs of at most ``MAX_LEAVES``; a leaf
    takes ceil(numel / CHUNK) blocks, ``first_block`` its first within its
    launch. Block b of a launch takes elements [c CHUNK, (c + 1) CHUNK) of
    the last leaf whose first block is <= b, c = b - that first block."""
    n = len(numels)
    blocks = [-(-int(x) // CHUNK) for x in numels]
    n_launches = -(-n // MAX_LEAVES)
    first_block = np.zeros(n, np.int32)
    launches = np.zeros((n_launches, 4), np.int32)
    partial = 0
    for j in range(n_launches):
        lo, hi = j * n // n_launches, (j + 1) * n // n_launches
        grid = 0
        for i in range(lo, hi):
            first_block[i] = grid
            grid += blocks[i]
        if partial + grid >= 2**31:
            raise ValueError(f"d2v_update kernel: {partial + grid} blocks exceed a grid")
        launches[j] = (lo, hi, grid, partial)
        partial += grid
    return first_block, launches


@functools.cache
def _library() -> ctypes.CDLL:
    """Builds and loads csrc/d2v_update.cu once per process."""
    lib = cuda_build.load("d2v_update")
    # leaves, n_leaves, first_block, launches, n_launches, mu_bf16, ema_bf16,
    # out p, mu, nu, ema, scratch, n_partials, norm, neg_lr, c1, c2, decay,
    # hyper, n_hyper, stream
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.d2v_update.argtypes = [p, i, p, p, i, i, i, p, p, p, p, p, i, p, p, p, p, p, p, i, p]
    lib.d2v_update.restype = ctypes.c_int
    return lib


def _checked(what: str, t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``t`` as the kernel reads it: contiguous (a copy where it is not, as
    a tensor-parallel shard of a row-parallel weight is not)."""
    if t.dtype != dtype:
        raise TypeError(
            f"d2v_update kernel takes f32 parameters, gradients and second moments, and the "
            f"first moment and the EMA copies each in one of f32 and bf16, the first moment "
            f"stored in its own type: {what} is {t.dtype}, expected {dtype}")
    if t.shape != like.shape or t.device != device:
        raise ValueError(f"d2v_update kernel: {what} must be {tuple(like.shape)} on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _scalar(what: str, t: torch.Tensor, device: torch.device) -> int:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"d2v_update kernel: {what} must be one f32 on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def fused_update(params: Params, grads: Dict[str, Optional[torch.Tensor]], mu: Params,
                 nu: Params, ema: Params, hyper: Hyper, mu_dtype: torch.dtype,
                 neg_lr: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, decay: torch.Tensor,
                 norm: Optional[torch.Tensor] = None) -> Tuple[Params, Params, Params, Params]:
    """One optimizer step and EMA update of every leaf on the card ->
    (params', mu', nu', ema'), dicts keyed and ordered as the inputs.
    ``mu_dtype``: the type the first moment is stored in, which must be its
    input type. ``neg_lr``, ``c1``, ``c2``, ``decay``: the step's -lr, bias
    corrections and EMA decay (``D2vOptimizer.schedule``,
    ``annealed_decay``), one f32 each on the card. ``norm``: the
    gradients' global norm where ``grads`` is a shard of them, else taken
    over ``grads``. Raises on types, shapes or devices the kernel does not
    take."""
    if not params:
        raise ValueError("d2v_update kernel: no parameters")
    ema_dtype = next(iter(ema.values())).dtype if ema else torch.float32
    if mu_dtype not in STORED or ema_dtype not in STORED:
        raise TypeError(f"d2v_update kernel stores the first moment and the EMA copies in f32 "
                        f"or bf16, got {mu_dtype} and {ema_dtype}")
    f32 = torch.float32
    device = next(iter(params.values())).device
    e_off, n_ema = {}, 0
    for k, e in ema.items():
        if k not in params:
            raise ValueError(f"d2v_update kernel: EMA copy {k} has no parameter")
        e_off[k] = n_ema
        n_ema += e.numel()
    rows, off, held = [], 0, []
    for k, like in params.items():
        g, e = grads[k], ema.get(k)
        p = _checked(f"parameter {k}", like, like, f32, device)
        v = _checked(f"second moment {k}", nu[k], like, f32, device)
        m = _checked(f"first moment {k}", mu[k], like, mu_dtype, device)
        if g is not None:
            g = _checked(f"gradient {k}", g, like, f32, device)
        if e is not None:
            e = _checked(f"EMA copy {k}", e, like, ema_dtype, device)
        held.append((g, p, m, v, e))  # the contiguous copies, until the launch
        n = p.numel()
        rows.append((0 if g is None else g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                     0 if e is None else e.data_ptr(), off, e_off.get(k, 0), n))
        off += n
    if device.type != "cuda":
        raise ValueError(f"d2v_update kernel runs on CUDA tensors, got {device}; the per-leaf "
                         f"update (models/d2v_pretrain.py) is the CPU's")
    scalars = [_scalar(what, t, device) for what, t in
               (("-lr", neg_lr), ("c1", c1), ("c2", c2), ("decay", decay))]
    norm_ptr = None if norm is None else _scalar("norm", norm, device)

    table = np.array(rows, dtype=np.int64)
    first_block, launches = update_plan(table[:, 7])
    n_partials = 0 if norm is not None else int(launches[:, 2].sum())
    out_p = torch.empty(off, dtype=f32, device=device)
    out_m = torch.empty(off, dtype=mu_dtype, device=device)
    out_v = torch.empty(off, dtype=f32, device=device)
    out_e = torch.empty(n_ema, dtype=ema_dtype, device=device)
    # the partials and the norm they give
    scratch = None if norm is not None else torch.empty(n_partials + 1, dtype=f32, device=device)
    hyper_f32 = hyper_values(hyper, mu_dtype)
    err = cuda_build.launch(
        _library().d2v_update, device.index, table.ctypes.data, len(table),
        first_block.ctypes.data, launches.ctypes.data, len(launches),
        int(mu_dtype == torch.bfloat16), int(ema_dtype == torch.bfloat16), out_p.data_ptr(),
        out_m.data_ptr(), out_v.data_ptr(), out_e.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_partials, norm_ptr, *scalars,
        hyper_f32.ctypes.data, len(hyper_f32))
    if err != 0:
        raise RuntimeError(f"d2v_update kernel launch failed: CUDA error {err}")
    used = int((launches[:, 2] > 0).sum())
    fused_update.launches += used if norm is not None else 2 * used + 1

    keys, likes = list(params), list(params.values())

    def leaves(flat, keys_, likes_):
        return dict(zip(keys_, _unflatten_dense_tensors(flat, likes_)))

    return (leaves(out_p, keys, likes), leaves(out_m, keys, likes), leaves(out_v, keys, likes),
            leaves(out_e, list(ema), list(ema.values())))


fused_update.launches = 0  # kernel launches, for checks that a path ran it
