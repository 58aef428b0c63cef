"""Attention for the encoders: the Hopper kernel and its plain version.

``flash_attention`` has the contract of the JAX package's Pallas wrapper:
q, k, v are (B, H, N, D) with q pre-scaled by 1/sqrt(D), ``padding_mask``
is (B, N) bool with True = padded key, and the output is (B, H, N, D) in
q's dtype. ``scale`` (default 1) multiplies the f32 scores instead, so a
caller may pass q unscaled. For CUDA tensors it launches the kernel of
``csrc/attention.cu`` (bf16 or f32, D = 64) or raises; it never falls back
to the plain version there. For CPU tensors it runs
``flash_attention_reference``, the plain PyTorch version that the tests
and ``chip_smoke.py`` hold the kernel to.

Layouts: q, k and v may be strided (B, H, N, D) views, as long as
``attention_strides`` accepts them (unit last stride, other strides
multiples of 8 elements, 16-byte aligned base): the encoder's
``qkv[:, :, i].transpose(1, 2)`` views of its (B, N, 3, H, D) projection
are read in place. The output is always the (B, H, N, D) transpose view of
a contiguous (B, N, H, D) buffer, on the CPU too, so that
``out.transpose(1, 2).reshape(B, N, H * D)`` costs no copy.

Rows whose keys are all padded (filler rows of a serving batch) are finite
in both, but differ: the plain version, like the TPU kernel, averages v
uniformly; the kernel writes 0. Only valid rows are ever read.

``rel_bias=(table, gate)`` adds WavLM's gated relative position bias to the
scaled scores, before the mask: ``gate[b, h, q] * table[h, k - q + N - 1]``
with ``table`` (H, 2N - 1) float32, contiguous, and ``gate`` (B, H, N)
float32 through any strides (``models/wavlm.py`` passes the transpose view
of a (B, N, H) buffer). The kernel reads the two factors and never forms the
(B, H, N, N) bias; the plain version materialises it. A biased launch is
counted on ``flash_attention.biased_launches`` as well as on ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64  # the kernel's only head dim (emotion2vec base 768 / 12, WavLM 1024 / 16)
STRIDE_MULTIPLE = 8  # elements: 16 bytes in bf16, what a TMA tensor map takes


RelBias = Tuple[torch.Tensor, torch.Tensor]  # (table (H, 2N - 1), gate (B, H, N))


def relative_bias(table: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The (B, H, N, N) float32 bias gate[b, h, q] * table[h, k - q + N - 1]."""
    N = gate.shape[-1]
    pos = torch.arange(N, device=table.device)
    rel = pos[None, :] - pos[:, None] + (N - 1)  # (q, k) -> table column
    return gate.float()[..., None] * table.float()[:, rel][None]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    rel_bias: Optional[RelBias] = None,
) -> torch.Tensor:
    """softmax(scale * q k^T + bias + mask * NEG) v in the TPU kernel's
    arithmetic: f32 scores and softmax, p cast to v's dtype, f32
    accumulation; ``rel_bias`` materialised by ``relative_bias``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if rel_bias is not None:
        s = s + relative_bias(*rel_bias)
    if padding_mask is not None:
        s = s + padding_mask[:, None, None, :].float() * _NEG
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_strides(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """Element strides (b, h, n) of a (B, H, N, D) operand the kernel reads
    in place; raises unless its last stride is 1, its other strides are
    multiples of STRIDE_MULTIPLE elements and its base is 16-byte aligned.
    A dimension of size 1 reports its contiguous stride: nothing steps
    along it."""
    B, H, N, D = t.shape
    if t.stride(3) != 1:
        raise ValueError(f"attention kernel needs {name} with last stride 1, "
                         f"got strides {t.stride()}")
    contiguous = (H * N * D, N * D, D)
    strides = tuple(c if size == 1 else s
                    for s, size, c in zip(t.stride()[:3], (B, H, N), contiguous))
    if any(s % STRIDE_MULTIPLE for s in strides):
        raise ValueError(f"attention kernel needs {name}'s strides to be multiples of "
                         f"{STRIDE_MULTIPLE} elements, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel needs 16-byte aligned {name}")
    return strides


def _empty_output(q: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) transpose view of a contiguous (B, N, H, D) buffer."""
    B, H, N, D = q.shape
    return torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


@functools.cache
def _library() -> ctypes.CDLL:
    """Builds and loads csrc/attention.cu once per process."""
    lib = cuda_build.load("attention")
    strides = ctypes.POINTER(ctypes.c_longlong)
    # q, k, v, mask, out, B, H, N, strides, scale
    common = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [strides, ctypes.c_float]
    for fn in (lib.attn_fwd_bf16, lib.attn_fwd_f32):
        fn.argtypes = common + [ctypes.c_void_p]  # stream
        fn.restype = ctypes.c_int
    for fn in (lib.attn_fwd_relbias_bf16, lib.attn_fwd_relbias_f32):
        # table, gate, gate strides, stream
        fn.argtypes = common + [ctypes.c_void_p, ctypes.c_void_p, strides, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(q, k, v, padding_mask, scale):
    B, H, N, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16 or f32, got {q.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    if not scale > 0:  # the bf16 kernel takes the row max before scaling
        raise ValueError(f"attention kernel needs scale > 0, got {scale}")
    if padding_mask is not None:
        if (padding_mask.shape != (B, N) or padding_mask.dtype != torch.bool
                or padding_mask.device != q.device
                or not padding_mask.is_contiguous()):
            raise ValueError(
                f"padding_mask must be contiguous bool ({B}, {N}) on {q.device}, "
                f"got {tuple(padding_mask.shape)} {padding_mask.dtype} "
                f"{padding_mask.device}"
            )


def _check_rel_bias(q: torch.Tensor, rel_bias: RelBias) -> None:
    B, H, N, _ = q.shape
    table, gate = rel_bias
    for name, t, shape in (("table", table, (H, 2 * N - 1)), ("gate", gate, (B, H, N))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"rel_bias {name} must be float32 {shape} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if not table.is_contiguous():
        raise ValueError("rel_bias table must be contiguous")


def flash_attention(
    q: torch.Tensor,  # (B, H, N, D), pre-scaled by 1/sqrt(D) unless scale says otherwise
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,  # (B, N) bool, True = pad
    scale: float = 1.0,
    rel_bias: Optional[RelBias] = None,  # (table (H, 2N - 1), gate (B, H, N)), f32
) -> torch.Tensor:
    """softmax(scale * q k^T + bias + mask) v. Returns (B, H, N, D) in q's
    dtype, the transpose view of a contiguous (B, N, H, D) buffer."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, N, D), got {tuple(q.shape)}")
    if rel_bias is not None:
        _check_rel_bias(q, rel_bias)
    if q.device.type == "cpu":
        out = _empty_output(q)
        out.copy_(flash_attention_reference(q, k, v, padding_mask, scale, rel_bias))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, padding_mask, scale)
    B, H, N, _ = q.shape
    out = _empty_output(q)
    if out.numel() == 0:
        return out
    strides = [s for name, t in (("q", q), ("k", k), ("v", v), ("out", out))
               for s in attention_strides(t, name)]
    lib = _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), B, H, N, (ctypes.c_longlong * 12)(*strides), float(scale))
    bf16 = q.dtype == torch.bfloat16
    if rel_bias is None:
        fn = lib.attn_fwd_bf16 if bf16 else lib.attn_fwd_f32
    else:
        table, gate = rel_bias
        fn = lib.attn_fwd_relbias_bf16 if bf16 else lib.attn_fwd_relbias_f32
        args += (table.data_ptr(), gate.data_ptr(), (ctypes.c_longlong * 3)(*gate.stride()))
    err = cuda_build.launch(fn, q.device.index, *args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: code {err} (> 0: a CUDA "
                           f"error; -1: no tensor-map encoder; <= -1000: the encoder "
                           f"refused a map, CUresult {-1000 - err})")
    flash_attention.launches += 1
    if rel_bias is not None:
        flash_attention.biased_launches += 1
    return out


flash_attention.launches = 0  # kernel launches, for checks that a path ran it
flash_attention.biased_launches = 0  # those of them with rel_bias
