"""Attention for the emotion2vec encoder: the Hopper kernel and its plain
version.

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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64  # the kernel's only head dim (emotion2vec-base: 768 / 12)
STRIDE_MULTIPLE = 8  # elements: 16 bytes in bf16, what a TMA tensor map takes


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """softmax(scale * q k^T + mask * NEG) v in the TPU kernel's arithmetic:
    f32 scores and softmax, p cast to v's dtype, f32 accumulation."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
    for fn in (lib.attn_fwd_bf16, lib.attn_fwd_f32):
        # q, k, v, mask, out, B, H, N, strides, scale, stream
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
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


def flash_attention(
    q: torch.Tensor,  # (B, H, N, D), pre-scaled by 1/sqrt(D) unless scale says otherwise
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,  # (B, N) bool, True = pad
    scale: float = 1.0,
) -> torch.Tensor:
    """softmax(scale * q k^T + mask) v. Returns (B, H, N, D) in q's dtype,
    the transpose view of a contiguous (B, N, H, D) buffer."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, N, D), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        out = _empty_output(q)
        out.copy_(flash_attention_reference(q, k, v, padding_mask, scale))
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
    fn = lib.attn_fwd_bf16 if q.dtype == torch.bfloat16 else lib.attn_fwd_f32
    err = cuda_build.launch(
        fn, q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if padding_mask is None else padding_mask.data_ptr(),
        out.data_ptr(), B, H, N, (ctypes.c_longlong * 12)(*strides), float(scale),
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: code {err} (> 0: a CUDA "
                           f"error; -1: no tensor-map encoder; <= -1000: the encoder "
                           f"refused a map, CUresult {-1000 - err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches, for checks that a path ran it
