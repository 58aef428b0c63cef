"""Attention for the emotion2vec encoder: the Hopper kernel and its plain
version.

``flash_attention`` has the contract of the JAX package's Pallas wrapper:
q, k, v are (B, H, N, D) with q pre-scaled by 1/sqrt(D), ``padding_mask``
is (B, N) bool with True = padded key, and the output is (B, H, N, D) in
q's dtype. For CUDA tensors it launches the kernel of ``csrc/attention.cu``
(bf16 or f32, D = 64) or raises; it never falls back to the plain version
there. For CPU tensors it runs ``flash_attention_reference``, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernel to.

Rows whose keys are all padded (filler rows of a serving batch) are finite
in both, but differ: the plain version, like the TPU kernel, averages v
uniformly; the kernel writes 0. Only valid rows are ever read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64  # the kernel's only head dim (emotion2vec-base: 768 / 12)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T + mask * NEG) v in the TPU kernel's arithmetic: f32
    scores and softmax, p cast to v's dtype, f32 accumulation."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if padding_mask is not None:
        s = s + padding_mask[:, None, None, :].float() * _NEG
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """Builds and loads csrc/attention.cu once per process."""
    lib = cuda_build.load("attention")
    for fn in (lib.attn_fwd_bf16, lib.attn_fwd_f32):
        # q, k, v, mask, out, B, H, N, stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(q, k, v, padding_mask):
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"attention kernel needs contiguous {name}")
        if t.data_ptr() % 16:  # the kernel moves 16-byte vectors
            raise ValueError(f"attention kernel needs 16-byte aligned {name}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
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
    q: torch.Tensor,  # (B, H, N, D), pre-scaled by 1/sqrt(D)
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,  # (B, N) bool, True = pad
) -> torch.Tensor:
    """softmax(q k^T + mask) v. Returns (B, H, N, D) in q's dtype."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, N, D), got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, padding_mask)
    B, H, N, _ = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    fn = lib.attn_fwd_bf16 if q.dtype == torch.bfloat16 else lib.attn_fwd_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if padding_mask is None else padding_mask.data_ptr(),
            out.data_ptr(), B, H, N, stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches, for checks that a path ran it
