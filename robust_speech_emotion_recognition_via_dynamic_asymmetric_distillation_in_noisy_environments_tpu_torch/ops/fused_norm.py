"""Fused residual-add + LayerNorm (+ tanh-GELU), and a row copy: the Hopper
kernels of ``csrc/fused_norm.cu`` and their plain versions.

One function covers the three patterns of the JAX package's
``fused_layernorm``:
- ``fused_layernorm(x, scale, bias)``                        plain affine LN
- ``fused_layernorm(x, scale, bias, residual=y)``            LN(x + y)
- ``fused_layernorm(x, scale, bias, activation="gelu_tanh")`` LN then GELU

Statistics are f32 with flax's fast variance E[x^2] - E[x]^2, the output
keeps x's dtype, and the last dim is a multiple of 128. The gradient is a
``torch.autograd.Function`` whose backward is plain PyTorch that recomputes
the forward in f32, the formula of the JAX package's custom VJP (whose
backward is plain XLA as well).

For CUDA tensors the forward launches the kernel (bf16 or f32, C <= 2048)
or raises; it never falls back to the plain version there. For CPU tensors
it runs ``fused_layernorm_reference``. ``copy_rows`` is the bandwidth
yardstick the LN kernel is judged against (the TPU copy probe's
counterpart). Nothing here has a caller in the encoder: the path is the
ops API and ``ops/norm_probe.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import cuda_build

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715
MAX_FEATURES = 2048  # the kernel keeps a row in one warp's registers


def _gelu_tanh_f32(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * a * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (a + _GELU_C * a * a * a)))


def _reference_fwd_f32(x, residual, scale, bias, activation, eps):
    """The fused op in f32: returns (y, x_hat, inv, a), a being the
    pre-activation, for the forward and the recomputing backward."""
    z = x.float()
    if residual is not None:
        z = z + residual.float()
    mu = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + eps)
    x_hat = (z - mu) * inv
    a = x_hat
    if scale is not None:
        a = a * scale.float() + bias.float()
    y = _gelu_tanh_f32(a) if activation == "gelu_tanh" else a
    return y, x_hat, inv, a


def fused_layernorm_reference(x, scale=None, bias=None, residual=None, activation=None,
                              eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in x's dtype."""
    return _reference_fwd_f32(x, residual, scale, bias, activation, eps)[0].to(x.dtype)


# the LN grid mirrors csrc/fused_norm.cu: blocks of LN_WARPS warps,
# LN_ROWS_PER_WARP rows a warp
LN_WARPS = 4
LN_ROWS_PER_WARP = 2


def ln_plan(M: int) -> int:
    """Blocks of the LN grid for M rows. Warp w of the grid takes rows w,
    w + W, ... with W = blocks * LN_WARPS: LN_ROWS_PER_WARP rows a warp
    (fewer for the last warps)."""
    return max(1, -(-M // (LN_ROWS_PER_WARP * LN_WARPS)))


@functools.cache
def _library() -> ctypes.CDLL:
    """Builds and loads csrc/fused_norm.cu once per process."""
    lib = cuda_build.load("fused_norm")
    # x, res, scale, bias, out, M, C, dtype, gelu, eps, blocks, stream
    lib.fused_ln_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.fused_ln_fwd.restype = ctypes.c_int
    lib.copy_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_void_p]
    lib.copy_rows.restype = ctypes.c_int
    return lib


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"fused_norm kernel needs contiguous {name}")
    if t.data_ptr() % 16:  # 16-byte vectors and bulk copies
        raise ValueError(f"fused_norm kernel needs 16-byte aligned {name}")


def _affine(t: torch.Tensor, name: str, C: int, device: torch.device) -> torch.Tensor:
    """scale or bias as the kernel reads it: (C,) f32, contiguous, aligned
    (a copy only where the caller's tensor is not that already)."""
    if t.shape != (C,) or t.device != device:
        raise ValueError(f"{name} must be ({C},) on {device}, got {tuple(t.shape)} on {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.float().contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"fused_norm kernel needs 16-byte aligned {name}")
    return t


def _launch_ln(x, residual, scale, bias, activation, eps) -> torch.Tensor:
    """The CUDA forward: checks what the kernel takes, then launches it."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_norm kernel takes bf16 or f32, got {x.dtype}")
    C = x.shape[-1]
    if C > MAX_FEATURES:
        raise ValueError(f"fused_norm kernel takes at most {MAX_FEATURES} features, got {C}")
    device = x.device
    _check_aligned("x", x)
    res_ptr = scale_ptr = bias_ptr = None
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype or residual.device != device:
            raise ValueError(
                f"residual {tuple(residual.shape)} {residual.dtype} {residual.device} does not "
                f"match x {tuple(x.shape)} {x.dtype} {device}")
        _check_aligned("residual", residual)
        res_ptr = residual.data_ptr()
    if scale is not None:
        scale, bias = _affine(scale, "scale", C, device), _affine(bias, "bias", C, device)
        scale_ptr, bias_ptr = scale.data_ptr(), bias.data_ptr()
    out = torch.empty_like(x)
    M = x.numel() // C
    if M == 0:
        return out
    err = cuda_build.launch(_library().fused_ln_fwd, device.index, x.data_ptr(), res_ptr, scale_ptr,
                  bias_ptr, out.data_ptr(), M, C, int(x.dtype == torch.bfloat16),
                  int(activation == "gelu_tanh"), eps, ln_plan(M))
    if err != 0:
        raise RuntimeError(f"fused_norm kernel launch failed: CUDA error {err}")
    fused_layernorm.launches += 1
    return out


def _forward(x, residual, scale, bias, activation, eps) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_layernorm_reference(x, scale, bias, residual, activation, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_norm kernel for device {x.device}")
    return _launch_ln(x, residual, scale, bias, activation, eps)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, bias, activation, eps):
        ctx.save_for_backward(x, residual, scale, bias)
        ctx.activation, ctx.eps = activation, eps
        return _forward(x, residual, scale, bias, activation, eps)

    @staticmethod
    def backward(ctx, g):
        x, residual, scale, bias = ctx.saved_tensors
        _y, x_hat, inv, a = _reference_fwd_f32(x, residual, scale, bias,
                                               ctx.activation, ctx.eps)
        g = g.float()
        if ctx.activation == "gelu_tanh":
            t = torch.tanh(_SQRT_2_OVER_PI * (a + _GELU_C * a * a * a))
            g = g * (0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _SQRT_2_OVER_PI
                     * (1.0 + 3.0 * _GELU_C * a * a))
        d_scale = d_bias = None
        g_hat = g
        if scale is not None:
            rows = tuple(range(x.ndim - 1))
            d_scale = torch.sum(g * x_hat, dim=rows).to(scale.dtype)
            d_bias = torch.sum(g, dim=rows).to(bias.dtype)
            g_hat = g * scale.float()
        m1 = g_hat.mean(dim=-1, keepdim=True)
        m2 = (g_hat * x_hat).mean(dim=-1, keepdim=True)
        dz = inv * (g_hat - m1 - x_hat * m2)
        d_res = None if residual is None else dz.to(residual.dtype)
        return dz.to(x.dtype), d_res, d_scale, d_bias, None, None


def fused_layernorm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LN(x [+ residual]) [* scale + bias] [-> gelu_tanh], dtype-preserving.

    The last dim must be a multiple of 128; scale and bias come together;
    activation is None or "gelu_tanh"."""
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unsupported activation {activation!r}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias must be given together")
    if x.shape[-1] % 128 != 0:
        raise ValueError(f"feature dim {x.shape[-1]} must be a multiple of 128")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, scale, bias)):
        return _FusedLayerNorm.apply(x, residual, scale, bias, activation, eps)
    return _forward(x, residual, scale, bias, activation, eps)  # no graph to record


fused_layernorm.launches = 0  # kernel launches, for checks that a path ran it


def copy_rows(x: torch.Tensor) -> torch.Tensor:
    """A copy of x: 16-byte vectors through the kernel for CUDA tensors,
    ``x.clone()`` (the plain version) for CPU tensors."""
    if x.device.type == "cpu":
        return x.clone()
    if x.device.type != "cuda":
        raise ValueError(f"no copy kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("copy kernel needs a contiguous, 16-byte aligned tensor")
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    err = cuda_build.launch(_library().copy_rows, x.device.index, x.data_ptr(), out.data_ptr(), nbytes)
    if err != 0:
        raise RuntimeError(f"copy kernel launch failed: CUDA error {err}")
    copy_rows.launches += 1
    return out


copy_rows.launches = 0
