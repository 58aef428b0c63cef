"""Fused conv + LayerNorm + GELU for the wav2vec2-style front end: the
Hopper kernel of ``csrc/conv.cu`` and its plain version.

    out[t] = GELU(LN( sum_j  x[t*s + j] @ W[j] ))

a bias-free VALID stride-s 1-D conv as k accumulated matmuls with f32
accumulation, a channel LayerNorm (two-pass f32 variance, eps 1e-5,
affine), then erf-GELU (the JAX kernel's polynomial erf) or tanh-GELU
(``approx_gelu``), stored in x's dtype. Layouts are the JAX function's:
x (B, L, C_in), w (k, C_in, C_out), scale/bias (C_out,).

For CUDA tensors ``fused_conv_ln_gelu`` launches the kernel or raises:
the tensor-core path for bf16 with C_in % 32 == 0 and C_out in {128, ...,
512} (conv layers 1-6 of emotion2vec), the FMA path for everything else
(layer 0's C_in = 1, f32). For CPU tensors it runs
``fused_conv_ln_gelu_reference``. Nothing in the encoder calls it: its
path is the ops API and ``pallas_conv_stack`` over the encoder's own conv
parameters (the JAX function of that name, kept so a reader finds the
counterpart).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Sequence, Tuple

import torch

from . import cuda_build

WMMA_C_OUT = (128, 256, 384, 512)
WMMA_K_CHUNK = 32


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (|err| <= 1.5e-7), the JAX kernel's."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + erf_poly(x * 0.7071067811865476))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def out_length(L: int, k: int, s: int) -> int:
    return (L - k) // s + 1


def fused_conv_ln_gelu_reference(x, w, scale, bias, k: int, s: int,
                                 approx_gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch version: k f32 matmuls over strided views of x,
    then the f32 LN and GELU, cast to x's dtype."""
    t_out = out_length(x.shape[1], k, s)
    xf, wf = x.float(), w.float()
    acc = None
    for j in range(k):
        part = xf[:, j : j + s * (t_out - 1) + 1 : s, :] @ wf[j]
        acc = part if acc is None else acc + part
    mean = acc.mean(dim=-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (acc - mean) * torch.rsqrt(var + 1e-5)
    normed = normed * scale.float() + bias.float()
    return (gelu_tanh(normed) if approx_gelu else gelu_erf(normed)).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """Builds and loads csrc/conv.cu once per process."""
    lib = cuda_build.load("conv")
    # x, w, scale, bias, out, B, L, C_in, C_out, k, s, approx, stream
    lib.conv_ln_gelu_wmma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                      + [ctypes.c_void_p])
    # ... with dtype before approx
    lib.conv_ln_gelu_fma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
    for fn in (lib.conv_ln_gelu_wmma, lib.conv_ln_gelu_fma):
        fn.restype = ctypes.c_int
    return lib


def uses_tensor_cores(dtype: torch.dtype, c_in: int, c_out: int) -> bool:
    """Whether the kernel takes its tensor-core (WMMA bf16) path."""
    return dtype == torch.bfloat16 and c_in % WMMA_K_CHUNK == 0 and c_out in WMMA_C_OUT


def _check_cuda_inputs(x, w, scale, bias, k, s):
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"x must be (B, L, C_in) and w (k, C_in, C_out), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, L, C_in = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv kernel takes bf16 or f32, got {x.dtype}")
    if w.dtype != x.dtype or w.device != x.device or tuple(w.shape[:2]) != (k, C_in):
        raise ValueError(f"w {tuple(w.shape)} {w.dtype} {w.device} does not match "
                         f"(k={k}, C_in={C_in}) {x.dtype} {x.device}")
    C_out = w.shape[2]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (C_out,) or t.device != x.device:
            raise ValueError(f"{name} must be ({C_out},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"conv kernel needs contiguous {name}")
        if t.data_ptr() % 16:  # the tensor-core path moves 16-byte vectors
            raise ValueError(f"conv kernel needs 16-byte aligned {name}")
    if not (0 < s <= k <= L):
        raise ValueError(f"conv kernel needs 0 < s <= k <= L, got s={s}, k={k}, L={L}")
    if B > 65535:
        raise ValueError(f"grid too large: B={B}")


def fused_conv_ln_gelu(
    x: torch.Tensor,  # (B, L, C_in)
    w: torch.Tensor,  # (k, C_in, C_out): the conv taps as k matmul weights
    scale: torch.Tensor,  # (C_out,)
    bias: torch.Tensor,  # (C_out,)
    k: int,
    s: int,
    approx_gelu: bool = False,
) -> torch.Tensor:
    """VALID conv (stride s) + LayerNorm + GELU in one kernel."""
    if x.device.type == "cpu":
        return fused_conv_ln_gelu_reference(x, w, scale, bias, k, s, approx_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    _check_cuda_inputs(x, w, scale, bias, k, s)
    B, L, C_in = x.shape
    C_out = w.shape[2]
    out = torch.empty(B, out_length(L, k, s), C_out, dtype=x.dtype, device=x.device)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, L, C_in, C_out, k, s)
        if uses_tensor_cores(x.dtype, C_in, C_out):
            err = lib.conv_ln_gelu_wmma(*args, int(approx_gelu), stream)
        else:
            err = lib.conv_ln_gelu_fma(*args, int(x.dtype == torch.bfloat16),
                                       int(approx_gelu), stream)
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: CUDA error {err}")
    fused_conv_ln_gelu.launches += 1
    return out


fused_conv_ln_gelu.launches = 0  # kernel launches, for checks that a path ran it


def conv_layer_params(params: Mapping[str, torch.Tensor], i: int,
                      dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w (k, C_in, C_out) in ``dtype``, scale, bias f32) of layer i from the
    port's ``ConvFeatureExtractor`` state dict, whose conv weight is torch's
    (C_out, C_in, k)."""
    w = params[f"conv_{i}.weight"].permute(2, 1, 0).to(dtype).contiguous()
    return w, params[f"ln_{i}.weight"].float(), params[f"ln_{i}.bias"].float()


def pallas_conv_stack(
    x: torch.Tensor,  # (B, T', C): output of the first layer's conv+LN+GELU
    params: Mapping[str, torch.Tensor],  # ConvFeatureExtractor state dict
    conv_layers: Sequence[Tuple[int, int, int]],
) -> torch.Tensor:
    """Runs layers 1..N-1 of the extractor through the fused kernel (erf
    GELU); layer 0 (C_in = 1) is the caller's, as in the JAX package."""
    for i, (_dim, k, s) in enumerate(conv_layers):
        if i == 0:
            continue
        w, scale, bias = conv_layer_params(params, i, x.dtype)
        x = fused_conv_ln_gelu(x, w, scale, bias, k, s)
    return x
