"""Fused conv + LayerNorm + GELU for the wav2vec2-style front end: the
Hopper kernel of ``csrc/conv.cu`` and its plain version.

    out[t] = GELU(LN( sum_j  x[t*s + j] @ W[j] ))

a bias-free VALID stride-s 1-D conv as k accumulated matmuls with f32
accumulation, a channel LayerNorm (two-pass f32 variance, eps 1e-5,
affine), then erf-GELU (the JAX kernel's polynomial erf) or tanh-GELU
(``approx_gelu``), stored in x's dtype. Layouts are the JAX function's:
x (B, L, C_in), w (k, C_in, C_out), scale/bias (C_out,).

For CUDA tensors ``fused_conv_ln_gelu`` launches the kernel or raises;
``conv_plan`` picks its path: the tensor-core path (TMA + wgmma) for bf16
with C_in % 64 == 0, C_out in {128, ..., 512} and s <= 4 (conv layers 1-6
of emotion2vec), the row path for bf16 with C_in = 1 (layer 0), the FMA
path for everything else (f32, other widths). For CPU tensors it runs
``fused_conv_ln_gelu_reference``. Nothing in the encoder calls it: its
path is the ops API and ``pallas_conv_stack`` over the encoder's own conv
parameters (the JAX function of that name, kept so a reader finds the
counterpart).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Sequence, Tuple

import torch

from . import cuda_build

# The tensor-core path (bf16, csrc/conv.cu conv_tc_kernel): tiles of TC_ROWS
# output rows (one wgmma M) across all C_out columns, fed by TMA through a
# ring of stages of TC_K_STEP input channels (one 128-byte swizzle row of
# bf16). The x map steps over input rows with a traversal stride of s, and a
# box spans at most 256 rows, so 64 rows need s <= TC_MAX_STRIDE. A block
# per SM walks the tiles, so that the producer fills the next tile's stages
# during the epilogue (2-7 % faster at emotion2vec's layers 1-6 than a block
# per tile on an H100, chip_smoke.py --only conv).
TC_C_OUT = (128, 256, 384, 512)
TC_ROWS = 64
TC_K_STEP = 64
TC_MAX_STRIDE = 4
TC_MAX_STAGES = 8
# The row path (bf16, C_in = 1: conv layer 0, conv_row_kernel): a warp per
# ROW_M output rows, the k <= 16 taps as one mma.sync k-step; blocks of
# ROW_WARPS warps, at most ROW_BLOCKS_PER_SM for each SM, walking the rows.
ROW_C_OUT = (256, 512)
ROW_MAX_K = 16
ROW_M = 16
ROW_WARPS = 8
ROW_BLOCKS_PER_SM = 4
# The FMA path (everything else, f32 included): rows per block, the first
# whose input window and f32 tile fit in shared memory.
FMA_ROWS = (32, 8, 1)
MAX_SMEM = 232448  # the most dynamic shared memory an H100 block may use
H100_SMS = 132


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
    # x, w, scale, bias, out, B, L, C_in, C_out, k, s, approx, then the
    # plan: stages, smem bytes, grid (tc); grid (row); dtype, rows, smem
    # bytes (fma); then the stream
    lib.conv_ln_gelu_tc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.conv_ln_gelu_row.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.conv_ln_gelu_fma.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for fn in (lib.conv_ln_gelu_tc, lib.conv_ln_gelu_row, lib.conv_ln_gelu_fma):
        fn.restype = ctypes.c_int
    return lib


def uses_tensor_cores(dtype: torch.dtype, c_in: int, c_out: int, s: int) -> bool:
    """Whether the kernel takes its tensor-core (TMA + wgmma bf16) path."""
    return (dtype == torch.bfloat16 and c_in % TC_K_STEP == 0 and c_out in TC_C_OUT
            and s <= TC_MAX_STRIDE)


class ConvPlan(NamedTuple):
    """How ``fused_conv_ln_gelu`` launches one call on the card."""
    path: str        # "tc" (TMA + wgmma), "row" (a warp per 16 rows) or "fma"
    t_out: int       # output rows per batch item
    rows: int        # output rows per tile (tc, fma) or per warp (row)
    stages: int      # ring stages (tc), else 0
    smem_bytes: int  # dynamic shared memory per block
    grid: int        # blocks


def tc_stage_bytes(c_out: int) -> int:
    """One ring stage: an A tile (64 rows x 64 channels) and a B tile (64
    channels x c_out, as c_out / 64 atoms of 64 rows x 128 bytes)."""
    return TC_ROWS * 128 + c_out // 64 * TC_K_STEP * 128


def tc_smem_bytes(c_out: int, stages: int) -> int:
    """The tensor-core kernel's shared memory (csrc/conv.cu tc_smem_bytes):
    1024 bytes to align the base, the ring, the affine pairs (a float4 per
    two columns), the LN exchange (2 x 2 x 64 floats), the barriers."""
    return 1024 + stages * tc_stage_bytes(c_out) + 8 * c_out + 1024 + 16 * stages


def fma_smem_bytes(rows: int, c_in: int, c_out: int, k: int, s: int) -> int:
    """The FMA kernel's input window and f32 tile (csrc/conv.cu)."""
    return (((rows - 1) * s + k) * c_in + rows * c_out) * 4


def conv_plan(B: int, L: int, c_in: int, c_out: int, k: int, s: int, dtype: torch.dtype,
              sms: int = H100_SMS) -> ConvPlan:
    """The path, tile, ring, shared memory and grid of one call on a card
    with ``sms`` SMs; raises if no path takes the shape."""
    t_out = out_length(L, k, s)
    if uses_tensor_cores(dtype, c_in, c_out, s):
        fixed = tc_smem_bytes(c_out, 0)
        stages = min(TC_MAX_STAGES, (MAX_SMEM - fixed) // (tc_stage_bytes(c_out) + 16))
        tiles = B * -(-t_out // TC_ROWS)
        return ConvPlan("tc", t_out, TC_ROWS, stages, tc_smem_bytes(c_out, stages),
                        min(tiles, sms))
    if dtype == torch.bfloat16 and c_in == 1 and c_out in ROW_C_OUT and k <= ROW_MAX_K:
        warps = -(-B * t_out // ROW_M)
        return ConvPlan("row", t_out, ROW_M, 0, 0,
                        min(-(-warps // ROW_WARPS), ROW_BLOCKS_PER_SM * sms))
    for rows in FMA_ROWS:
        smem = fma_smem_bytes(rows, c_in, c_out, k, s)
        if smem <= MAX_SMEM:
            return ConvPlan("fma", t_out, rows, 0, smem, B * -(-t_out // rows))
    raise ValueError(f"no conv kernel path takes C_in={c_in}, C_out={c_out}, k={k}, s={s}: "
                     f"one output row's window and tile exceed {MAX_SMEM} bytes")


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
        if t.data_ptr() % 16:  # TMA and the 16-byte vector loads
            raise ValueError(f"conv kernel needs 16-byte aligned {name}")
    if not (0 < s <= k <= L):
        raise ValueError(f"conv kernel needs 0 < s <= k <= L, got s={s}, k={k}, L={L}")
    if B > 65535:
        raise ValueError(f"grid too large: B={B}")


def launch_plan(x, w, scale, bias, k: int, s: int, approx_gelu: bool,
                plan: ConvPlan) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs, as ``plan`` says;
    counts nothing (``fused_conv_ln_gelu`` does)."""
    B, L, C_in = x.shape
    C_out = w.shape[2]
    out = torch.empty(B, plan.t_out, C_out, dtype=x.dtype, device=x.device)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    lib = _library()
    args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, L, C_in, C_out, k, s, int(approx_gelu))
    if plan.path == "tc":
        err = cuda_build.launch(lib.conv_ln_gelu_tc, x.device.index, *args, plan.stages,
                                plan.smem_bytes, plan.grid)
    elif plan.path == "row":
        err = cuda_build.launch(lib.conv_ln_gelu_row, x.device.index, *args, plan.grid)
    else:
        err = cuda_build.launch(lib.conv_ln_gelu_fma, x.device.index, *args,
                                int(x.dtype == torch.bfloat16), plan.rows, plan.smem_bytes)
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed ({plan.path} path): code {err} (> 0: a "
                           f"CUDA error; -1: no tensor-map encoder; <= -1000: the encoder "
                           f"refused a map, CUresult {-1000 - err})")
    return out


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
    plan = conv_plan(B, L, C_in, w.shape[2], k, s, x.dtype, sms=_sm_count(x.device.index))
    out = launch_plan(x, w, scale, bias, k, s, approx_gelu, plan)
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
