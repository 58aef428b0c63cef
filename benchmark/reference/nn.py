"""Plain float32 building blocks over (B, T, C) tensors.

Every matmul and convolution takes its two operands through ``q``: the
identity for the reference, ``fp8`` for the control, which computes the
same model with both operands rounded to float8 e4m3 (the precision below
the configurations' bfloat16)."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]
E4M3_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude to the format's largest), back in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(x, w, b, q: Q):
    return F.linear(q(x), q(w), b)


def conv_btc(x, w, b, q: Q, stride: int = 1, padding: int = 0, groups: int = 1):
    """A 1-D convolution over (B, T, C)."""
    y = F.conv1d(q(x.transpose(1, 2)), q(w), b, stride, padding, 1, groups)
    return y.transpose(1, 2)


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gelu(x):
    return F.gelu(x)  # the exact erf form


def dropout(x, keep: Optional[torch.Tensor], rate: float):
    """Kept values scaled by 1 / (1 - rate), the rest zero."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def out_lengths(lengths: torch.Tensor, conv_layers: Sequence[Sequence[int]]) -> torch.Tensor:
    """Valid frames out of the conv front end: floor((L - k) / s + 1) a layer."""
    out = lengths
    for _dim, k, s in conv_layers:
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return out


def front_end(wav, p: dict, conv_keys, conv_layers, q: Q):
    """The conv feature extractor: per layer conv (no bias), LayerNorm over
    channels (f32, eps 1e-5), GELU. (B, T) -> (B, T', C)."""
    x = wav[:, :, None]
    for i, (_dim, _k, s) in enumerate(conv_layers):
        w, ln_w, ln_b = conv_keys(i)
        x = gelu(layer_norm(conv_btc(x, p[w], None, q, stride=s), p[ln_w], p[ln_b], 1e-5))
    return x


def positional(x, frame_mask, weights, q: Q, groups: int):
    """The grouped-conv positional encoder: per layer, padded frames zeroed,
    conv ('same' padding, the trailing frame trimmed for an even kernel),
    LayerNorm without affine (eps 1e-5), GELU. Returns the encoding."""
    keep = None if frame_mask is None else (~frame_mask).to(x.dtype)[..., None]
    for w, b in weights:
        if keep is not None:
            x = x * keep
        k = w.shape[-1]
        x = conv_btc(x, w, b, q, padding=k // 2, groups=groups)
        if k % 2 == 0:
            x = x[:, :-1]
        x = gelu(layer_norm(x, None, None, 1e-5))
    return x


def block(x, frame_mask, p: dict, pre: str, heads: int, eps: float, q: Q,
          keeps=None, rates=(0.0, 0.0, 0.0)):
    """A post-LN transformer block: x + attention, LayerNorm, MLP (GELU),
    LayerNorm of the residual sum. ``keeps``: the dropout keep masks of the
    attention probabilities, the attention output and the MLP output (in
    that order), at ``rates``. Returns (x, the MLP output before its
    dropout)."""
    B, N, C = x.shape
    dh = C // heads
    qkv = linear(x, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"], q)
    qkv = qkv.reshape(B, N, 3, heads, dh)
    qh, kh, vh = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, dh)
    s = torch.matmul(q(qh * dh ** -0.5), q(kh).transpose(-1, -2))
    if frame_mask is not None:
        s = s.masked_fill(frame_mask[:, None, None, :], torch.finfo(s.dtype).min / 2)
    a = torch.softmax(s, dim=-1)
    k_attn, k_proj, k_post = keeps if keeps is not None else (None, None, None)
    a = dropout(a, k_attn, rates[0])
    o = torch.matmul(q(a), q(vh)).transpose(1, 2).reshape(B, N, C)
    o = dropout(linear(o, p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"], q),
                k_proj, rates[1])
    x = x + o
    r = layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], eps)
    h = gelu(linear(r, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"], q))
    t = linear(h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"], q)
    x = layer_norm(r + dropout(t, k_post, rates[2]), p[f"{pre}.norm2.weight"],
                   p[f"{pre}.norm2.bias"], eps)
    return x, t
