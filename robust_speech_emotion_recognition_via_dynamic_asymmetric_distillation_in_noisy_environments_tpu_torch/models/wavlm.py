"""WavLM's encoder (arXiv:2110.13900; the pre-LN "stable layer norm" form
of transformers' ``WavLMModel``, which WavLM Large uses), frozen, for
serving and extraction:

    wav -> 7 x (conv, channel LayerNorm, GELU) -> LayerNorm(512) -> Linear
        -> padded frames zeroed -> x + GELU(grouped conv, kernel 128, the
           last frame dropped)
        -> 24 x [x + attention(LN(x), gated relative position bias);
                 x + FFN(LN(x))]
        -> LayerNorm

The features are the weighted layer sum of the SUPERB recipe
(``WavLMForSequenceClassification`` with ``use_weighted_layer_sum``):
softmax(w) over the 25 hidden states, h_0 the first layer's input, h_1 ..
h_23 the first 23 layers' outputs and h_24 the final LayerNorm's output,
accumulated as the layers run.

The relative position bias: T5-style bidirectional buckets of r = k - q
(``relative_buckets``) index a (num_buckets, H) embedding, held once and
shared by every layer; each layer gates it per query row with
g[b, h, q] = a (b' c_h - 1) + 2, where (a, b') = sigmoid of a 64 -> 8
projection of the row's head slice of the layer's normed input, summed in
two groups of 4, and c_h is the layer's per-head constant. The scores are
q.k / sqrt(64) + g[b, h, q] * E[bucket(k - q), h]. The bias factors into
``position_table`` (H, 2N - 1), built once a batch, and the gate (B, H, N),
built per layer in float32, which the attention kernel
(``ops/attention.py``, ``rel_bias``) combines in registers.

Precision: parameters are float32 and cast to the compute dtype at use
(``layers.Dense``); the residual stream, the LayerNorms, the gate and the
layer sum are float32. Spans (``utils/profiling.py``):
``wavlm.position_bias`` (the table's build; ``frames``) and
``wavlm.encoder`` (the forward's issue; ``rows`` and ``frames``, from
shapes: the forward reads nothing back from the device; each row's
length is on the serving path's ``serving.assemble`` span, ``samples``).
Tensor parallelism is not supported (``parallel/fused.py`` refuses it).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import EncoderConfig
from ..ops.attention import flash_attention, flash_attention_reference
from ..utils import profiling
from .emotion2vec import torch_dtype
from .layers import (
    FLASH_AUTO_MIN_FRAMES,
    Conv,
    ConvFeatureExtractor,
    Dense,
    Mlp,
    convert_padding_mask,
    make_norm,
)


def relative_buckets(rel: torch.Tensor, num_buckets: int = 320,
                     max_distance: int = 800) -> torch.Tensor:
    """Bucket of each relative position ``rel`` = k - q (int64), the
    operations of transformers' ``WavLMAttention._relative_positions_bucket``
    one for one: half the buckets for r > 0, exact buckets below half of a
    half, log-spaced ones up to ``max_distance``, float32 logs."""
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = torch.abs(rel)
    max_exact = half // 2
    large = torch.log(rel.float() / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = (max_exact + large * (half - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, half - 1))
    return buckets + torch.where(rel < max_exact, rel, large)


@functools.lru_cache(maxsize=64)
def _bucket_columns(n: int, num_buckets: int, max_distance: int,
                    device: torch.device) -> torch.Tensor:
    """The buckets of r = -(n - 1) .. n - 1 on ``device``, computed on the
    CPU as transformers computes them (a device's float32 log may round
    otherwise; r = 713 lies 4e-5 from a bucket's edge)."""
    rel = torch.arange(-(n - 1), n, dtype=torch.long)
    return relative_buckets(rel, num_buckets, max_distance).to(device)


def position_table(embed: torch.Tensor, n: int, num_buckets: int,
                   max_distance: int) -> torch.Tensor:
    """(H, 2n - 1) float32, contiguous: column r + n - 1 holds the
    embedding of bucket(r) for r = k - q. ``embed``: (num_buckets, H)."""
    cols = _bucket_columns(n, num_buckets, max_distance, embed.device)
    return embed.float()[cols].t().contiguous()


def relative_gate(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  const: torch.Tensor) -> torch.Tensor:
    """The gate (B, N, H) float32 from the normed input's head slices ``x``
    (B, N, H, Dh): a 64 -> 8 projection (``weight`` (8, Dh), ``bias``),
    summed in two groups of 4, through a sigmoid to (a, b), then
    a (b c_h - 1) + 2 with ``const`` (H,)."""
    p = F.linear(x.float(), weight.float(), bias.float())
    a, b = torch.sigmoid(p.view(*p.shape[:-1], 2, 4).sum(-1)).unbind(-1)
    return a * (b * const.float() - 1.0) + 2.0


class WavLMAttention(nn.Module):
    """Self-attention with the gated relative position bias: fused qkv, the
    gate's 64 -> 8 projection (``gate``, float32) and per-head constant
    (``gate_const``), the output projection. ``use_flash`` True, or "auto"
    at N >= ``FLASH_AUTO_MIN_FRAMES``, runs the biased kernel; otherwise the
    plain version, which materialises the (B, H, N, N) bias."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 use_flash=True):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.use_flash = use_flash
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.gate = Dense(self.head_dim, 8, torch.float32)
        self.gate_const = nn.Parameter(torch.ones(num_heads))

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                table: torch.Tensor) -> torch.Tensor:
        """``x``: the layer's normed input (B, N, C), float32."""
        B, N, C = x.shape
        H, Dh = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, N, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, Dh) views
        gate = relative_gate(x.view(B, N, H, Dh), self.gate.weight, self.gate.bias,
                             self.gate_const)
        rel_bias = (table, gate.transpose(1, 2))  # the gate as a (B, H, N) view
        flash = self.use_flash is True or (self.use_flash == "auto"
                                           and N >= FLASH_AUTO_MIN_FRAMES)
        attend = flash_attention if flash else flash_attention_reference
        out = attend(q, k, v, padding_mask, Dh**-0.5, rel_bias)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class WavLMLayer(nn.Module):
    """A pre-LN layer: x + attention(LN(x)), then x + FFN(LN(x)) (exact
    GELU), on a float32 residual stream."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        E = cfg.embed_dim
        self.norm1 = make_norm(cfg.fast_ln, cfg.norm_eps, E)
        self.attn = WavLMAttention(E, cfg.num_heads, dtype, cfg.use_flash_attention)
        self.norm2 = make_norm(cfg.fast_ln, cfg.norm_eps, E)
        self.mlp = Mlp(E, int(E * cfg.mlp_ratio), E, 0.0, dtype, cfg.gelu_approximate)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                table: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).float(), padding_mask, table)
        return x + self.mlp(self.norm2(x).to(self.dtype))


class WavLMEncoder(nn.Module):
    """WavLM's frozen encoder: (B, T) waveform -> (the weighted layer sum
    (B, T', C) float32, the frame mask)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.arch != "wavlm":
            raise ValueError(f"WavLMEncoder needs arch 'wavlm', got {cfg.arch!r}")
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        E, feat_dim = cfg.embed_dim, cfg.conv_feature_layers[-1][0]
        self.local_encoder = ConvFeatureExtractor(
            cfg.conv_feature_layers, dtype=dtype, fast_norm=cfg.fast_conv_norm,
            gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln,
        )
        self.proj_ln = make_norm(cfg.fast_ln, cfg.norm_eps, feat_dim)
        self.proj = Dense(feat_dim, E, dtype)
        k = cfg.conv_pos_width
        self.pos_conv = Conv(E, E, k, padding=k // 2, groups=cfg.conv_pos_groups, dtype=dtype)
        self.pos_trim = 1 if k % 2 == 0 else 0  # transformers' SamePad
        self.rel_attn_embed = nn.Parameter(torch.zeros(cfg.num_buckets, cfg.num_heads))
        self.layer_names = tuple(f"layer_{i}" for i in range(cfg.depth))
        for name in self.layer_names:
            self.add_module(name, WavLMLayer(cfg, dtype))
        self.final_ln = make_norm(cfg.fast_ln, cfg.norm_eps, E)
        # zeros: softmax gives every hidden state 1/25, transformers' start
        self.layer_weights = nn.Parameter(torch.zeros(cfg.depth + 1))

    def forward(self, wav: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``wav`` (B, T) at 16 kHz, ``padding_mask`` (B, T) bool True = pad."""
        cfg = self.cfg
        B = wav.shape[0]
        frames = wav.shape[1]
        for _dim, kernel, stride in cfg.conv_feature_layers:
            frames = (frames - kernel) // stride + 1
        with profiling.span("wavlm.encoder", rows=B, frames=frames):
            x = self.local_encoder(wav)
            x = self.proj(self.proj_ln(x).to(self.dtype)).float()
            N = x.shape[1]
            frame_mask = None
            if padding_mask is not None:  # padded frames zeroed, as transformers does
                frame_mask = convert_padding_mask(padding_mask, N, cfg.conv_feature_layers)
                x = x * (~frame_mask)[..., None].to(x.dtype)
            pos = self.pos_conv(x)
            if self.pos_trim:
                pos = pos[:, : -self.pos_trim]
            x = x + F.gelu(pos.float(), approximate="tanh" if cfg.gelu_approximate else "none")
            with profiling.span("wavlm.position_bias", frames=N):
                table = position_table(self.rel_attn_embed, N, cfg.num_buckets,
                                       cfg.max_bucket_distance)
            w = torch.softmax(self.layer_weights.float(), dim=0)
            feats = x * w[0]
            last = len(self.layer_names) - 1
            for i, name in enumerate(self.layer_names):
                x = getattr(self, name)(x, frame_mask, table)
                if i < last:
                    feats.addcmul_(x, w[i + 1])
            feats.addcmul_(self.final_ln(x).float(), w[last + 1])
        return feats, frame_mask
