"""emotion2vec (data2vec-multi audio) encoder, the features_only path:

    wav -> conv feature extractor -> LN -> proj(512->768)
        -> + grouped-conv positional encoding
        -> prenet LN + 4 AltBlocks (post-LN)
        -> 8 AltBlocks (post-LN)

Serving and the DAD step run the encoder frozen (``deterministic=True``);
``deterministic=False`` is the training forward: dropout in every block and
layerdrop (a whole block skipped with probability ``layerdrop``, one draw
per block), drawn from the caller's generator. ``normalize_wav`` is the
waveform layer norm the extraction CLI applies before the encoder.

``tp_group`` builds the encoder of one tensor-parallel rank (frozen,
forward only): its blocks hold the rank's heads and MLP share
(``parallel/mesh.py::shard_encoder_state``), the rest is replicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn
from torch.func import functional_call

from ..configs import EncoderConfig
from .layers import (
    AltBlock,
    ConvFeatureExtractor,
    Dense,
    PositionalConv,
    alibi_bias,
    convert_padding_mask,
    make_norm,
)


def torch_dtype(name: str) -> torch.dtype:
    """EncoderConfig.dtype string -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[name]
    except KeyError:
        raise ValueError(f"unsupported encoder dtype {name!r}") from None


def normalize_wav(wav: torch.Tensor,
                  padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-waveform layer norm (zero mean / unit var, no affine, eps 1e-5).
    With a padding mask, statistics are over valid samples only."""
    if padding_mask is None:
        mean = wav.mean(dim=-1, keepdim=True)
        var = wav.var(dim=-1, keepdim=True, unbiased=False)
    else:
        keep = (~padding_mask).to(wav.dtype)
        n = torch.clamp(keep.sum(dim=-1, keepdim=True), min=1.0)
        mean = (wav * keep).sum(dim=-1, keepdim=True) / n
        var = (((wav - mean) * keep) ** 2).sum(dim=-1, keepdim=True) / n
    return (wav - mean) / torch.sqrt(var + 1e-5)


class Emotion2vecEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.tp_group = tp_group
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        feat_dim = cfg.conv_feature_layers[-1][0]

        self.local_encoder = ConvFeatureExtractor(
            cfg.conv_feature_layers, dtype=dtype, fast_norm=cfg.fast_conv_norm,
            gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln,
        )
        self.proj_ln = make_norm(cfg.fast_ln, 1e-5, feat_dim)
        self.proj = Dense(feat_dim, cfg.embed_dim, dtype)
        self.pos_conv = PositionalConv(
            cfg.embed_dim, depth=cfg.conv_pos_depth, width=cfg.conv_pos_width,
            groups=cfg.conv_pos_groups, dtype=dtype,
            gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln,
        )
        self.prenet_ln = make_norm(cfg.fast_ln, cfg.norm_eps, cfg.embed_dim)
        names = [f"prenet_block_{i}" for i in range(cfg.prenet_depth)]
        names += [f"block_{i}" for i in range(cfg.depth)]
        for name in names:
            self.add_module(name, make_block(cfg, tp_group=tp_group))
        self.block_names = tuple(names)

    def forward(
        self,
        wav: torch.Tensor,  # (B, T) waveform at 16 kHz
        padding_mask: Optional[torch.Tensor] = None,  # (B, T) bool True=pad
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``deterministic=False``: dropout and layerdrop from ``generator``."""
        cfg = self.cfg
        x = self.local_encoder(wav)
        x = self.proj(self.proj_ln(x).to(self.dtype))

        frame_mask = None
        if padding_mask is not None:
            frame_mask = convert_padding_mask(
                padding_mask, x.shape[1], cfg.conv_feature_layers
            )
        x = x + self.pos_conv(x, frame_mask)
        bias = None
        if cfg.use_alibi_encoder:
            bias = alibi_bias(x.shape[1], cfg.num_heads, cfg.alibi_scale, self.dtype, x.device)
            if self.tp_group is not None:  # this rank's heads
                bias = bias.chunk(dist.get_world_size(self.tp_group), dim=1)[
                    dist.get_rank(self.tp_group)]

        # prenet: post-LN => LN applied BEFORE the blocks
        x = self.prenet_ln(x).to(self.dtype)
        for name in self.block_names:
            rate = cfg.prenet_layerdrop if name.startswith("prenet") else cfg.layerdrop
            x = run_block(getattr(self, name), x, frame_mask, bias, deterministic,
                          generator, rate)
        # layer_norm_first=False => no final norm
        return x, frame_mask


def make_block(cfg: EncoderConfig, return_ffn_target: bool = False,
               tp_group=None) -> AltBlock:
    """One transformer block of the encoder's configuration (a
    tensor-parallel rank's share of it with ``tp_group``)."""
    return AltBlock(
        cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
        drop=cfg.encoder_dropout, attn_drop=cfg.attention_dropout,
        mlp_drop=cfg.activation_dropout, post_mlp_drop=cfg.post_mlp_drop,
        norm_eps=cfg.norm_eps, layer_norm_first=cfg.layer_norm_first,
        dtype=torch_dtype(cfg.dtype), use_flash=cfg.use_flash_attention,
        gelu_approximate=cfg.gelu_approximate, fast_ln=cfg.fast_ln,
        fast_softmax=cfg.fast_softmax, cosine_attention=cfg.cosine_attention,
        return_ffn_target=return_ffn_target, tp_group=tp_group,
    )


def run_block(block: AltBlock, x: torch.Tensor, frame_mask: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], deterministic: bool,
              generator: Optional[torch.Generator], layerdrop: float = 0.0,
              remat: bool = False):
    """A block's forward in the encoder's stack. Training
    (``deterministic=False``): with probability ``layerdrop`` the whole
    block is skipped (one draw; a skipped block returns its input); else its
    dropout masks are drawn before it runs, so that ``remat`` (recompute in
    the backward through ``torch.utils.checkpoint``) sees the same masks."""
    keeps = None
    if not deterministic:
        if layerdrop > 0 and not bool(torch.rand((), generator=generator,
                                                 device=x.device) < 1.0 - layerdrop):
            return x
        keeps = block.draw_keeps(x, generator, bias)
    if remat:
        # the block's tensors go in as arguments: the recompute runs in the
        # backward, after a ``functional_call`` that swapped them in is over
        names, tensors = zip(*block.named_parameters())

        def fn(x, frame_mask, bias, keeps, *ps):
            return functional_call(block, dict(zip(names, ps)), (x, frame_mask, bias, keeps))

        return torch.utils.checkpoint.checkpoint(fn, x, frame_mask, bias, keeps, *tensors,
                                                 use_reentrant=False)
    return block(x, frame_mask, bias, keeps)


def extract_features(
    model: Emotion2vecEncoder,
    wav: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    normalize: Optional[bool] = None,
):
    """Counterpart of the JAX ``extract_features`` (model holds its params)."""
    if normalize is None:
        normalize = model.cfg.normalize_input
    if normalize:
        wav = normalize_wav(wav, padding_mask)
    with torch.no_grad():
        return model(wav, padding_mask)
