"""Operation and byte counts of the WavLM cell, from shapes: the encoder
and head's matmul and conv FLOPs of one clip at its own length, and one
launch of the biased attention kernel.

FLOPs count 2 per multiply-add of matmuls and convolutions (the gate's
64 -> 8 projection included); elementwise work is not counted. The front
end's layer lengths are taken back from the clip's frames (the shortest
input that gives them), within a stride of the clip's own."""

from __future__ import annotations

from typing import Sequence

from . import roofline


def front_end_lengths(frames: int, conv_layers: Sequence[Sequence[int]]) -> list:
    """The output length of each conv layer for a clip of ``frames``."""
    out = [frames]
    for _dim, k, s in reversed(conv_layers[1:]):
        out.append((out[-1] - 1) * s + k)
    return out[::-1]


def encoder_flops(enc: dict, frames: int) -> float:
    """WavLM's forward over one clip of ``frames`` frames: the conv front
    end, the projection, the positional conv and every layer (qkv, output,
    the gate, the feed-forward, QK^T and PV over the clip's frames)."""
    if frames <= 0:
        return 0.0
    e, h = enc["embed_dim"], int(enc["embed_dim"] * enc["mlp_ratio"])
    conv = enc["conv_feature_layers"]
    total, c_in = 0.0, 1
    for (dim, k, _s), n in zip(conv, front_end_lengths(frames, conv)):
        total += 2.0 * n * dim * c_in * k
        c_in = dim
    t = frames
    total += 2.0 * t * c_in * e
    total += 2.0 * t * e * (e // enc["conv_pos_groups"]) * enc["conv_pos_width"]
    dense = 2.0 * (e * 3 * e + e * e + 2 * e * h + e * 8)
    attn = 2.0 * 2 * t * e
    return total + t * (dense + attn) * enc["depth"]


def clip_flops(enc: dict, head: dict, frames: int) -> float:
    """Encoder and DAD head of one clip."""
    return encoder_flops(enc, frames) + roofline.head_flops(head, frames) if frames > 0 else 0.0


def relbias_attention_bound_s(batch: int, heads: int, n: int, head_dim: int,
                              valid_keys: int) -> float:
    """Least time of one biased attention launch on (batch, heads, n,
    head_dim) bf16 operands: q, k, v and the output once each, the (batch,
    n) bool mask, the (batch, heads, n) f32 gate and the (heads, 2n - 1)
    f32 table, against QK^T and PV of every query row over its item's
    valid keys (``valid_keys``: summed over the batch)."""
    flops = 4.0 * heads * n * head_dim * valid_keys
    nbytes = (4.0 * batch * heads * n * head_dim * 2 + batch * n + 4.0 * batch * heads * n
              + 4.0 * heads * (2 * n - 1))
    return roofline.bound_s(nbytes, flops)[0]
