"""Seeded weights made on the device: one normal draw over every leaf,
cut into views and scaled, in the layouts the benchmark hands out (the
fairseq emotion2vec layout, the reference SSRL head, the d2v model)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# name -> (shape, scale, offset); scale 0 gives the offset alone
Layout = Dict[str, Tuple[Tuple[int, ...], float, float]]


def materialize(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout`` as offset + scale * N(0, 1), f32, from one
    draw of a generator on ``device`` seeded with ``seed``."""
    total = sum(_numel(shape) for shape, _s, _o in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, scale, offset) in layout.items():
        n = _numel(shape)
        v = buf[at:at + n].view(shape)
        at += n
        v.mul_(scale).add_(offset)
        out[name] = v
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def fairseq_encoder_layout(enc: dict) -> Layout:
    """emotion2vec's fairseq keys (``chip_smoke.py``'s scales)."""
    A = "modality_encoders.AUDIO."
    lay: Layout = {}
    in_c = 1
    for i, (dim, k, _s) in enumerate(enc["conv_feature_layers"]):
        lay[f"{A}local_encoder.conv_layers.{i}.0.weight"] = ((dim, in_c, k), 0.3, 0.0)
        lay[f"{A}local_encoder.conv_layers.{i}.2.1.weight"] = ((dim,), 0.06, 1.0)
        lay[f"{A}local_encoder.conv_layers.{i}.2.1.bias"] = ((dim,), 0.06, 0.0)
        in_c = dim
    E, feat = enc["embed_dim"], enc["conv_feature_layers"][-1][0]
    lay[f"{A}project_features.1.weight"] = ((feat,), 0.06, 1.0)
    lay[f"{A}project_features.1.bias"] = ((feat,), 0.06, 0.0)
    lay[f"{A}project_features.2.weight"] = ((E, feat), feat ** -0.5, 0.0)
    lay[f"{A}project_features.2.bias"] = ((E,), 0.06, 0.0)
    kpos = max(3, enc["conv_pos_width"] // enc["conv_pos_depth"])
    g = enc["conv_pos_groups"]
    for i in range(enc["conv_pos_depth"]):
        lay[f"{A}relative_positional_encoder.{i + 1}.0.weight"] = (
            (E, E // g, kpos), ((E // g) * kpos) ** -0.5, 0.0)
        lay[f"{A}relative_positional_encoder.{i + 1}.0.bias"] = ((E,), 0.06, 0.0)
    lay[f"{A}context_encoder.norm.weight"] = ((E,), 0.06, 1.0)
    lay[f"{A}context_encoder.norm.bias"] = ((E,), 0.06, 0.0)
    hid = int(E * enc["mlp_ratio"])
    prefixes = [f"{A}context_encoder.blocks.{i}" for i in range(enc["prenet_depth"])]
    prefixes += [f"blocks.{i}" for i in range(enc["depth"])]
    for p in prefixes:
        for n in ("norm1", "norm2"):
            lay[f"{p}.{n}.weight"] = ((E,), 0.06, 1.0)
            lay[f"{p}.{n}.bias"] = ((E,), 0.06, 0.0)
        for n, (o, i) in (("attn.qkv", (3 * E, E)), ("attn.proj", (E, E)),
                          ("mlp.fc1", (hid, E)), ("mlp.fc2", (E, hid))):
            lay[f"{p}.{n}.weight"] = ((o, i), i ** -0.5, 0.0)
            lay[f"{p}.{n}.bias"] = ((o,), 0.06, 0.0)
    return lay


def ssrl_layout(head: dict) -> Layout:
    """The reference SSRL checkpoint's keys, student and teacher."""
    d, h, c = head["input_dim"], head["hidden_dim"], head["num_classes"]
    lay: Layout = {}
    for role in ("student", "teacher"):
        lay[f"{role}_encoder.pre_net.weight"] = ((h, d), d ** -0.5, 0.0)
        lay[f"{role}_encoder.pre_net.bias"] = ((h,), 0.1, 0.0)
        lay[f"{role}_classifier.fc_layer.weight"] = ((c, h), h ** -0.5, 0.0)
        lay[f"{role}_classifier.fc_layer.bias"] = ((c,), 0.1, 0.0)
    return lay


def d2v_layout(enc: dict, d2v: dict) -> Layout:
    """The d2v model's keys (the student encoder under the extraction
    encoder's names, then the decoder). The encoder as a checkpoint holds
    it (``cli d2v-pretrain --init-checkpoint``: weights N(0, 1 / fan_in),
    biases and LayerNorm shifts N(0, 0.06^2), LayerNorm scales 1 + N(0,
    0.06^2)); the decoder fresh, as flax initialises it (zero biases)."""
    lay: Layout = {}

    def dense(name, out_dim, in_dim, bias=0.06):
        lay[f"{name}.weight"] = ((out_dim, in_dim), in_dim ** -0.5, 0.0)
        lay[f"{name}.bias"] = ((out_dim,), bias, 0.0)

    def norm(name, dim):
        lay[f"{name}.weight"] = ((dim,), 0.06, 1.0)
        lay[f"{name}.bias"] = ((dim,), 0.06, 0.0)

    in_c = 1
    for i, (dim, k, _s) in enumerate(enc["conv_feature_layers"]):
        lay[f"local_encoder.conv_{i}.weight"] = ((dim, in_c, k), (in_c * k) ** -0.5, 0.0)
        norm(f"local_encoder.ln_{i}", dim)
        in_c = dim
    E = enc["embed_dim"]
    norm("proj_ln", in_c)
    dense("proj", E, in_c)
    kpos = max(3, enc["conv_pos_width"] // enc["conv_pos_depth"])
    g = enc["conv_pos_groups"]
    for i in range(enc["conv_pos_depth"]):
        lay[f"pos_conv.pos_conv_{i}.weight"] = ((E, E // g, kpos), ((E // g) * kpos) ** -0.5, 0.0)
        lay[f"pos_conv.pos_conv_{i}.bias"] = ((E,), 0.06, 0.0)
    norm("prenet_ln", E)
    hid = int(E * enc["mlp_ratio"])
    names = [f"prenet_block_{i}" for i in range(enc["prenet_depth"])]
    names += [f"block_{i}" for i in range(enc["depth"])]
    for b in names:
        dense(f"{b}.attn.qkv", 3 * E, E)
        dense(f"{b}.attn.proj", E, E)
        norm(f"{b}.norm1", E)
        norm(f"{b}.norm2", E)
        dense(f"{b}.mlp.fc1", hid, E)
        dense(f"{b}.mlp.fc2", E, hid)
    dc = d2v["decoder"]
    c = E
    for i in range(dc["decoder_layers"]):
        fan = (c // dc["decoder_groups"]) * dc["decoder_kernel"]
        lay[f"decoder.conv_{i}.weight"] = (
            (dc["decoder_dim"], c // dc["decoder_groups"], dc["decoder_kernel"]), fan ** -0.5, 0.0)
        lay[f"decoder.conv_{i}.bias"] = ((dc["decoder_dim"],), 0.0, 0.0)
        c = dc["decoder_dim"]
    for i in range(dc["projection_layers"] - 1):
        nxt = int(c * dc["projection_ratio"]) if i == 0 else c
        dense(f"decoder.proj_{i}", nxt, c, bias=0.0)
        c = nxt
    dense("decoder.proj_out", E, c, bias=0.0)
    return lay
