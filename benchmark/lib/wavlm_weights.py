"""Seeded WavLM weights in transformers' key names (``WavLMModel``'s, and
a sequence classifier's ``layer_weights``), as ``weights.materialize``
draws them: one normal draw over every leaf on the device.

Scales (``configs/wavlm-large.ser.json``, ``assumed``): weights N(0,
1 / fan_in); biases and LayerNorm shifts N(0, 0.06^2); LayerNorm scales
1 + N(0, 0.06^2); the positional conv's weight norm g = sqrt(C / K) (the
norm of a fan-in draw) x (1 + N(0, 0.06^2)) and v N(0, 1); the bucket
embedding N(0, 1), so that the bias moves the scores as much as q.k does;
the gate constants 1 + N(0, 0.06^2); the layer weights N(0, 1). No conv
bias (``conv_bias`` false)."""

from __future__ import annotations

import math

from .weights import Layout


def wavlm_layout(enc: dict) -> Layout:
    E, H, K = enc["embed_dim"], enc["num_heads"], enc["conv_pos_width"]
    hid = int(E * enc["mlp_ratio"])
    lay: Layout = {}

    def dense(name, out_dim, in_dim):
        lay[f"{name}.weight"] = ((out_dim, in_dim), in_dim ** -0.5, 0.0)
        lay[f"{name}.bias"] = ((out_dim,), 0.06, 0.0)

    def norm(name, dim):
        lay[f"{name}.weight"] = ((dim,), 0.06, 1.0)
        lay[f"{name}.bias"] = ((dim,), 0.06, 0.0)

    in_c = 1
    for i, (dim, k, _s) in enumerate(enc["conv_feature_layers"]):
        pre = f"feature_extractor.conv_layers.{i}"
        lay[f"{pre}.conv.weight"] = ((dim, in_c, k), (in_c * k) ** -0.5, 0.0)
        norm(f"{pre}.layer_norm", dim)
        in_c = dim
    norm("feature_projection.layer_norm", in_c)
    dense("feature_projection.projection", E, in_c)
    pos = "encoder.pos_conv_embed.conv."
    g = math.sqrt(E / K)
    lay[f"{pos}weight_g"] = ((1, 1, K), 0.06 * g, g)
    lay[f"{pos}weight_v"] = ((E, E // enc["conv_pos_groups"], K), 1.0, 0.0)
    lay[f"{pos}bias"] = ((E,), 0.06, 0.0)
    lay["encoder.layers.0.attention.rel_attn_embed.weight"] = ((enc["num_buckets"], H), 1.0, 0.0)
    for i in range(enc["depth"]):
        pre = f"encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            dense(f"{pre}.attention.{n}_proj", E, E)
        dense(f"{pre}.attention.gru_rel_pos_linear", 8, E // H)
        lay[f"{pre}.attention.gru_rel_pos_const"] = ((1, H, 1, 1), 0.06, 1.0)
        norm(f"{pre}.layer_norm", E)
        norm(f"{pre}.final_layer_norm", E)
        dense(f"{pre}.feed_forward.intermediate_dense", hid, E)
        dense(f"{pre}.feed_forward.output_dense", E, hid)
    norm("encoder.layer_norm", E)
    lay["layer_weights"] = ((enc["depth"] + 1,), 1.0, 0.0)
    return lay
