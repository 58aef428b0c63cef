"""WavLM Large's frozen forward, the SUPERB weighted layer sum and the DAD
head, one clip at a time, from transformers' key names and the reference
SSRL head layout (arXiv:2110.13900; transformers' ``WavLMModel`` with
``do_stable_layer_norm``):

    int16 PCM / 32768 -> whole-clip LayerNorm (eps 1e-5, no affine)
    -> 7 x (conv, channel LayerNorm, GELU) -> LayerNorm(512) -> Linear
    -> x + GELU(weight-normed grouped conv k 128, last frame dropped)
    -> 24 x [x + attention(LN(x)) with the gated relative position bias;
             x + FFN(LN(x))] -> LayerNorm
    -> softmax(w)-weighted sum of the 25 hidden states
    -> Linear 1024->256, ReLU, mean over frames -> Linear 256->4 -> softmax.

The bias: T5-style buckets of r = k - q (int64, float32 logs, on the
host), E[bucket, h] for every (q, k), gated per query row and layer by
a (b c_h - 1) + 2 from a 64 -> 8 projection of the row's head slice; it
is materialised (H, N, N) and added to q.k / 8 before the softmax. One
clip alone and unpadded: the program's bucket padding, masks and batching
must give the same numbers. Every matmul and convolution takes its
operands through ``q`` (``nn.py``)."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import nn as rnn
from .e2v import head_probs


def buckets(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(rel < exact, rel, large)


def _ln(x, sd, key, eps):
    return rnn.layer_norm(x, sd[f"{key}.weight"], sd[f"{key}.bias"], eps)


def _lin(x, sd, key, q):
    return rnn.linear(x, sd[f"{key}.weight"], sd[f"{key}.bias"], q)


def features(sd: Dict[str, torch.Tensor], enc: dict, pcm: torch.Tensor,
             q: rnn.Q = rnn.exact) -> torch.Tensor:
    """(T,) int16 PCM -> the weighted layer sum, (frames, E) float32."""
    E, H, eps = enc["embed_dim"], enc["num_heads"], enc["norm_eps"]
    Dh = E // H
    wav = pcm.float() / 32768.0
    if enc["normalize_input"]:
        wav = (wav - wav.mean()) / torch.sqrt(wav.var(unbiased=False) + 1e-5)

    def conv_keys(i):
        pre = f"feature_extractor.conv_layers.{i}"
        return f"{pre}.conv.weight", f"{pre}.layer_norm.weight", f"{pre}.layer_norm.bias"

    x = rnn.front_end(wav[None], sd, conv_keys, enc["conv_feature_layers"], q)
    x = _lin(_ln(x, sd, "feature_projection.layer_norm", eps), sd,
             "feature_projection.projection", q)
    pos = "encoder.pos_conv_embed.conv."
    g, v = sd[f"{pos}weight_g"], sd[f"{pos}weight_v"]
    K = enc["conv_pos_width"]
    p = rnn.conv_btc(x, g * v / v.norm(dim=(0, 1), keepdim=True), sd[f"{pos}bias"], q,
                     padding=K // 2, groups=enc["conv_pos_groups"])
    if K % 2 == 0:
        p = p[:, :-1]
    x = x + rnn.gelu(p)
    N = x.shape[1]
    r = torch.arange(N)
    b = buckets(r[None, :] - r[:, None], enc["num_buckets"], enc["max_bucket_distance"])
    bias = sd["encoder.layers.0.attention.rel_attn_embed.weight"][b.to(x.device)]
    bias = bias.permute(2, 0, 1)[None]  # (1, H, N, N)
    w = torch.softmax(sd["layer_weights"].float(), dim=0)
    out = w[0] * x
    for i in range(enc["depth"]):
        pre = f"encoder.layers.{i}"
        y = _ln(x, sd, f"{pre}.layer_norm", eps)
        qh, kh, vh = (_lin(y, sd, f"{pre}.attention.{n}_proj", q).view(1, N, H, Dh)
                      .transpose(1, 2) for n in "qkv")
        proj = _lin(y.view(1, N, H, Dh).transpose(1, 2), sd,
                    f"{pre}.attention.gru_rel_pos_linear", q)
        a, c = torch.sigmoid(proj.view(1, H, N, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = a * (c * sd[f"{pre}.attention.gru_rel_pos_const"].view(1, H, 1, 1) - 1.0) + 2.0
        s = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(Dh) + gate * bias
        o = torch.matmul(q(torch.softmax(s, dim=-1)), q(vh)).transpose(1, 2).reshape(1, N, E)
        x = x + _lin(o, sd, f"{pre}.attention.out_proj", q)
        f = _ln(x, sd, f"{pre}.final_layer_norm", eps)
        f = _lin(rnn.gelu(_lin(f, sd, f"{pre}.feed_forward.intermediate_dense", q)), sd,
                 f"{pre}.feed_forward.output_dense", q)
        x = x + f
        if i < enc["depth"] - 1:
            out = out + w[i + 1] * x
    out = out + w[enc["depth"]] * _ln(x, sd, "encoder.layer_norm", eps)
    return out[0]


@torch.no_grad()
def predict(sd, ssrl, enc: dict, pcm: torch.Tensor, q: rnn.Q = rnn.exact):
    """One clip's (class probabilities, weighted-sum features), float32
    without TF32."""
    with rnn.strict_f32():
        feats = features(sd, enc, pcm, q)
        return head_probs(ssrl, feats, q=q), feats
