"""A plain float32 reference of WavLM's frozen encoder (arXiv:2110.13900;
transformers' ``WavLMModel`` with ``do_stable_layer_norm``) and of the
SUPERB weighted layer sum, for the tests.

Plain ``torch`` on one clip at a time, unpadded, from a transformers-layout
state dict: it imports no kernel or module of the port and no JAX, sets
TF32 off, and materialises the (H, N, N) relative position bias. The
benchmark keeps its own frozen copy (``benchmark/reference/wavlm.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def buckets(rel: Tensor, num_buckets: int = 320, max_distance: int = 800) -> Tensor:
    """T5-style bidirectional buckets of r = k - q, as the paper's code and
    transformers compute them (int64 and float32 logs)."""
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(rel < exact, rel, large)


def _ln(x: Tensor, sd: Dict[str, Tensor], key: str, eps: float) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[f"{key}.weight"], sd[f"{key}.bias"], eps)


def _linear(x: Tensor, sd: Dict[str, Tensor], key: str) -> Tensor:
    return F.linear(x, sd[f"{key}.weight"], sd.get(f"{key}.bias"))


def _pos_conv_weight(sd: Dict[str, Tensor]) -> Tensor:
    """The positional conv's weight: g * v / |v| over (out, in) per tap."""
    pre = "encoder.pos_conv_embed.conv."
    if f"{pre}weight_g" in sd:
        g, v = sd[f"{pre}weight_g"], sd[f"{pre}weight_v"]
    else:
        g = sd[f"{pre}parametrizations.weight.original0"]
        v = sd[f"{pre}parametrizations.weight.original1"]
    return g * v / v.norm(dim=(0, 1), keepdim=True)


@torch.no_grad()
def hidden_states(sd: Dict[str, Tensor], enc: dict, wav: Tensor) -> Tuple[List[Tensor], Tensor]:
    """(the 25 hidden states, each (N, C), the weighted layer sum (N, C)) of
    one clip ``wav`` (T,) float32 (already normalised if the model wants
    it). ``enc``: embed_dim, depth, num_heads, norm_eps,
    conv_feature_layers, conv_pos_width, conv_pos_groups, num_buckets,
    max_bucket_distance. ``sd`` may hold ``layer_weights`` (else uniform)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward({k[6:] if k.startswith("wavlm.") else k: v.float()
                         for k, v in sd.items()}, enc, wav.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _forward(sd, enc, wav):
    E, H, eps = enc["embed_dim"], enc["num_heads"], enc["norm_eps"]
    Dh = E // H
    x = wav[None, None, :]  # (1, 1, T)
    for i, (_dim, _k, s) in enumerate(enc["conv_feature_layers"]):
        pre = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, sd[f"{pre}.conv.weight"], sd.get(f"{pre}.conv.bias"), stride=s)
        x = F.gelu(_ln(x.transpose(1, 2), sd, f"{pre}.layer_norm", 1e-5).transpose(1, 2))
    x = _ln(x.transpose(1, 2), sd, "feature_projection.layer_norm", eps)
    x = _linear(x, sd, "feature_projection.projection")  # (1, N, E)
    K = enc["conv_pos_width"]
    p = F.conv1d(x.transpose(1, 2), _pos_conv_weight(sd), sd["encoder.pos_conv_embed.conv.bias"],
                 padding=K // 2, groups=enc["conv_pos_groups"])
    if K % 2 == 0:
        p = p[:, :, :-1]
    x = x + F.gelu(p).transpose(1, 2)
    N = x.shape[1]
    pos = torch.arange(N)
    b = buckets(pos[None, :] - pos[:, None], enc["num_buckets"], enc["max_bucket_distance"])
    bias = sd["encoder.layers.0.attention.rel_attn_embed.weight"][b].permute(2, 0, 1)  # (H, N, N)
    states = [x[0]]
    for i in range(enc["depth"]):
        pre = f"encoder.layers.{i}"
        y = _ln(x, sd, f"{pre}.layer_norm", eps)
        heads = [_linear(y, sd, f"{pre}.attention.{n}_proj").view(1, N, H, Dh).transpose(1, 2)
                 for n in "qkv"]
        proj = _linear(y.view(1, N, H, Dh).transpose(1, 2), sd,
                       f"{pre}.attention.gru_rel_pos_linear")
        a, g = torch.sigmoid(proj.view(1, H, N, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = a * (g * sd[f"{pre}.attention.gru_rel_pos_const"].view(1, H, 1, 1) - 1.0) + 2.0
        s = heads[0] @ heads[1].transpose(-1, -2) / math.sqrt(Dh) + gate * bias[None]
        o = (torch.softmax(s, dim=-1) @ heads[2]).transpose(1, 2).reshape(1, N, E)
        x = x + _linear(o, sd, f"{pre}.attention.out_proj")
        f = _ln(x, sd, f"{pre}.final_layer_norm", eps)
        f = _linear(F.gelu(_linear(f, sd, f"{pre}.feed_forward.intermediate_dense")), sd,
                    f"{pre}.feed_forward.output_dense")
        x = x + f
        if i < enc["depth"] - 1:
            states.append(x[0])
    states.append(_ln(x, sd, "encoder.layer_norm", eps)[0])
    w = sd.get("layer_weights", torch.zeros(len(states)))
    w = torch.softmax(w.float(), dim=0)
    return states, sum(wi * h for wi, h in zip(w, states))
