"""emotion2vec base's frozen forward and the DAD head, one clip at a time,
from the fairseq checkpoint layout and the reference SSRL head layout:

    int16 PCM / 32768 -> whole-clip LayerNorm (eps 1e-5, no affine)
    -> 7 x (conv, channel LayerNorm, GELU) -> LayerNorm -> Linear 512->768
    -> x + 5 x (grouped conv k 19, LayerNorm, GELU)
    -> LayerNorm -> 4 prenet + 8 post-LN blocks (eps 1e-6)
    -> Linear 768->256, ReLU, mean over frames -> Linear 256->4 -> softmax.

One clip alone and unpadded: the program's bucket padding, masks and
batching must give the same numbers."""

from __future__ import annotations

from typing import Dict

import torch

from . import nn as rnn

A = "modality_encoders.AUDIO."


def encoder_features(sd: Dict[str, torch.Tensor], enc: dict, pcm: torch.Tensor,
                     q: rnn.Q = rnn.exact) -> torch.Tensor:
    """(T,) int16 PCM -> (frames, E) float32 features."""
    wav = pcm.float() / 32768.0
    if enc["normalize_input"]:
        wav = (wav - wav.mean()) / torch.sqrt(wav.var(unbiased=False) + 1e-5)

    def conv_keys(i):
        base = f"{A}local_encoder.conv_layers.{i}"
        return f"{base}.0.weight", f"{base}.2.1.weight", f"{base}.2.1.bias"

    x = rnn.front_end(wav[None], sd, conv_keys, enc["conv_feature_layers"], q)
    x = rnn.layer_norm(x, sd[f"{A}project_features.1.weight"], sd[f"{A}project_features.1.bias"],
                       1e-5)
    x = rnn.linear(x, sd[f"{A}project_features.2.weight"], sd[f"{A}project_features.2.bias"], q)
    pos = [(sd[f"{A}relative_positional_encoder.{i + 1}.0.weight"],
            sd[f"{A}relative_positional_encoder.{i + 1}.0.bias"])
           for i in range(enc["conv_pos_depth"])]
    x = x + rnn.positional(x, None, pos, q, enc["conv_pos_groups"])
    x = rnn.layer_norm(x, sd[f"{A}context_encoder.norm.weight"],
                       sd[f"{A}context_encoder.norm.bias"], enc["norm_eps"])
    names = [f"{A}context_encoder.blocks.{i}" for i in range(enc["prenet_depth"])]
    names += [f"blocks.{i}" for i in range(enc["depth"])]
    for pre in names:
        x, _ = rnn.block(x, None, sd, pre, enc["num_heads"], enc["norm_eps"], q)
    return x[0]


def head_probs(ssrl: Dict[str, torch.Tensor], feats: torch.Tensor, role: str = "student",
               q: rnn.Q = rnn.exact) -> torch.Tensor:
    """(frames, E) -> the class probabilities."""
    h = torch.relu(rnn.linear(feats, ssrl[f"{role}_encoder.pre_net.weight"],
                              ssrl[f"{role}_encoder.pre_net.bias"], q))
    pooled = h.mean(dim=0, keepdim=True)
    logits = rnn.linear(pooled, ssrl[f"{role}_classifier.fc_layer.weight"],
                        ssrl[f"{role}_classifier.fc_layer.bias"], q)
    return torch.softmax(logits, dim=-1)[0]


@torch.no_grad()
def predict(sd, ssrl, enc: dict, pcm: torch.Tensor, q: rnn.Q = rnn.exact) -> torch.Tensor:
    """One clip's class probabilities, float32 without TF32."""
    with rnn.strict_f32():
        return head_probs(ssrl, encoder_features(sd, enc, pcm, q), q=q)
