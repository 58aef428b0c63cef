"""Checkpoint converters into the port's ``state_dict`` layouts.

- ``fairseq_to_torch_encoder``: a fairseq Data2VecMultiModel state dict
  (``emotion2vec_base.pt``) -> ``Emotion2vecEncoder`` state dict, loaded
  natively. Same key set and the same strict audit as the JAX package's
  ``fairseq_to_flax_encoder``: every source key is mapped or a known
  pretraining-only dead weight, and shapes are checked against the module.
- ``flax_encoder_to_torch``: the JAX package's encoder param tree (numpy
  arrays) -> the same state dict. Conv kernels (k, in/g, out) become
  (out, in/g, k); dense kernels (in, out) become (out, in); flax ``scale``
  becomes ``weight``.
  The same walk converts a flax ``DADHead`` tree.
- DAD SSRL checkpoints: ``student_encoder.pre_net.*`` /
  ``student_classifier.fc_layer.*`` (and ``teacher_*``) <-> ``SSRLState``
  of two ``DADHead`` state dicts (``torch_state_dict_to_ssrl``,
  ``ssrl_to_torch_state_dict``, ``save_torch_file``).
- pretrain-head checkpoints (``pre_net.*`` / ``post_net.*``) ->
  ``PretrainHead`` state dicts (``load_pretrain_head_checkpoint``); the
  JAX package's ``PretrainHead`` params -> the same state dict
  (``flax_pretrain_head_to_torch``); ``save_pretrain_head_checkpoint``
  writes the file both packages' loaders read.
- ``flax_train_state_to_torch``: a JAX ``DADTrainState`` (numpy leaves)
  -> the port's, optimizer and DACP state included, so both frameworks can
  start from one state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs import EncoderConfig
from .heads import SSRLState


def _t(x) -> torch.Tensor:
    """tensor / array -> CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """Loads a torch checkpoint into {key: tensor}, unwrapping the fairseq
    {'model': ...} / trainer {'model_state_dict': ...} nestings. fairseq
    checkpoints pickle their config objects, so this unpickles: load only
    checkpoints from a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "model_state_dict", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: _t(v) for k, v in obj.items() if hasattr(v, "shape")}


# ---------------------------------------------------------------------------
# emotion2vec encoder
# ---------------------------------------------------------------------------

_AUDIO = "modality_encoders.AUDIO."

# Weights of the d2v-pretraining machinery that real emotion2vec_base.pt
# checkpoints carry but the features_only path never touches. The loader
# skips them silently, and nothing else.
_DEAD_WEIGHT_MARKERS = (
    "_ema",
    ".decoder.",
    "decoder.",
    "alibi_scale",
    "alibi",
    "mask_emb",
    "mask_token",
    "ema.",
    "final_proj",
    "recon_proj",
    "project_q",
    "cls_emb",
    "fixed_positional_encoder",
    "num_updates",
)


def _is_dead_weight(key: str) -> bool:
    return any(m in key for m in _DEAD_WEIGHT_MARKERS)


def _encoder_key_map(cfg: EncoderConfig) -> Dict[str, str]:
    """{port state_dict key: fairseq key} for the features_only path."""
    m: Dict[str, str] = {}
    for i in range(len(cfg.conv_feature_layers)):
        base = f"{_AUDIO}local_encoder.conv_layers.{i}"
        m[f"local_encoder.conv_{i}.weight"] = f"{base}.0.weight"
        m[f"local_encoder.ln_{i}.weight"] = f"{base}.2.1.weight"
        m[f"local_encoder.ln_{i}.bias"] = f"{base}.2.1.bias"
    for name in ("weight", "bias"):
        m[f"proj_ln.{name}"] = f"{_AUDIO}project_features.1.{name}"
        m[f"proj.{name}"] = f"{_AUDIO}project_features.2.{name}"
        # Sequential(TransposeLast, block*depth, TransposeLast): block i at i+1
        for i in range(cfg.conv_pos_depth):
            m[f"pos_conv.pos_conv_{i}.{name}"] = (
                f"{_AUDIO}relative_positional_encoder.{i + 1}.0.{name}"
            )
        m[f"prenet_ln.{name}"] = f"{_AUDIO}context_encoder.norm.{name}"
    blocks = [(f"prenet_block_{i}", f"{_AUDIO}context_encoder.blocks.{i}")
              for i in range(cfg.prenet_depth)]
    blocks += [(f"block_{i}", f"blocks.{i}") for i in range(cfg.depth)]
    for ours, src in blocks:
        for sub in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for name in ("weight", "bias"):
                m[f"{ours}.{sub}.{name}"] = f"{src}.{sub}.{name}"
    return m


def _check_encoder_shapes(state_dict: Mapping[str, torch.Tensor],
                         cfg: EncoderConfig) -> None:
    """Raises unless ``state_dict`` has exactly the module's keys and shapes
    (the module is built on the meta device: no memory)."""
    from .emotion2vec import Emotion2vecEncoder

    with torch.device("meta"):
        expected = Emotion2vecEncoder(cfg).state_dict()
    bad = [
        f"{k}: checkpoint {tuple(state_dict[k].shape)} vs module {tuple(v.shape)}"
        for k, v in expected.items()
        if k in state_dict and tuple(state_dict[k].shape) != tuple(v.shape)
    ]
    missing = [k for k in expected if k not in state_dict]
    extra = [k for k in state_dict if k not in expected]
    if bad or missing or extra:
        raise ValueError(
            f"checkpoint/config shape mismatch: {bad[:5]} missing={missing[:5]} "
            f"unexpected={extra[:5]}"
        )


def fairseq_to_torch_encoder(
    sd: Mapping[str, Any], cfg: EncoderConfig, strict: bool = True
) -> Dict[str, torch.Tensor]:
    """Maps a fairseq Data2VecMultiModel state dict onto the port's
    ``Emotion2vecEncoder`` state dict (torch layouts need no transposes).

    ``strict``: every source key must be consumed or a known dead weight,
    and every mapped shape must match the module's."""
    key_map = _encoder_key_map(cfg)
    out = {ours: _t(sd[src]).float() for ours, src in key_map.items()}
    if strict:
        consumed = set(key_map.values())
        unknown = sorted(
            k for k in sd if k not in consumed and not _is_dead_weight(k)
        )
        if unknown:
            raise ValueError(
                "fairseq checkpoint carries keys the converter does not "
                f"recognize (not mapped, not known-dead): {unknown[:10]}"
                + (f" ... +{len(unknown) - 10} more" if len(unknown) > 10 else "")
            )
        _check_encoder_shapes(out, cfg)
    return out


def flax_encoder_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's encoder param tree ({"params": ...} or its inside,
    leaves as numpy arrays) -> the port's encoder state dict. Works for any
    tree of Dense / Conv / LayerNorm leaves, e.g. a ``DADHead``'s."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        arr = np.array(node, np.float32)  # a writable copy
        leaf = path[-1]
        if leaf == "kernel":
            # dense (in, out) -> (out, in); conv (k, in/g, out) -> (out, in/g, k)
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.ascontiguousarray(arr)
        )

    walk(tree, ())
    return out


def load_emotion2vec_checkpoint(path: str, cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    return fairseq_to_torch_encoder(load_torch_file(path), cfg)


# ---------------------------------------------------------------------------
# DAD SSRL checkpoints (student_* / teacher_* torch module trees)
# ---------------------------------------------------------------------------

_HEAD_KEYS = (
    "encoder.pre_net.weight",
    "encoder.pre_net.bias",
    "classifier.fc_layer.weight",
    "classifier.fc_layer.bias",
)


def torch_state_dict_to_ssrl(sd: Mapping[str, Any]) -> SSRLState:
    """Reference SSRLModel state dict -> student/teacher ``DADHead`` state
    dicts (``student_encoder.pre_net.weight`` -> ``encoder.pre_net.weight``)."""

    def one(role):
        return {k: _t(sd[f"{role}_{k}"]).float() for k in _HEAD_KEYS}

    return SSRLState(student=one("student"), teacher=one("teacher"))


def ssrl_to_torch_state_dict(state: SSRLState) -> Dict[str, torch.Tensor]:
    """The reverse: the reference SSRLModel state dict layout, contiguous f32
    tensors on the CPU, so that the reference's scripts and the JAX
    package's ``torch_state_dict_to_ssrl`` load it."""
    out = {}
    for role in ("student", "teacher"):
        params = getattr(state, role)
        for k in _HEAD_KEYS:
            out[f"{role}_{k}"] = params[k].detach().to("cpu", torch.float32).contiguous()
    return out


def save_torch_file(obj: Mapping[str, Any], path: str) -> None:
    """``torch.save`` of a state dict, every array as a CPU tensor."""
    torch.save({k: _t(v) if hasattr(v, "shape") else v for k, v in obj.items()}, path)


# ---------------------------------------------------------------------------
# pretrain head (pre_net / post_net): the checkpoint is already the
# ``PretrainHead`` state dict's layout
# ---------------------------------------------------------------------------

_PRETRAIN_KEYS = ("pre_net.weight", "pre_net.bias", "post_net.weight", "post_net.bias")


def load_pretrain_head_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A pretrain ``best_model_fold_N.ckpt`` -> ``PretrainHead`` state dict
    (f32 CPU tensors), the input of ``heads.load_pretrain_into_ssrl``."""
    sd = load_torch_file(path)
    return {k: sd[k].float() for k in _PRETRAIN_KEYS}


def save_pretrain_head_checkpoint(params: Mapping[str, torch.Tensor], path: str) -> None:
    """A ``PretrainHead`` state dict as the reference's pretrain checkpoint:
    exactly its four keys, contiguous f32 CPU tensors."""
    save_torch_file({k: params[k].detach().to("cpu", torch.float32).contiguous()
                     for k in _PRETRAIN_KEYS}, path)


def flax_pretrain_head_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``PretrainHead`` params ({"params": {"pre_net":
    {"kernel", "bias"}, "post_net": ...}}, numpy leaves) -> the port's
    ``PretrainHead`` state dict (``pre_net.weight`` (hidden, input) ...)."""
    out = flax_encoder_to_torch(params)
    if sorted(out) != sorted(_PRETRAIN_KEYS):
        raise ValueError(f"not a PretrainHead param tree: {sorted(out)}")
    return out


# ---------------------------------------------------------------------------
# DAD train state (JAX DADTrainState with numpy leaves -> the port's)
# ---------------------------------------------------------------------------


def flax_train_state_to_torch(state: Any, device=None):
    """The JAX package's ``DADTrainState`` (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's ``DADTrainState``.

    - student / teacher: flax ``DADHead`` trees -> state dicts (kernels
      (in, out) -> weights (out, in));
    - the optax state: Adam's (count, mu, nu) from the chain's inner
      states and the injected learning rate -> ``AdamState``;
    - ``DACPState`` field by field.

    Read by attribute, so no JAX type is needed here."""
    from ..dad.dacp import DACPState
    from ..dad.train_step import AdamState, DADTrainState

    def tree(t):
        return {k: v.to(device) for k, v in flax_encoder_to_torch(t).items()}

    def tensor(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    opt = state.opt_state
    adam = next(s for s in opt.inner_state if hasattr(s, "mu") and hasattr(s, "nu"))
    return DADTrainState(
        ssrl=SSRLState(student=tree(state.ssrl.student), teacher=tree(state.ssrl.teacher)),
        opt_state=AdamState(
            count=tensor(adam.count, torch.int32),
            mu=tree(adam.mu),
            nu=tree(adam.nu),
            learning_rate=tensor(opt.hyperparams["learning_rate"], torch.float32),
        ),
        dacp=DACPState(*(tensor(getattr(state.dacp, f), torch.float32)
                         for f in DACPState._fields)),
    )

