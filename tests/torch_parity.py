"""Shared set-up for the PyTorch port's parity tests: the JAX package and
the port side by side on the same numpy inputs, at a tiny size."""

import dataclasses

import jax
import numpy as np

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    EncoderConfig as JaxEncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig as TorchEncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.batching import (
    Batch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.native import (
    NativeStore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_encoder_to_torch,
)

# tests/test_models.py's TINY encoder, with attention through the kernel
# (Pallas in interpret mode on the JAX side, the plain version on the port's)
TINY = dict(
    embed_dim=16,
    depth=2,
    num_heads=2,
    prenet_depth=1,
    conv_feature_layers=((8, 4, 2), (8, 3, 2)),
    conv_pos_width=6,
    conv_pos_groups=2,
    conv_pos_depth=2,
    dtype="float32",
    use_flash_attention=True,
)

# f32 features on valid frames (tests/test_models.py's tolerance: summation
# order, and flax's E[x^2]-E[x]^2 LayerNorm variance vs F.layer_norm's)
F32_TOL = dict(atol=3e-5, rtol=1e-4)


def cfg_pair(**overrides):
    """(JAX EncoderConfig, port EncoderConfig) with the same fields."""
    kw = {**TINY, **overrides}
    return JaxEncoderConfig(**kw), TorchEncoderConfig(**kw)


def native_batches(store, batches, max_frames=None):
    """The port's native batcher (``NativeStore`` over ``store``) asked for
    each of ``batches``' clips at its padded length, with the iterators'
    frame cap applied after assembly, as ``PaddedBatchIterator`` does."""
    ns = NativeStore(store.feats, store.sizes, store.offsets, store.labels)
    out = []
    for b in batches:
        feats, mask, labels, valid = ns.assemble(b.ids.astype(np.int64), b.feats.shape[1])
        if max_frames is not None:
            feats[:, max_frames:] = 0.0
            mask[:, max_frames:] = True
        out.append(Batch(feats, mask, labels, b.ids, valid))
    ns.close()
    return out


def to_torch(flax_params):
    """A flax param tree (jax arrays) -> the port's state dict."""
    return flax_encoder_to_torch(jax.tree.map(np.asarray, flax_params))


def jax_strong_draws(key, shape, padding_mask, aug_cfg):
    """The draws the JAX ``strong_augment`` takes from ``key``, as the
    port's ``StrongDraws`` (torch tensors)."""
    import jax.numpy as jnp
    import torch

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad.augment import (
        StrongDraws,
    )

    B, T, D = shape
    k_noise, k_feat, k_time = jax.random.split(key, 3)
    t_valid = T if padding_mask is None else int(np.max(np.sum(~np.asarray(padding_mask), 1)))
    mask_len = int(np.floor(np.float32(t_valid) * np.float32(aug_cfg.temporal_mask_ratio)))
    start = jax.random.randint(k_time, (B,), 0, jnp.maximum(1, t_valid - mask_len + 1))
    return StrongDraws(
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        feat_u=torch.from_numpy(np.array(jax.random.uniform(k_feat, (D,)))),
        start=torch.from_numpy(np.array(start)).long(),
    )


def jax_normal(key, shape):
    """jax.random.normal(key, shape) as a torch tensor."""
    import torch

    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def port_cfg(jax_cfg):
    """The port's copy of a JAX-package config dataclass."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
        configs,
    )

    return getattr(configs, type(jax_cfg).__name__)(**{
        f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)
    })
