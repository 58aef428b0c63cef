"""Shared set-up for the PyTorch port's parity tests: the JAX package and
the port side by side on the same numpy inputs, at a tiny size."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

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


def jax_pretrain_init(cfg, fold, seed=None):
    """The JAX pretrain_fold's init, PRNGKey(seed + fold), as numpy."""
    import jax.numpy as jnp

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import PretrainHead as JaxPretrainHead

    seed = cfg.random_seed if seed is None else seed
    head = JaxPretrainHead(cfg.input_dim, cfg.hidden_dim, cfg.num_classes)
    params = head.init(jax.random.PRNGKey(seed + fold), jnp.zeros((1, 4, cfg.input_dim)),
                       jnp.zeros((1, 4), bool))
    return jax.tree.map(np.asarray, params)


def jax_trainer_draws(jt, jcfg):
    """{(epoch, step): StepDraws} replaying the JAX feature trainer's key
    stream: ``PRNGKey(seed + 1)`` split once per step, each step's key split
    in 4 (clean dropout, weak, strong, student dropout) as the JAX step
    splits it, at the shape of each step's own noisy batch."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import paired_epoch as jax_paired_epoch
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import StepDraws

    key = jax.random.PRNGKey(jcfg.random_seed + 1)
    draws = {}
    for epoch in range(jcfg.epochs):
        for step, (_clean, noisy) in enumerate(jax_paired_epoch(jt.clean_train,
                                                                jt.noisy_train, epoch)):
            key, k = jax.random.split(key)
            _k_dc, k_weak, k_strong, _k_ds = jax.random.split(k, 4)
            draws[(epoch, step)] = StepDraws(
                weak=jax_normal(k_weak, noisy.feats.shape),
                strong=jax_strong_draws(k_strong, noisy.feats.shape, noisy.padding_mask,
                                        jcfg.augment))
    return draws


def port_cfg(jax_cfg):
    """The port's copy of a JAX-package config dataclass."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
        configs,
    )

    return getattr(configs, type(jax_cfg).__name__)(**{
        f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)
    })


# d2v pretraining: the JAX tests' tiny encoder and decoder
# (tests/test_d2v_pretrain.py TINY_ENC / TINY_DEC) with every dropout off
D2V_ENC = dict(
    embed_dim=16, depth=2, num_heads=2, prenet_depth=1,
    conv_feature_layers=((8, 4, 2), (8, 3, 2)),
    conv_pos_depth=2, conv_pos_width=10, conv_pos_groups=2, dtype="float32",
    encoder_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, post_mlp_drop=0.0,
)
D2V_DEC = dict(decoder_dim=8, decoder_groups=2, decoder_kernel=3, decoder_layers=2,
               input_dropout=0.0)
# summation order and rounding only (the trainer tests' tolerances)
METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)


def d2v_cfgs(enc=None, dec=None, **pcfg):
    """(JAX EncoderConfig, JAX D2vPretrainConfig, port EncoderConfig, port
    D2vPretrainConfig) with the same fields."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
        configs as jc,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
        configs as tc,
    )

    enc = {**D2V_ENC, **(enc or {})}
    dec = {**D2V_DEC, **(dec or {})}
    pcfg = dict(dict(clone_batch=2, average_top_k_layers=2, mask_length=3, warmup_steps=2,
                     max_steps=50, batch_size=2, crop_size=640), **pcfg)
    return (jc.EncoderConfig(**enc), jc.D2vPretrainConfig(decoder=jc.D2vDecoderConfig(**dec), **pcfg),
            tc.EncoderConfig(**enc), tc.D2vPretrainConfig(decoder=tc.D2vDecoderConfig(**dec), **pcfg))


def jax_d2v_draws(key, pcfg, rows: int, t: int, d: int):
    """The draws the JAX ``make_d2v_loss_fn`` takes from ``key`` (its six
    sub-keys), for ``rows`` = B * clone_batch rows of ``t`` frames and width
    ``d``, as the port's ``D2vDraws``. Dropout is off in the tests, so
    neither the blocks' nor the decoder input's keep masks are drawn."""
    import jax.numpy as jnp
    import torch

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.d2v_masking import (
        span_mask_counts,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.d2v_pretrain import (
        D2vDraws,
    )

    def t_(a):
        return torch.from_numpy(np.array(a))

    def span(k, n, length):
        ks, kf = jax.random.split(k)
        return (t_(jax.random.uniform(ks, (rows, n - length + 1))),
                t_(jax.random.uniform(kf, (rows, n))))

    k_mask, _k_drop, k_tok, _k_din, k_dtok, k_chan = jax.random.split(key, 6)
    if pcfg.mask_length == 1:
        mask = (t_(jax.random.uniform(k_mask, (rows, t))),)
        n_masked = t - int(t * (1.0 - pcfg.mask_prob))
    else:
        mask = span(k_mask, t, pcfg.mask_length)
        p = 1.0 - pcfg.mask_prob if pcfg.inverse_mask else pcfg.mask_prob
        n_masked = span_mask_counts(t, p, pcfg.mask_length)[1]
        if pcfg.inverse_mask:
            n_masked = t - n_masked
    return D2vDraws(
        mask=mask,
        tok=None if pcfg.encoder_zero_mask else t_(jax.random.normal(k_tok, (rows, t, d),
                                                                    jnp.float32)),
        dtok=t_(jax.random.normal(k_dtok, (rows, n_masked, d), jnp.float32)),
        chan=span(k_chan, d, pcfg.mask_channel_length) if pcfg.mask_channel_prob > 0 else None,
    )


def d2v_state_to_torch(state):
    """A JAX ``D2vTrainState`` -> the port's (numpy leaves in between)."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
        flax_d2v_state_to_torch,
    )

    return flax_d2v_state_to_torch(jax.tree.map(np.asarray, state))


def key_bias_slices(state_params, embed_dim: int):
    """The key-projection slice of every ``attn.qkv.bias``: its gradient is
    0 (softmax ignores a per-query constant), so Adam turns rounding noise
    there into steps of about lr, which two frameworks need not share."""
    return {k: slice(embed_dim, 2 * embed_dim) for k in state_params if k.endswith("attn.qkv.bias")}


def assert_params_close(got, want, embed_dim: int, tol=STATE_TOL, key_bias_atol=None):
    """Every leaf within ``tol``; the key-bias slices within
    ``key_bias_atol`` (Adam's step bound) when given, else ``tol`` too."""
    import torch

    assert set(got) == set(want)
    kb = key_bias_slices(want, embed_dim)
    for k, w in want.items():
        g = got[k].float().cpu()
        w = w.float().cpu()
        if k in kb and key_bias_atol is not None:
            sl = kb[k]
            torch.testing.assert_close(g[sl], w[sl], atol=key_bias_atol, rtol=0.0, msg=k)
            g = torch.cat([g[: sl.start], g[sl.stop:]])
            w = torch.cat([w[: sl.start], w[sl.stop:]])
        torch.testing.assert_close(g, w, atol=tol["atol"], rtol=tol["rtol"], msg=k)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for a module's tiny models: under
    pytest-xdist six workers with a thread per core each oversubscribe the
    cores, and a pool's threads then wait on each other at every small op.
    Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
