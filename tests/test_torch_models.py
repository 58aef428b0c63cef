"""The port's encoder, converters and head against the JAX package's, on
the same numpy inputs and the same fairseq-layout weights
(``torch_mirror.rand_sd``). Attention goes through the kernel path: the
Pallas kernel in interpret mode on the JAX side, the plain version on the
port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    Emotion2vecEncoder as JaxEncoder,
    extract_features as jax_extract_features,
    init_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.convert import (
    fairseq_to_flax_encoder,
    ssrl_to_torch_state_dict as jax_ssrl_to_torch_state_dict,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.emotion2vec import (
    normalize_wav as jax_normalize_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.layers import (
    conv_out_lengths as jax_conv_out_lengths,
    convert_padding_mask as jax_convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.ops.masked import (
    masked_mean_pool as jax_masked_mean_pool,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    DADHead,
    Emotion2vecEncoder,
    extract_features,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    flax_encoder_to_torch,
    load_emotion2vec_checkpoint,
    torch_state_dict_to_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
    normalize_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    conv_out_lengths,
    convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops.masked import (
    masked_mean_pool,
)

from torch_mirror import rand_sd
from torch_parity import F32_TOL, cfg_pair

LENS = (97, 61, 130)  # 130 fills the padded length; 97/61 are padded


def _batch(rng, lens=LENS, T=130):
    wav = np.zeros((len(lens), T), np.float32)
    pad = np.ones((len(lens), T), bool)
    for i, L in enumerate(lens):
        wav[i, :L] = rng.normal(size=L)
        pad[i, :L] = False
    return wav, pad


def _both(seed=1, **overrides):
    """JAX model + params and the port's model, from one rand_sd."""
    jcfg, tcfg = cfg_pair(**overrides)
    sd = rand_sd(jcfg, seed=seed)
    params = fairseq_to_flax_encoder(sd, jcfg)
    model = Emotion2vecEncoder(tcfg)
    model.load_state_dict(fairseq_to_torch_encoder(sd, tcfg))
    return JaxEncoder(jcfg), params, model


@pytest.mark.parametrize("overrides, tol", [
    (dict(), F32_TOL),
    (dict(use_flash_attention=False), F32_TOL),
    (dict(use_flash_attention="auto"), F32_TOL),
    (dict(fast_ln=True, fast_softmax=True, use_flash_attention=False), F32_TOL),
    (dict(gelu_approximate=True), F32_TOL),
    # the bf16 serving path: every activation rounds to bf16 (8 bits of
    # mantissa) at the JAX package's cast points; post-LN outputs are O(1-3),
    # so a few ulps there reach ~0.05
    (dict(dtype="bfloat16", gelu_approximate=True), dict(atol=0.1, rtol=0.05)),
    (dict(dtype="bfloat16", fast_conv_norm=True), dict(atol=0.1, rtol=0.05)),
])
def test_encoder_matches_jax_on_valid_frames(rng, overrides, tol):
    jmodel, params, model = _both(**overrides)
    wav, pad = _batch(rng)
    want, want_mask = jax_extract_features(jmodel, params, jnp.asarray(wav), jnp.asarray(pad))
    got, got_mask = extract_features(model, torch.from_numpy(wav), torch.from_numpy(pad))
    want_mask = np.asarray(want_mask)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got[~want_mask], want[~want_mask], **tol)
    if overrides.get("dtype") == "bfloat16":
        # most elements agree far inside the bound
        assert np.mean(np.abs(got - want)[~want_mask]) < 0.01


def test_encoder_padded_batch_equals_per_clip(rng):
    _jm, _p, model = _both(seed=2)
    wav, pad = _batch(rng)
    feats, frame_mask = extract_features(model, torch.from_numpy(wav), torch.from_numpy(pad))
    for i, L in enumerate(LENS):
        alone, _ = extract_features(model, torch.from_numpy(wav[i : i + 1, :L]))
        n_valid = int((~frame_mask[i]).sum())
        assert n_valid == alone.shape[1]
        np.testing.assert_allclose(feats[i, :n_valid].numpy(), alone[0].numpy(), **F32_TOL)


def test_normalize_wav_matches_jax(rng):
    wav, pad = _batch(rng)
    wav = wav * 3 + 0.5 * ~pad
    for mask in (None, pad):
        want = np.asarray(jax_normalize_wav(
            jnp.asarray(wav), None if mask is None else jnp.asarray(mask)))
        got = normalize_wav(torch.from_numpy(wav),
                            None if mask is None else torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_conv_lengths_and_padding_mask_match_jax():
    layers = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
              (512, 3, 2), (512, 2, 2), (512, 2, 2))
    # includes clips shorter than the receptive field (0 and negative lengths)
    lengths = np.array([0, 3, 9, 10, 399, 400, 16000, 123457, 480000], np.int32)
    want = np.asarray(jax_conv_out_lengths(jnp.asarray(lengths), layers))
    got = conv_out_lengths(torch.from_numpy(lengths), layers).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[-1] == 1499 and want[-3] == 49

    T = 3000
    pad = np.arange(T)[None, :] >= np.array([0, 5, 1000, 2999, 3000])[:, None]
    out_t = int(jax_conv_out_lengths(jnp.asarray([T]), layers)[0])
    want = np.asarray(jax_convert_padding_mask(jnp.asarray(pad), out_t, layers))
    got = convert_padding_mask(torch.from_numpy(pad), out_t, layers).numpy()
    np.testing.assert_array_equal(got, want)


def test_native_loader_equals_flax_converter():
    jcfg, tcfg = cfg_pair()
    sd = rand_sd(jcfg, seed=3)
    native = fairseq_to_torch_encoder(sd, tcfg)
    via_flax = flax_encoder_to_torch(jax.tree.map(np.asarray, fairseq_to_flax_encoder(sd, jcfg)))
    assert native.keys() == via_flax.keys()
    assert native.keys() == Emotion2vecEncoder(tcfg).state_dict().keys()
    for key in native:
        assert torch.equal(native[key], via_flax[key]), key


def test_native_loader_audit(tmp_path):
    jcfg, tcfg = cfg_pair()
    sd = rand_sd(jcfg, seed=4)
    # known pretraining-only weights are skipped, anything else raises
    dead = dict(sd, **{"modality_encoders.AUDIO.decoder.proj.weight": torch.zeros(2),
                       "_ema": torch.zeros(1)})
    assert fairseq_to_torch_encoder(dead, tcfg).keys() == fairseq_to_torch_encoder(sd, tcfg).keys()
    with pytest.raises(ValueError, match="does not recognize"):
        fairseq_to_torch_encoder(dict(sd, **{"blocks.0.extra.weight": torch.zeros(1)}), tcfg)
    wrong = dict(sd)
    wrong["blocks.0.attn.qkv.weight"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        fairseq_to_torch_encoder(wrong, tcfg)
    # checkpoint file round trip with the fairseq {'model': ...} nesting
    path = tmp_path / "e2v.pt"
    torch.save({"model": sd, "cfg": {"note": "not a tensor"}}, path)
    loaded = load_emotion2vec_checkpoint(str(path), tcfg)
    for key, value in fairseq_to_torch_encoder(sd, tcfg).items():
        assert torch.equal(loaded[key], value)


def test_dead_branches_raise():
    """The branches the shipped config never takes (cosine attention, alibi,
    layer_norm_first) and the training forward no longer raise: each builds
    and runs, and with every dropout off the training forward equals the
    deterministic one (tests/test_torch_d2v_model.py holds them to JAX)."""
    off = dict(encoder_dropout=0.0, attention_dropout=0.0, post_mlp_drop=0.0,
               use_flash_attention=False)
    wav = torch.randn(2, 100, generator=torch.Generator().manual_seed(0))
    for overrides in (dict(cosine_attention=True), dict(use_alibi_encoder=True),
                      dict(layer_norm_first=True), {}):
        model = Emotion2vecEncoder(cfg_pair(**overrides, **off)[1])
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(1))
        det, _ = model(wav)
        train, _ = model(wav, deterministic=False, generator=torch.Generator().manual_seed(2))
        assert torch.isfinite(det).all()
        torch.testing.assert_close(train, det, atol=0.0, rtol=0.0)


def test_dad_head_and_ssrl_layout_match_jax(rng):
    head_j, ssrl = init_ssrl(jax.random.PRNGKey(0), input_dim=32, hidden_dim=8)
    feats = rng.normal(size=(3, 10, 32)).astype(np.float32)
    mask = np.zeros((3, 10), bool)
    mask[1, 6:] = True
    mask[2, :] = True  # all padded: pools to 0 (count clipped at 1)
    want_logits, want_emb = head_j.apply(ssrl.student, jnp.asarray(feats), jnp.asarray(mask))

    head = DADHead(32, 8)
    head.load_state_dict(flax_encoder_to_torch(ssrl.student))
    logits, emb = head(torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=1e-5)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(want_emb), atol=1e-5)

    # the reference SSRL checkpoint layout, written by the JAX package
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jax_ssrl_to_torch_state_dict(ssrl).items()}
    state = torch_state_dict_to_ssrl(sd)
    for role, tree in (("student", ssrl.student), ("teacher", ssrl.teacher)):
        want = flax_encoder_to_torch(tree)
        got = getattr(state, role)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v)


def test_masked_mean_pool_matches_jax(rng):
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = np.array([[False, False, True, True, True], [False] * 5, [True] * 5])
    want = np.asarray(jax_masked_mean_pool(jnp.asarray(x), jnp.asarray(mask)))
    got = masked_mean_pool(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
