"""The port's d2v masking, the encoder's training forward, the d2v model's
pieces and its loss function against the JAX package, on the same
numpy-seeded inputs and the same JAX draws.

Tolerances: masks and gathers bit-equal; f32 module outputs F32_TOL (atol
3e-5 / rtol 1e-4: summation order and flax's E[x^2] - E[x]^2 variance);
losses and metrics METRIC_TOL (atol 2e-5 / rtol 1e-4)."""

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    d2v_masking as jdm,
    d2v_pretrain as jd2v,
    emotion2vec as jenc,
    layers as jlayers,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_masking as tdm,
    d2v_pretrain as td2v,
    layers as tlayers,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.emotion2vec import (
    Emotion2vecEncoder,
)

from torch_parity import (  # one_torch_thread: an autouse fixture
    F32_TOL,
    METRIC_TOL,
    cfg_pair,
    d2v_cfgs,
    d2v_state_to_torch,
    jax_d2v_draws,
    one_torch_thread,
    to_torch,
)


def T(a):
    return torch.from_numpy(np.array(a))


def span_uniforms(key, rows, t, length):
    ks, kf = jax.random.split(key)
    return (T(jax.random.uniform(ks, (rows, t - length + 1))),
            T(jax.random.uniform(kf, (rows, t))))


# ---------------------------------------------------------------------------
# masking: bit-equal from the same uniforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_span_mask_bit_equal(inverse, with_lengths):
    B, t, p, L = 8, 60, 0.5, 4
    key = jax.random.PRNGKey(3)
    lengths = np.array([60, 50, 41, 30, 12, 6, 60, 25]) if with_lengths else None
    want, n_want = jdm.sample_span_mask(key, B, t, p, L, inverse,
                                        lengths=None if lengths is None else jnp.asarray(lengths))
    got, n_got = tdm.sample_span_mask(B, t, p, L, inverse,
                                      lengths=None if lengths is None else torch.from_numpy(lengths),
                                      uniforms=span_uniforms(key, B, t, L))
    assert n_got == n_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(1) == n_got).all()


def test_random_mask_and_mask_info_bit_equal(rng):
    B, t, D = 5, 23, 4
    key = jax.random.PRNGKey(4)
    want, n = jdm.sample_random_mask(key, B, t, 0.6)
    got, n_got = tdm.sample_random_mask(B, t, 0.6, uniform=T(jax.random.uniform(key, (B, t))))
    assert n_got == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    info_j = jdm.make_mask_info(want, n)
    info_t = tdm.make_mask_info(got, n)
    np.testing.assert_array_equal(info_t.ids_keep.numpy(), np.asarray(info_j.ids_keep))
    np.testing.assert_array_equal(info_t.ids_restore.numpy(), np.asarray(info_j.ids_restore))
    assert (np.diff(info_t.ids_keep.numpy(), axis=1) > 0).all()  # temporal order kept

    x = rng.normal(size=(B, t, D)).astype(np.float32)
    m = rng.random((B, t)) < 0.3
    np.testing.assert_array_equal(tdm.gather_unmasked(torch.from_numpy(x), info_t).numpy(),
                                  np.asarray(jdm.gather_unmasked(jnp.asarray(x), info_j)))
    np.testing.assert_array_equal(
        tdm.gather_unmasked_mask(torch.from_numpy(m), info_t).numpy(),
        np.asarray(jdm.gather_unmasked_mask(jnp.asarray(m), info_j)))
    # zero and noise masking
    np.testing.assert_array_equal(tdm.apply_mask(torch.from_numpy(x), info_t).numpy(),
                                  np.asarray(jdm.apply_mask(jnp.asarray(x), info_j)))
    k_noise = jax.random.PRNGKey(5)
    want_noise = jdm.apply_mask(jnp.asarray(x), info_j, False, 0.01, k_noise)
    got_noise = tdm.apply_mask(torch.from_numpy(x), info_t, False, 0.01,
                               normal=T(jax.random.normal(k_noise, x.shape)))
    np.testing.assert_array_equal(got_noise.numpy(), np.asarray(want_noise))
    # the decoder input: kept tokens and mask tokens in temporal order
    x_enc = x[:, : t - n]
    k_tok = jax.random.PRNGKey(6)
    want_dec = jdm.restore_with_mask_tokens(jnp.asarray(x_enc), info_j, 0.01, k_tok)
    got_dec = tdm.restore_with_mask_tokens(torch.from_numpy(x_enc), info_t, 0.01,
                                           normal=T(jax.random.normal(k_tok, (B, n, D))))
    np.testing.assert_array_equal(got_dec.numpy(), np.asarray(want_dec))


def test_masks_draw_from_a_generator():
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    a, n = tdm.sample_span_mask(4, 40, 0.5, 3, generator=g1)
    b, _ = tdm.sample_span_mask(4, 40, 0.5, 3, generator=g2)
    assert torch.equal(a, b) and (a.sum(1) == n).all()
    c, _ = tdm.sample_span_mask(4, 40, 0.5, 3, generator=g1)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the encoder's training forward
# ---------------------------------------------------------------------------
def test_dropout_is_flax_dropout(rng):
    x = rng.normal(size=(4, 9, 6)).astype(np.float32) + 3.0  # no zero inputs
    rate = 0.3
    want = np.asarray(nn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(0)}))
    keep = torch.from_numpy(want != 0)
    got = tlayers.dropout(torch.from_numpy(x), rate, keep=keep)
    np.testing.assert_array_equal(got.numpy(), want)
    # the keep rate of the generator's draws
    big = torch.ones(400_000)
    frac = float((tlayers.dropout(big, rate, torch.Generator().manual_seed(1)) == 0).float().mean())
    assert abs(frac - rate) < 4 * math.sqrt(rate * (1 - rate) / big.numel())
    assert torch.equal(tlayers.dropout(big, 0.0), big)
    assert not tlayers.dropout(big, 1.0).any()


WAV = np.random.default_rng(0).normal(size=(2, 96)).astype(np.float32)


@pytest.fixture(scope="module")
def enc_params():
    """The JAX encoder's params of the tiny config: the same tree with or
    without layerdrop, alibi or layer_norm_first (cosine attention adds a
    logit scale a block)."""
    base = jenc.Emotion2vecEncoder(cfg_pair(use_flash_attention=False)[0]).init(
        jax.random.PRNGKey(0), jnp.asarray(WAV))
    cos = jax.tree.map(np.array, base)
    for name, sub in cos["params"].items():
        if "block" in name:  # the cosine branch's init of its one extra leaf
            sub["attn"]["logit_scale"] = np.full((2, 1, 1), np.log(10.0), np.float32)
    return {False: base, True: cos}


def _encoder_pair(enc_params, **overrides):
    jcfg, tcfg = cfg_pair(use_flash_attention=False, **overrides)
    params = enc_params[bool(overrides.get("cosine_attention"))]
    model = Emotion2vecEncoder(tcfg)
    model.load_state_dict(to_torch(params))
    return jcfg, params, model, WAV


def test_layerdrop_off_at_inference_and_one_skips_the_main_blocks(enc_params):
    """tests/test_encoder_branches.py:155 and :165 for the port: layerdrop
    does nothing when deterministic; layerdrop 1.0 (dropout off) leaves the
    output of a depth-0 encoder."""
    off = dict(encoder_dropout=0.0, attention_dropout=0.0, post_mlp_drop=0.0)
    jcfg, params, model, wav = _encoder_pair(enc_params, layerdrop=0.5, **off)
    want, _ = jenc.Emotion2vecEncoder(cfg_pair(use_flash_attention=False, **off)[0]).apply(
        params, jnp.asarray(wav))
    got, _ = model(torch.from_numpy(wav))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)

    jcfg, params, model, wav = _encoder_pair(enc_params, layerdrop=1.0, **off)
    got, _ = model(torch.from_numpy(wav), deterministic=False,
                   generator=torch.Generator().manual_seed(0))
    d0 = cfg_pair(use_flash_attention=False, depth=0, **off)[0]
    p0 = {"params": {k: v for k, v in params["params"].items() if not k.startswith("block_")}}
    want0, _ = jenc.Emotion2vecEncoder(d0).apply(p0, jnp.asarray(wav))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want0), **F32_TOL)


@pytest.mark.parametrize("branch", ["cosine_attention", "use_alibi_encoder", "layer_norm_first"])
def test_encoder_branches_match_jax(enc_params, branch):
    jcfg, params, model, wav = _encoder_pair(enc_params, **{branch: True})
    if branch == "cosine_attention":
        # move the logit scales off their init, one past the clamp
        p = jax.tree.map(np.array, params)
        for name in p["params"]:
            if "block" in name:
                p["params"][name]["attn"]["logit_scale"] += np.array(
                    [[[3.0]], [[-1.0]]], np.float32)
        params = p
        model.load_state_dict(to_torch(params))
    pad = np.zeros((2, 96), bool)
    pad[1, 70:] = True
    want, want_fm = jenc.Emotion2vecEncoder(jcfg).apply(params, jnp.asarray(wav), jnp.asarray(pad))
    got, fm = model(torch.from_numpy(wav), torch.from_numpy(pad))
    valid = ~np.asarray(want_fm)
    np.testing.assert_array_equal(fm.numpy(), np.asarray(want_fm))
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(want)[valid], **F32_TOL)


def test_alibi_slopes_and_bias_match_jax():
    for h in (1, 2, 3, 8, 12):
        np.testing.assert_allclose(tlayers.alibi_slopes(h), jlayers.alibi_slopes(h), rtol=1e-12)
    np.testing.assert_allclose(tlayers.alibi_bias(7, 3, 2.0).numpy(),
                               np.asarray(jlayers.alibi_bias(7, 3, 2.0)), rtol=1e-7)


def test_cosine_attention_with_bias_matches_jax(rng):
    D, H, N = 12, 3, 7
    x = rng.normal(size=(2, N, D)).astype(np.float32)
    pad = np.zeros((2, N), bool)
    pad[1, 5:] = True
    bias = rng.normal(size=(1, H, N, N)).astype(np.float32)
    attn_j = jlayers.AltAttention(dim=D, num_heads=H, cosine_attention=True)
    params = attn_j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad))
    want = attn_j.apply(params, jnp.asarray(x), jnp.asarray(pad), jnp.asarray(bias))
    attn_t = tlayers.AltAttention(D, H, cosine_attention=True)
    attn_t.load_state_dict(to_torch(params))
    got = attn_t(torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# the d2v model's pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [3, 4])  # an even kernel trims (SamePad)
def test_decoder1d_matches_jax(rng, kernel):
    jcfg, jp, tcfg, tp = d2v_cfgs(dec=dict(decoder_kernel=kernel, projection_layers=2))
    x = rng.normal(size=(3, 11, 16)).astype(np.float32)
    dec_j = jd2v.Decoder1d(dcfg=jp.decoder, input_dim=16)
    params = dec_j.init(jax.random.PRNGKey(1), jnp.asarray(x))
    dec_t = td2v.Decoder1d(tp.decoder, 16)
    dec_t.load_state_dict(to_torch(params))
    np.testing.assert_allclose(dec_t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(dec_j.apply(params, jnp.asarray(x))), **F32_TOL)


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(instance_norm_target_layer=False, layer_norm_target_layer=True),
    dict(instance_norm_target_layer=False, layer_norm_targets=True),
    dict(instance_norm_targets=True),
])
def test_make_targets_matches_jax(rng, knobs):
    _jc, jp, _tc, tp = d2v_cfgs(**knobs)
    layers = [rng.normal(size=(2, 9, 16)).astype(np.float32) * (i + 1) for i in range(3)]
    want = jd2v.make_targets([jnp.asarray(t) for t in layers], jp)
    got = td2v.make_targets([torch.from_numpy(t) for t in layers], tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("beta,scale", [(0.0, None), (0.5, 0.3)])
def test_d2v_loss_matches_jax(rng, beta, scale):
    pred, target = (rng.normal(size=(3, 7, 16)).astype(np.float32) for _ in range(2))
    w = rng.random((3, 7)) < 0.6
    want = jd2v.d2v_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w), beta, scale)
    got = td2v.d2v_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(w),
                        beta, scale)
    np.testing.assert_allclose(float(got), float(want), **METRIC_TOL)


def test_compute_var_and_annealed_decay_match_jax(rng):
    y = rng.normal(size=(4, 6, 8)).astype(np.float32)
    valid = rng.random((4, 6)) < 0.5
    np.testing.assert_allclose(float(td2v.compute_var(torch.from_numpy(y))),
                               float(jd2v.compute_var(jnp.asarray(y))), **METRIC_TOL)
    np.testing.assert_allclose(
        float(td2v.compute_var(torch.from_numpy(y), torch.from_numpy(valid))),
        float(jd2v.compute_var(jnp.asarray(y), jnp.asarray(valid))), **METRIC_TOL)
    _jc, jp, _tc, tp = d2v_cfgs(ema_decay=0.99, ema_end_decay=0.999, ema_anneal_end_step=10)
    for s in (0, 3, 10, 25):
        np.testing.assert_allclose(
            float(td2v.annealed_decay(tp, torch.tensor(s, dtype=torch.int32))),
            float(jd2v.annealed_decay(jp, jnp.asarray(s, jnp.int32))), rtol=1e-7)


@pytest.mark.parametrize("warmup,steps", [(3, 15), (8000, 4), (0, 5)])
def test_learning_rate_schedule_matches_optax(warmup, steps):
    import optax

    _jc, jp, _tc, tp = d2v_cfgs(warmup_steps=warmup, max_steps=steps)
    w = min(warmup, max(steps - 1, 0))
    sched = optax.warmup_cosine_decay_schedule(0.0, jp.learning_rate, w, max(steps, w + 1))
    tx = td2v.build_d2v_optimizer(tp)
    for c in range(steps + 2):
        np.testing.assert_allclose(float(tx.learning_rate(torch.tensor(c, dtype=torch.int32))),
                                   float(sched(c)), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the loss function fed the JAX draws
# ---------------------------------------------------------------------------
LOSS_CASES = {
    # clone_batch 2, noise in place of masked inputs, channel masking, a
    # teacher that re-extracts with its own EMA copy of every encoder module
    "noise_channels_whole_ema": dict(clone_batch=2, encoder_zero_mask=False,
                                     mask_noise_std=0.1, mask_channel_prob=0.3,
                                     mask_channel_length=4, ema_encoder_only=False),
    "random_mask": dict(clone_batch=2, mask_length=1, mask_prob=0.6),
    "inverse_span_smooth_l1": dict(clone_batch=1, inverse_mask=True, mask_prob=0.6,
                                   loss_beta=0.25, layer_norm_targets=True),
}


@pytest.fixture(scope="module")
def d2v_init():
    """A JAX D2vTrainState of the tiny config (the param tree does not
    depend on the masking, loss or EMA knobs)."""
    jcfg, jp, _tc, _tp = d2v_cfgs()
    return jd2v.init_d2v_state(jcfg, jp, jax.random.PRNGKey(0), example_len=640)[2]


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_fn_fed_jax_draws_matches_jax(rng, d2v_init, case):
    jcfg, jp, tcfg, tp = d2v_cfgs(**LOSS_CASES[case])
    model = jd2v.D2vPretrainModel(jcfg, jp)
    state = d2v_init
    # a teacher apart from the student
    ema = jax.tree.map(lambda a: a * 0.9 + 0.01, jd2v.init_ema_blocks(state.params, jcfg, jp))
    wav = rng.normal(size=(2, 640)).astype(np.float32)
    pad = np.zeros((2, 640), bool)
    pad[1, 400:] = True
    key = jax.random.PRNGKey(11)
    total, metrics = jax.jit(jd2v.make_d2v_loss_fn(model, train=True))(
        state.params, ema, jnp.asarray(wav), jnp.asarray(pad), key)

    tstate = d2v_state_to_torch(state._replace(ema_blocks=ema))
    tmodel, _ttx, _ = td2v.init_d2v_state(tcfg, tp)
    t = td2v.conv_frames(640, tcfg.conv_feature_layers)
    draws = jax_d2v_draws(key, jp, 2 * tp.clone_batch, t, tcfg.embed_dim)
    got_total, got = td2v.make_d2v_loss_fn(tmodel, train=True)(
        tstate.params, tstate.ema_blocks, torch.from_numpy(wav), torch.from_numpy(pad),
        None, draws)
    np.testing.assert_allclose(float(got_total), float(total), **METRIC_TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), **METRIC_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the step's own properties
# ---------------------------------------------------------------------------
def test_remat_gives_the_same_update_with_dropout_on(rng):
    """--remat recomputes each block in the backward from masks drawn
    before it: the same loss, gradients and state as without, dropout on."""
    drop = dict(encoder_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                post_mlp_drop=0.1)
    wav = torch.from_numpy(rng.normal(size=(2, 640)).astype(np.float32))
    pad = torch.zeros(2, 640, dtype=torch.bool)
    pad[1, 500:] = True
    ends = []
    for remat in (False, True):
        _jc, _jp, tcfg, tp = d2v_cfgs(enc=drop, dec=dict(input_dropout=0.1), remat_blocks=remat)
        model, tx, state = td2v.init_d2v_state(tcfg, tp, torch.Generator().manual_seed(0))
        state, m = td2v.make_d2v_train_step(model, tx)(state, wav, pad,
                                                       torch.Generator().manual_seed(1))
        ends.append((state, m))
    (a, ma), (b, mb) = ends
    assert float(ma["loss"]) == float(mb["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k


def test_dropout_on_changes_the_step(rng):
    wav = torch.from_numpy(rng.normal(size=(2, 640)).astype(np.float32))
    pad = torch.zeros(2, 640, dtype=torch.bool)
    losses = []
    for rate in (0.0, 0.3):
        _jc, _jp, tcfg, tp = d2v_cfgs(enc=dict(encoder_dropout=rate, post_mlp_drop=rate))
        model, tx, state = td2v.init_d2v_state(tcfg, tp, torch.Generator().manual_seed(0))
        _s, m = td2v.make_d2v_train_step(model, tx)(state, wav, pad,
                                                    torch.Generator().manual_seed(1))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_training_step_refuses_the_forward_only_kernel(rng):
    wav = torch.from_numpy(rng.normal(size=(2, 640)).astype(np.float32))
    pad = torch.zeros(2, 640, dtype=torch.bool)
    for flash, crop in ((True, 640), ("auto", 2100)):  # 2100 samples: 524 frames
        _jc, _jp, tcfg, tp = d2v_cfgs(enc=dict(use_flash_attention=flash), crop_size=crop)
        model, tx, state = td2v.init_d2v_state(tcfg, tp)
        with pytest.raises(ValueError, match="forward-only"):
            td2v.make_d2v_train_step(model, tx)
    # "auto" under the threshold trains; evaluation takes the kernel as configured
    _jc, _jp, tcfg, tp = d2v_cfgs(enc=dict(use_flash_attention="auto"))
    model, tx, state = td2v.init_d2v_state(tcfg, tp)
    td2v.make_d2v_train_step(model, tx)
    _jc, _jp, tcfg, tp = d2v_cfgs(enc=dict(use_flash_attention=True))
    model, tx, state = td2v.init_d2v_state(tcfg, tp)
    m = td2v.make_d2v_eval_step(model)(state.params, state.ema_blocks, wav, pad,
                                       torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))


def test_init_params_follow_flax_defaults():
    _jc, _jp, tcfg, tp = d2v_cfgs(enc=dict(embed_dim=64, num_heads=4))
    model, _tx, state = td2v.init_d2v_state(tcfg, tp, torch.Generator().manual_seed(0))
    w = state.params["block_0.mlp.fc1.weight"]  # (256, 64): lecun normal, fan_in 64
    assert abs(float(w.std()) - 64**-0.5) < 0.1 * 64**-0.5
    assert float(w.abs().max()) <= 2 * 64**-0.5 / 0.87962566103423978 + 1e-6
    assert not state.params["block_0.mlp.fc1.bias"].any()
    assert torch.equal(state.params["block_0.norm1.weight"], torch.ones(64))
    assert set(state.ema_blocks) == {k for k in state.params if k.startswith("block_")}
    enc_keys = set(td2v.encoder_params(state.params))
    assert enc_keys == set(Emotion2vecEncoder(tcfg).state_dict())
