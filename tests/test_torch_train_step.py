"""The port's DAD train steps against the JAX package's, from one state.

Both sides start from the same JAX ``DADTrainState`` (carried over by
``flax_train_state_to_torch``) and take three steps, epochs 0 (warmup), 2
and 3 (post-warmup, consistency and ECDA on), with the per-epoch learning
rate and the epoch-end DACP update between them. The port is fed the JAX
step's own random draws (injection noise, weak and strong augmentation);
head dropout is off for the exact comparison, and its rate and scale are
checked statistically on their own. DACP is set up so that its mask lets
rows through, so the consistency and ECDA terms carry weight.

Tolerance (f32 on the CPU, summation order only): metrics and tracked
scores atol 2e-5 / rtol 1e-4; parameters, Adam moments and DACP state
atol 2e-6 / rtol 1e-4 after each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad import (
    StepScalars as JaxStepScalars,
    init_dad_train_state as jax_init_state,
    make_dad_train_step as jax_make_step,
    set_learning_rate as jax_set_lr,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad.train_step import (
    cosine_lr as jax_cosine_lr,
    epoch_end_dacp as jax_epoch_end,
    smoothed_ce as jax_smoothed_ce,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    Batch as JaxBatch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel import (
    FusedConfig as JaxFusedConfig,
    init_fused as jax_init_fused,
    make_fused_extract_train_step as jax_make_fused_step,
    precompute_clean_features as jax_precompute,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel.fused import (
    FusedBatch as JaxFusedBatch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    Batch,
    StepDraws,
    StepScalars,
    cosine_lr,
    epoch_end_dacp,
    init_dad_train_state,
    make_dad_train_step,
    set_learning_rate,
    smoothed_ce,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_train_state_to_torch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.heads import (
    dropout,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    conv_out_lengths,
    convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    FusedBatch,
    FusedConfig,
    init_fused,
    make_fused_extract_train_step,
    precompute_clean_features,
)

from torch_parity import TINY, cfg_pair, jax_normal, jax_strong_draws, to_torch

METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
EPOCHS = (0, 2, 3)
# DACP lets rows through from the first batch: with alpha 0 and a quantile
# level starting at 0 the threshold is each class's lowest score
OVERRIDES = {"dacp.quantile_start": 0.0, "dacp.quantile_end": 0.2,
             "dacp.threshold_smoothing_alpha": 0.0}


def _cfgs(input_dim=16, **kw):
    args = dict(input_dim=input_dim, hidden_dim=8, batch_size=12, warmup_epochs=1,
                ecda_start_epoch=1, epochs=10, weight_ramp_epochs=2, dropout_rate=0.0)
    args.update(kw)
    return jax_dad_preset("iemocap", OVERRIDES, **args), dad_preset("iemocap", OVERRIDES, **args)


def _numpy_state(state):
    return jax.tree.map(np.array, state)  # copies: the JAX step donates its state


def _assert_states_close(port_state, jax_state):
    want = flax_train_state_to_torch(_numpy_state(jax_state))
    for role in ("student", "teacher"):
        for k, v in getattr(want.ssrl, role).items():
            torch.testing.assert_close(getattr(port_state.ssrl, role)[k], v, **STATE_TOL,
                                       msg=f"{role} {k}")
    for part in ("mu", "nu"):
        for k, v in getattr(want.opt_state, part).items():
            torch.testing.assert_close(getattr(port_state.opt_state, part)[k], v,
                                       **STATE_TOL, msg=f"adam {part} {k}")
    assert int(port_state.opt_state.count) == int(want.opt_state.count)
    torch.testing.assert_close(port_state.opt_state.learning_rate, want.opt_state.learning_rate)
    for f, v in want.dacp._asdict().items():
        torch.testing.assert_close(getattr(port_state.dacp, f), v, **STATE_TOL, msg=f"dacp {f}")


def _assert_metrics_close(got, want):
    for k in ("total_loss", "supervised_ce_loss", "consistency_loss", "ecda_loss",
              "high_confidence_count"):
        torch.testing.assert_close(got[k], torch.tensor(float(want[k])), **METRIC_TOL, msg=k)


def _assert_tracking_close(got, want):
    np.testing.assert_array_equal(got["pseudo_label"].numpy(), np.asarray(want["pseudo_label"]))
    np.testing.assert_array_equal(got["is_masked_in"].numpy(), np.asarray(want["is_masked_in"]))
    np.testing.assert_allclose(got["certainty_score"].numpy(),
                               np.asarray(want["certainty_score"]), **METRIC_TOL)


def _feature_batch(rng, B=12, T=6, D=16, labeled=True, shift=0.0):
    feats = (rng.normal(size=(B, T, D)) + shift).astype(np.float32)
    lengths = rng.integers(2, T + 1, B)
    pm = np.arange(T)[None, :] >= lengths[:, None]
    labels = rng.integers(0, 4, B).astype(np.int32) if labeled else np.full(B, -1, np.int32)
    if labeled:
        feats += labels[:, None, None] * 0.5  # class-dependent features
    row_valid = np.ones(B, bool)
    row_valid[-1] = not labeled  # one padded clean row
    return JaxBatch(feats=feats, padding_mask=pm, labels=labels,
                    ids=np.arange(B, dtype=np.int32), row_valid=row_valid)


def _to_port(batch):
    return Batch(*(None if v is None else torch.from_numpy(np.asarray(v)) for v in batch))


def test_smoothed_ce_matches_jax(rng):
    logits = rng.normal(size=(10, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 10).astype(np.int32)
    valid = np.arange(10) < 7
    want = float(jax_smoothed_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid), 0.05))
    got = smoothed_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(valid), 0.05)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_step_scalars_and_cosine_lr_match_jax():
    jcfg, tcfg = _cfgs()
    for epoch in range(12):
        want = JaxStepScalars.for_epoch(jcfg, epoch)
        got = StepScalars.for_epoch(tcfg, epoch)
        assert got.warmup == bool(want.warmup)
        for f in ("w_consistency", "w_ecda", "gamma_e"):
            np.testing.assert_allclose(getattr(got, f), float(getattr(want, f)), rtol=1e-6)
        assert cosine_lr(tcfg, epoch) == jax_cosine_lr(jcfg, epoch)


def test_feature_step_matches_jax_over_three_steps(rng):
    jcfg, tcfg = _cfgs()
    head, tx, jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax_make_step(head, tx, jcfg)
    thead, ttx, _ = init_dad_train_state(tcfg, torch.Generator().manual_seed(0))
    tstep = make_dad_train_step(thead, ttx, tcfg)
    state = flax_train_state_to_torch(_numpy_state(jstate))

    clean = _feature_batch(rng)
    noisy = _feature_batch(rng, labeled=False, shift=0.3)
    anchors = np.zeros(4, np.float32)
    seen = []
    for epoch in EPOCHS:
        lr = cosine_lr(tcfg, epoch)
        jstate = jstate._replace(opt_state=jax_set_lr(jstate.opt_state, jax_cosine_lr(jcfg, epoch)))
        state = state._replace(opt_state=set_learning_rate(state.opt_state, lr))
        key = jax.random.PRNGKey(10 + epoch)
        _k_dc, k_weak, k_strong, _k_ds = jax.random.split(key, 4)
        draws = StepDraws(weak=jax_normal(k_weak, noisy.feats.shape),
                          strong=jax_strong_draws(k_strong, noisy.feats.shape,
                                                  noisy.padding_mask, jcfg.augment))
        jstate, jm, jtr = jstep(jstate, clean, noisy, JaxStepScalars.for_epoch(jcfg, epoch),
                                jnp.asarray(anchors), key)
        state, m, tr = tstep(state, _to_port(clean), _to_port(noisy),
                             StepScalars.for_epoch(tcfg, epoch), torch.from_numpy(anchors),
                             None, draws)
        _assert_metrics_close(m, jm)
        _assert_tracking_close(tr, jtr)
        jstate = jax_epoch_end(jstate, jcfg)
        state = epoch_end_dacp(state, tcfg)
        _assert_states_close(state, jstate)
        seen.append({k: float(v) for k, v in m.items()})
    # the comparison covered the terms that matter after warmup
    assert seen[0]["consistency_loss"] == 0.0 and seen[0]["ecda_loss"] == 0.0
    assert max(s["consistency_loss"] for s in seen[1:]) > 0
    assert max(s["ecda_loss"] for s in seen[1:]) > 0


def _wav_batch(rng, lengths, T, labeled, filler=False):
    B = len(lengths)
    wav = np.zeros((B, T), np.float32)
    mask = np.ones((B, T), bool)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.normal(size=n) * 0.3
        mask[i, :n] = False
    labels = np.arange(B, dtype=np.int32) % 4 if labeled else np.full(B, -1, np.int32)
    row_valid = np.array(lengths) > 0 if filler else np.ones(B, bool)
    return JaxFusedBatch(wav=wav, wav_mask=mask, labels=labels, row_valid=row_valid)


def _fused_port(batch):
    return FusedBatch(*(torch.from_numpy(np.asarray(v)) for v in batch[:4]))


@pytest.mark.parametrize("cache_clean", [True, False])
def test_fused_step_matches_jax_over_three_steps(rng, cache_clean):
    """The fused extract+train step on the TINY encoder (attention through
    the Pallas kernel in interpret mode on the JAX side, the plain version
    on the port's), white noise at 10 dB, one filler row in the noisy
    batch."""
    jenc_cfg, tenc_cfg = cfg_pair()
    jdad, tdad = _cfgs(input_dim=TINY["embed_dim"], batch_size=8)
    jcfg = JaxFusedConfig(encoder=jenc_cfg, dad=jdad, inject_snr_db=10.0,
                          cache_clean_features=cache_clean)
    tcfg = FusedConfig(encoder=tenc_cfg, dad=tdad, inject_snr_db=10.0,
                       cache_clean_features=cache_clean)
    encoder, enc_params, head, tx, jstate = jax_init_fused(jcfg, jax.random.PRNGKey(3),
                                                           example_len=400)
    jstep = jax_make_fused_step(encoder, head, tx, jcfg)
    tenc, thead, ttx, _ = init_fused(tcfg, to_torch(enc_params), device="cpu")
    tstep = make_fused_extract_train_step(tenc, thead, ttx, tcfg)
    state = flax_train_state_to_torch(_numpy_state(jstate))

    T = 400
    clean = _wav_batch(rng, [400, 350, 300, 400, 250, 380, 400, 330], T, labeled=True)
    noisy = _wav_batch(rng, [400, 310, 0, 390, 270, 400, 360, 400], T, labeled=False,
                       filler=True)
    jclean, tclean = clean, _fused_port(clean)
    if cache_clean:
        jclean = jax_precompute(encoder, enc_params, jcfg, clean)
        tclean = precompute_clean_features(tenc, tcfg, tclean)
        valid = ~np.asarray(jclean.frame_mask)
        np.testing.assert_array_equal(tclean.frame_mask.numpy(), ~valid)
        np.testing.assert_allclose(tclean.feats.numpy()[valid], np.asarray(jclean.feats)[valid],
                                   atol=3e-5, rtol=1e-4)
    layers = tenc_cfg.conv_feature_layers
    t_frames = int(conv_out_lengths(torch.tensor([T]), layers)[0])
    fmask = convert_padding_mask(torch.from_numpy(noisy.wav_mask), t_frames, layers).numpy()
    feat_shape = (len(noisy.labels), t_frames, TINY["embed_dim"])

    anchors = np.zeros(4, np.float32)
    seen = []
    for epoch in EPOCHS:
        jstate = jstate._replace(opt_state=jax_set_lr(jstate.opt_state, jax_cosine_lr(jdad, epoch)))
        state = state._replace(opt_state=set_learning_rate(state.opt_state, cosine_lr(tdad, epoch)))
        key = jax.random.PRNGKey(20 + epoch)
        k_inj, _k_dc, k_w, k_s, _k_ds = jax.random.split(key, 5)
        draws = StepDraws(inject=jax_normal(k_inj, noisy.wav.shape),
                          weak=jax_normal(k_w, feat_shape),
                          strong=jax_strong_draws(k_s, feat_shape, fmask, jdad.augment))
        jstate, jm = jstep(enc_params, jstate, jclean, noisy,
                           JaxStepScalars.for_epoch(jdad, epoch), jnp.asarray(anchors), key)
        state, m = tstep(state, tclean, _fused_port(noisy), StepScalars.for_epoch(tdad, epoch),
                         torch.from_numpy(anchors), None, draws=draws)
        _assert_metrics_close(m, jm)
        jstate = jax_epoch_end(jstate, jdad)
        state = epoch_end_dacp(state, tdad)
        _assert_states_close(state, jstate)
        seen.append({k: float(v) for k, v in m.items()})
    assert max(s["consistency_loss"] for s in seen[1:]) > 0
    assert max(s["ecda_loss"] for s in seen[1:]) > 0


def test_fused_step_draws_from_its_generator_and_rejects_a_mesh(rng):
    _jenc, tenc_cfg = cfg_pair(use_flash_attention=False)
    _jdad, tdad = _cfgs(input_dim=TINY["embed_dim"], batch_size=4)
    tcfg = FusedConfig(encoder=tenc_cfg, dad=tdad, inject_snr_db=5.0, cache_clean_features=False)
    g = torch.Generator().manual_seed(0)
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
        Emotion2vecEncoder,
    )

    enc_state = {k: torch.randn(v.shape, generator=g) * 0.2
                 for k, v in Emotion2vecEncoder(tenc_cfg).state_dict().items()}
    enc, head, tx, state0 = init_fused(tcfg, enc_state, torch.Generator().manual_seed(1),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        make_fused_extract_train_step(enc, head, tx, tcfg, mesh=object())
    step = make_fused_extract_train_step(enc, head, tx, tcfg)
    batch = _fused_port(_wav_batch(rng, [300, 200, 300, 250], 300, labeled=True))
    noisy = batch._replace(labels=torch.full((4,), -1), ids=torch.arange(4))
    scalars = StepScalars.for_epoch(tdad, 3)
    outs = [step(state0, batch, noisy, scalars, torch.zeros(4), torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    (s1, m1), (s2, m2), (s3, _m3) = outs
    assert set(m1["tracking"]) == {"ids", "pseudo_label", "certainty_score", "is_masked_in"}
    for k in s1.ssrl.student:
        assert torch.equal(s1.ssrl.student[k], s2.ssrl.student[k])  # same seed, same step
    assert any(not torch.equal(s1.ssrl.student[k], s3.ssrl.student[k]) for k in s1.ssrl.student)
    for k in s1.ssrl.teacher:  # post-warmup: the teacher follows the student
        assert not torch.equal(s1.ssrl.teacher[k], state0.ssrl.teacher[k])


def test_dropout_rate_and_scale():
    x = torch.ones(200_000)
    out = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    # binomial: 0.9 +- 5 sigma, sigma = sqrt(0.09 / 2e5) = 6.7e-4
    assert abs(float(kept.float().mean()) - 0.9) < 5 * 6.7e-4
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.0, None), x)
