"""The port's DAD building blocks against the JAX package's on the same
numpy inputs: masked quantile and softmax stats, MMD, weak/strong
augmentation (fed the JAX draws), DACP over several batches with the
epoch-end update, and ECDA in both branches with gradients.

Tolerance: f32 on the CPU, summation order only: atol 1e-5 / rtol 1e-5
for values, 1e-5 / 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    AugmentConfig as JaxAugmentConfig,
    DACPConfig as JaxDACPConfig,
    ECDAConfig as JaxECDAConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad import (
    augment as jaug,
    dacp as jdacp,
    ecda as jecda,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.ops import (
    masked as jmasked,
    mmd as jmmd,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    augment,
    dacp,
    ecda,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    masked,
    mmd,
)

from torch_parity import jax_normal, jax_strong_draws, port_cfg

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("q", [0.0, 0.37, 0.5, 1.0])
def test_masked_quantile_matches_jax_and_torch_quantile(rng, q):
    scores = rng.random((4, 9)).astype(np.float32)
    member = rng.random((4, 9)) < 0.5
    member[0] = False  # empty class -> fallback
    member[1] = [True] + [False] * 8  # a single member
    fallback = np.array([0.11, 0.22, 0.33, 0.44], np.float32)
    got = masked.masked_quantile(t(scores), t(member), q, t(fallback))
    for c in range(4):
        want = jmasked.masked_quantile(jnp.asarray(scores[c]), jnp.asarray(member[c]),
                                       jnp.asarray(q, jnp.float32), jnp.asarray(fallback[c]))
        np.testing.assert_allclose(float(got[c]), float(want), **TOL)
        if member[c].any():
            ref = torch.quantile(t(scores[c][member[c]]), q)
            np.testing.assert_allclose(float(got[c]), float(ref), **TOL)
    assert float(got[0]) == pytest.approx(0.11)


def test_masked_softmax_stats_matches_jax(rng):
    probs = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    valid = np.array([True, False, True, True, False, True])
    want = jmasked.masked_softmax_stats(jnp.asarray(probs), jnp.asarray(valid))
    got = masked.masked_softmax_stats(t(probs), t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mmd_terms_and_gradients_match_jax(rng):
    x = rng.normal(size=(10, 6)).astype(np.float32)
    w_s = np.where(np.arange(10) < 4, rng.random(10), 0).astype(np.float32)
    w_t = np.where(np.arange(10) >= 5, rng.random(10), 0).astype(np.float32)
    member = (w_s > 0) | (w_t > 0)

    def jax_mmd(x):
        ss, tt, st = jmmd.weighted_mmd_terms(jmmd.pairwise_sq_dists(x), jnp.asarray(w_s),
                                             jnp.asarray(w_t), jnp.asarray(member))
        return ss + tt - 2 * st

    xt = t(x).requires_grad_(True)
    l2 = mmd.pairwise_sq_dists(xt)
    np.testing.assert_allclose(l2.detach().numpy(), np.asarray(jmmd.pairwise_sq_dists(x)),
                               atol=2e-5, rtol=1e-5)
    ss, tt, st = mmd.weighted_mmd_terms(l2, t(w_s), t(w_t), t(member))
    got = ss + tt - 2 * st
    np.testing.assert_allclose(float(got.detach()), float(jax_mmd(jnp.asarray(x))), **TOL)
    got.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(jax_mmd)(jnp.asarray(x))),
                               **GRAD_TOL)


@pytest.mark.parametrize("with_mask", [True, False])
def test_augment_matches_jax_with_its_draws(rng, with_mask):
    jcfg = JaxAugmentConfig(temporal_mask_ratio=0.25)
    cfg = port_cfg(jcfg)
    x = rng.normal(size=(5, 12, 8)).astype(np.float32)
    pm = np.arange(12)[None, :] >= np.array([12, 9, 4, 0, 11])[:, None] if with_mask else None
    key = jax.random.PRNGKey(4)
    want_w = jaug.weak_augment(key, jnp.asarray(x), jcfg)
    got_w = augment.weak_augment(None, t(x), cfg, noise=jax_normal(key, x.shape))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)

    want = jaug.strong_augment(key, jnp.asarray(x), jcfg,
                               padding_mask=None if pm is None else jnp.asarray(pm))
    draws = jax_strong_draws(key, x.shape, pm, jcfg)
    got = augment.strong_augment(None, t(x), cfg, None if pm is None else t(pm), draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got == 0).all(-1).any()  # a temporal mask was applied

    # the port's own draws: the same shapes, a start inside [0, hi)
    g = torch.Generator().manual_seed(0)
    own = augment.draw_strong(g, t(x), cfg, None if pm is None else t(pm))
    hi = augment.start_upper_bound(t(x), cfg, None if pm is None else t(pm))
    assert own.noise.shape == x.shape and own.feat_u.shape == (8,)
    assert bool((own.start >= 0).all() and (own.start < hi).all())


def _probs(rng, B, sharp):
    logits = rng.normal(size=(B, 4)) * sharp
    return (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("use_entropy", [True, False])
def test_dacp_over_batches_and_epoch_end_match_jax(rng, use_entropy):
    jcfg = JaxDACPConfig(use_entropy_in_score=use_entropy)
    cfg = port_cfg(jcfg)
    jstate, state = jdacp.init_dacp(4), dacp.init_dacp(4)
    anchors = np.array([0.0, 0.2, 0.0, 0.05], np.float32)
    for step in range(5):
        probs = _probs(rng, 10, sharp=1 + step)
        valid = rng.random(10) < 0.8
        gamma = 0.4 + 0.1 * step
        jstate, jm, js, jw = jdacp.dacp_mask(jstate, jnp.asarray(probs), jnp.asarray(valid),
                                             jnp.asarray(gamma, jnp.float32),
                                             jnp.asarray(anchors), jcfg)
        state, m, s, w = dacp.dacp_mask(state, t(probs), t(valid), gamma, t(anchors), cfg)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        if step == 2:
            jstate, state = jdacp.dacp_epoch_update(jstate, jcfg), dacp.dacp_epoch_update(state, cfg)
        for f in dacp.DACPState._fields:
            np.testing.assert_allclose(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)),
                                       **TOL, err_msg=f)
    want = jdacp.fixed_threshold_mask(jnp.asarray(probs), jnp.asarray(valid), 0.5)
    got = dacp.fixed_threshold_mask(t(probs), t(valid), 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("class_aware", [True, False])
def test_ecda_and_its_gradients_match_jax(rng, class_aware):
    jcfg = JaxECDAConfig(use_class_aware_mmd=class_aware)
    cfg = port_cfg(jcfg)
    Bs, Bt, D = 12, 10, 6
    clean = rng.normal(size=(Bs, D)).astype(np.float32)
    noisy = rng.normal(size=(Bt, D)).astype(np.float32)
    labels = rng.integers(0, 4, Bs).astype(np.int32)
    labels[-1] = -1  # an unlabeled clean row
    pseudo = np.array([0, 0, 1, 1, 1, 2, 2, 3, 0, 1], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 0], bool)
    scores = rng.random(Bt).astype(np.float32)
    weights = rng.random(4).astype(np.float32)
    clean_valid = np.ones(Bs, bool)
    clean_valid[-2] = False
    noisy_valid = np.ones(Bt, bool)
    noisy_valid[3] = False

    def jax_loss(c, n):
        return jecda.ecda_loss(c, n, jnp.asarray(labels), jnp.asarray(pseudo), jnp.asarray(mask),
                               jnp.asarray(scores), jnp.asarray(weights),
                               jnp.asarray(clean_valid), jnp.asarray(noisy_valid), jcfg)

    c, n = t(clean).requires_grad_(True), t(noisy).requires_grad_(True)
    got = ecda.ecda_loss(c, n, t(labels), t(pseudo), t(mask), t(scores), t(weights),
                         t(clean_valid), t(noisy_valid), cfg)
    want = jax_loss(jnp.asarray(clean), jnp.asarray(noisy))
    assert float(want) != 0.0  # the gates let classes through
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    gc, gn = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(clean), jnp.asarray(noisy))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), **GRAD_TOL)
    np.testing.assert_allclose(n.grad.numpy(), np.asarray(gn), **GRAD_TOL)
