"""The port's heads and SSRL helpers against the JAX package's:
``PretrainHead`` forward, ``ema_update``, ``load_pretrain_into_ssrl``, the
``init_ssrl`` distribution, and training-mode dropout in ``DADHead``.

Tolerance: f32 on the CPU, atol 1e-6 for the forward and the EMA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import (
    PretrainHead as JaxPretrainHead,
    ema_update as jax_ema_update,
    init_ssrl as jax_init_ssrl,
    load_pretrain_into_ssrl as jax_load_pretrain,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    PretrainHead,
    SSRLState,
    ema_update,
    init_ssrl,
    load_pretrain_into_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_encoder_to_torch,
)

TOL = dict(atol=1e-6, rtol=1e-6)


def _ssrl(jstate):
    return SSRLState(flax_encoder_to_torch(jstate.student), flax_encoder_to_torch(jstate.teacher))


def test_pretrain_head_forward_and_loading_match_jax(rng):
    feats = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = np.arange(7)[None, :] >= np.array([7, 3, 0])[:, None]
    jhead = JaxPretrainHead(16, 8, 4)
    jparams = jhead.init(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(mask))
    head = PretrainHead(16, 8, 4)
    head.load_state_dict(flax_encoder_to_torch(jparams))
    want = jhead.apply(jparams, jnp.asarray(feats), jnp.asarray(mask))
    got = head(torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    _h, jssrl = jax_init_ssrl(jax.random.PRNGKey(2), 16, 8, 4)
    want = jax_load_pretrain(jssrl, jparams)
    got = load_pretrain_into_ssrl(_ssrl(jssrl), head.state_dict())
    for role in ("student", "teacher"):
        for k, v in flax_encoder_to_torch(getattr(want, role)).items():
            assert torch.equal(getattr(got, role)[k], v), (role, k)
    assert got.teacher["encoder.pre_net.weight"] is not got.student["encoder.pre_net.weight"]


def test_ema_update_matches_jax():
    _h, jssrl = jax_init_ssrl(jax.random.PRNGKey(3), 16, 8, 4)
    _h, other = jax_init_ssrl(jax.random.PRNGKey(4), 16, 8, 4)
    jssrl = jssrl._replace(student=other.student)  # teacher != student
    want = jax_ema_update(jssrl, 0.995)
    got = ema_update(_ssrl(jssrl), 0.995)
    for k, v in flax_encoder_to_torch(want.teacher).items():
        torch.testing.assert_close(got.teacher[k], v, **TOL)


def test_init_ssrl_draws_torch_linear_init_with_teacher_equal_student():
    head, ssrl = init_ssrl(torch.Generator().manual_seed(0), 768, 256, 4)
    again = init_ssrl(torch.Generator().manual_seed(0), 768, 256, 4)[1]
    _h, jssrl = jax_init_ssrl(jax.random.PRNGKey(0), 768, 256, 4)
    jstudent = flax_encoder_to_torch(jssrl.student)
    assert ssrl.student.keys() == jstudent.keys() == head.state_dict().keys()
    for k, v in ssrl.student.items():
        assert v.shape == jstudent[k].shape
        bound = 1 / np.sqrt(768 if k.startswith("encoder.") else 256)
        assert float(v.abs().max()) <= bound
        if v.numel() > 1000:  # U(-b, b) has std b / sqrt(3), as the JAX draw
            np.testing.assert_allclose(float(v.std()), bound / np.sqrt(3), rtol=0.02)
            np.testing.assert_allclose(float(jstudent[k].std()), bound / np.sqrt(3), rtol=0.02)
        assert torch.equal(ssrl.teacher[k], v) and ssrl.teacher[k] is not v
        assert torch.equal(again.student[k], v)  # seeded


def test_dad_head_dropout_only_in_training_mode():
    head, ssrl = init_ssrl(torch.Generator().manual_seed(1), 16, 64, 4, dropout_rate=0.5)
    feats = torch.randn(5, 6, 16, generator=torch.Generator().manual_seed(2))
    mask = torch.zeros(5, 6, dtype=torch.bool)
    eval_logits, emb = head(feats, mask)
    assert torch.equal(head(feats, mask)[0], eval_logits)
    g = torch.Generator().manual_seed(3)
    train_logits, train_emb = head(feats, mask, deterministic=False, generator=g)
    assert torch.equal(train_emb, emb)  # dropout sits after the pooled embedding
    assert not torch.allclose(train_logits, eval_logits)
    again = head(feats, mask, deterministic=False, generator=torch.Generator().manual_seed(3))[0]
    assert torch.equal(again, train_logits)
