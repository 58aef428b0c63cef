"""The port's d2v step on the card (``cuda`` marker; they skip without a
GPU): card against CPU from one state and the same draws, ``--remat``
against none with dropout on, the resident crop gather, and the attention
kernel taken by an evaluation step but refused by a training step.

This file imports neither JAX nor the JAX package, so the card tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_d2v_cuda.py
"""

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    D2vDecoderConfig,
    D2vPretrainConfig,
    EncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_pretrain as td2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.d2v_masking import (
    span_mask_counts,
    span_mask_uniforms,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    attention,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    resident as tres,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train.d2v_pretrain import (
    to_device,
)

# 64-d, 4 heads of 16 (the kernel takes head_dim 64 only; these steps run
# plain attention unless a case says otherwise)
ENC = dict(embed_dim=64, depth=2, num_heads=4, prenet_depth=1,
           conv_feature_layers=((32, 10, 5), (32, 3, 2)), conv_pos_depth=2, conv_pos_width=10,
           conv_pos_groups=4, dtype="float32", encoder_dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0, post_mlp_drop=0.0)
DEC = D2vDecoderConfig(decoder_dim=32, decoder_groups=4, decoder_kernel=5, decoder_layers=2,
                       input_dropout=0.0)
# card vs CPU in f32 with TF32 off: summation order only (the trainers'
# card-vs-CPU criterion)
CARD_CPU_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture
def cuda_device():
    """Skips unless a CUDA device is present, decided at run time so that
    every pytest-xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest --noconftest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfgs(enc=None, **pcfg):
    return (EncoderConfig(**{**ENC, **(enc or {})}),
            D2vPretrainConfig(**dict(dict(clone_batch=2, average_top_k_layers=2, batch_size=2,
                                          crop_size=4000, max_steps=4, warmup_steps=1,
                                          decoder=DEC), **pcfg)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy(rng.normal(size=(2, 4000)).astype(np.float32))
    pad = torch.zeros(2, 4000, dtype=torch.bool)
    pad[1, 3000:] = True
    return wav, pad


@pytest.mark.cuda
def test_d2v_steps_card_match_cpu(cuda_device):
    cfg, pcfg = _cfgs()
    model_c, tx_c, state_c = td2v.init_d2v_state(cfg, pcfg, torch.Generator().manual_seed(0))
    model_g, tx_g, _ = td2v.init_d2v_state(cfg, pcfg, None, cuda_device)
    state_g = to_device(state_c, cuda_device)
    step_c, step_g = td2v.make_d2v_train_step(model_c, tx_c), td2v.make_d2v_train_step(model_g, tx_g)
    wav, pad = _batch()
    frames = td2v.conv_frames(pcfg.crop_size, cfg.conv_feature_layers)
    n_masked = span_mask_counts(frames, pcfg.mask_prob, pcfg.mask_length)[1]
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        draws = td2v.D2vDraws(mask=span_mask_uniforms(4, frames, pcfg.mask_length, gen),
                              dtok=torch.randn((4, n_masked, cfg.embed_dim), generator=gen))
        state_c, m_c = step_c(state_c, wav, pad, None, draws)
        state_g, m_g = step_g(state_g, wav.to(cuda_device), pad.to(cuda_device), None,
                              to_device(draws, cuda_device))
        for k in m_c:
            torch.testing.assert_close(m_g[k].cpu(), m_c[k], **CARD_CPU_TOL)
    e = cfg.embed_dim
    for k, want in state_c.params.items():
        got = state_g.params[k].cpu()
        if k.endswith("attn.qkv.bias"):  # the key slice: no gradient, Adam's noise steps
            assert (got - want)[e:2 * e].abs().max() <= 2 * pcfg.learning_rate * 3
            got, want = torch.cat([got[:e], got[2 * e:]]), torch.cat([want[:e], want[2 * e:]])
        torch.testing.assert_close(got, want, **CARD_CPU_TOL, msg=k)


@pytest.mark.cuda
def test_remat_on_the_card_equals_no_remat(cuda_device):
    drop = dict(encoder_dropout=0.1, attention_dropout=0.1, post_mlp_drop=0.1, dtype="bfloat16")
    wav, pad = (t.to(cuda_device) for t in _batch())
    ends = []
    for remat in (False, True):
        cfg, pcfg = _cfgs(drop, remat_blocks=remat)
        model, tx, state = td2v.init_d2v_state(
            cfg, pcfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
        state, m = td2v.make_d2v_train_step(model, tx)(
            state, wav, pad, torch.Generator(cuda_device).manual_seed(1))
        ends.append((state, m))
    (a, ma), (b, mb) = ends
    assert float(ma["loss"]) == float(mb["loss"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.cuda
def test_resident_crop_gather_on_the_card(cuda_device):
    rng = np.random.default_rng(0)
    sizes = np.array([5000, 3000, 8000], np.int64)
    flat = rng.normal(size=int(sizes.sum())).astype(np.float32)
    host = tres.resident_from_flat(flat, sizes, "cpu")
    card = tres.resident_from_flat(flat, sizes, cuda_device)
    idx = torch.tensor([0, 2, 1, -1], dtype=torch.int32)
    starts = torch.tensor([512, 3968, 0, 0], dtype=torch.int32)
    want = tres.gather_clips(host, idx, 4000, starts=starts)
    got = tres.gather_clips(card, idx.to(cuda_device), 4000, starts=starts.to(cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_eval_step_takes_the_kernel_and_the_train_step_refuses_it(cuda_device):
    """head_dim 64 (the kernel's): evaluation through the kernel agrees with
    plain attention; the training step refuses the config up front."""
    enc = dict(embed_dim=128, num_heads=2, conv_pos_groups=4, dtype="bfloat16")
    wav, pad = (t.to(cuda_device) for t in _batch())
    cfg, pcfg = _cfgs(dict(enc, use_flash_attention=True))
    model, tx, state = td2v.init_d2v_state(
        cfg, pcfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    with pytest.raises(ValueError, match="forward-only"):
        td2v.make_d2v_train_step(model, tx)
    before = attention.flash_attention.launches
    m_k = td2v.make_d2v_eval_step(model)(state.params, state.ema_blocks, wav, pad,
                                         torch.Generator(cuda_device).manual_seed(1))
    assert attention.flash_attention.launches > before
    plain_cfg, _ = _cfgs(dict(enc, use_flash_attention=False))
    plain = td2v.D2vPretrainModel(plain_cfg, pcfg).to("meta")
    m_p = td2v.make_d2v_eval_step(plain)(state.params, state.ema_blocks, wav, pad,
                                         torch.Generator(cuda_device).manual_seed(1))
    # bf16: the kernel keeps f32 scores, plain attention rounds them
    torch.testing.assert_close(m_k["loss"].float(), m_p["loss"].float(), atol=0.0, rtol=2e-2)
