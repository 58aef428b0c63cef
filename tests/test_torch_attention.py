"""The port's attention (ops/attention.py, AltAttention, AltBlock) against
the JAX package's, on the same numpy inputs. The JAX side runs the Pallas
kernel in interpret mode on the CPU; the port's side runs the kernel's
plain version, as its wrapper does for CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.layers import (
    AltAttention as JaxAltAttention,
    AltBlock as JaxAltBlock,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.ops.attention import (
    flash_attention as jax_flash_attention,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    AltAttention,
    AltBlock,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops import (
    attention,
)

from torch_parity import to_torch


def _inputs(rng, B, H, N, D, lengths):
    q = rng.normal(size=(B, H, N, D)).astype(np.float32) * D**-0.5
    k = rng.normal(size=(B, H, N, D)).astype(np.float32)
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    mask = np.arange(N)[None, :] >= np.asarray(lengths)[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("N, lengths", [
    (40, [25, 40, 0]),    # suffix pad, unpadded, fully padded item
    (32, [32, 32, 32]),   # block multiple, no padding
    (130, [130, 7, 64]),  # past one 128-row block
])
def test_flash_attention_matches_pallas_f32(rng, N, lengths):
    q, k, v, mask = _inputs(rng, 3, 2, N, 64, lengths)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    before = attention.flash_attention.launches
    got = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask)).numpy()
    assert attention.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == np.float32 and got.shape == q.shape
    assert np.isfinite(got).all()
    # items with a valid key: every query row, f32 tolerance of the JAX
    # package's own kernel test (summation order only)
    valid = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5)


def test_flash_attention_no_mask_matches_pallas(rng):
    q, k, v, _ = _inputs(rng, 2, 3, 24, 16, [24, 24])
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_flash_attention_matches_pallas_bf16(rng):
    q, k, v, mask = _inputs(rng, 2, 2, 48, 64, [48, 30])
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, jnp.asarray(mask)), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = attention.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    # both round p to bf16 after the f32 softmax and the output to bf16:
    # differences come from exp/sum order flipping a rounding (1-2 ulps)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=1.6e-2)


@pytest.mark.parametrize("use_flash", [True, False, "auto"])
def test_altattention_matches_jax(rng, use_flash):
    B, N, C, H = 2, 20, 128, 2  # head dim 64, as the kernel takes
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[1, 12:] = True
    jmod = JaxAltAttention(dim=C, num_heads=H, dtype=jnp.float32, use_flash=use_flash)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    tmod = AltAttention(C, H, torch.float32, use_flash=use_flash)
    tmod.load_state_dict(to_torch(params))
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype, tol", [
    (jnp.float32, dict(atol=3e-5, rtol=1e-4)),
    # bf16 activations through two post-LN norms: a few bf16 ulps of O(1)
    (jnp.bfloat16, dict(atol=6e-2, rtol=2e-2)),
])
def test_altblock_matches_jax(rng, dtype, tol):
    B, N, C, H = 2, 33, 128, 2
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0, 20:] = True
    jmod = JaxAltBlock(dim=C, num_heads=H, dtype=dtype, use_flash=True)
    xin = jnp.asarray(x, dtype)
    params = jmod.init(jax.random.PRNGKey(1), xin, jnp.asarray(mask))
    want = np.asarray(jmod.apply(params, xin, jnp.asarray(mask)), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tmod = AltBlock(C, H, dtype=tdt, use_flash=True)
    tmod.load_state_dict(to_torch(params))
    got = tmod(torch.from_numpy(x).to(tdt), torch.from_numpy(mask)).float().detach().numpy()
    valid = ~mask
    np.testing.assert_allclose(got[valid], want[valid], **tol)
