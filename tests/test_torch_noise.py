"""The port's noise injection against the JAX package's, on the same
waveforms with the JAX functions' own random draws (noise, bank types and
offsets) handed to the port; plus the SNR and peak-normalisation rules on
their own.

Tolerance: f32 on the CPU, the same operations in the same order: atol
1e-6 / rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio import (
    noise as jnoise,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio import (
    noise,
)

from torch_parity import jax_normal

TOL = dict(atol=1e-6, rtol=1e-5)
LENGTHS = (400, 310, 0, 255)  # one row fully padded


def _batch(rng, T=400, amp=0.1):
    wav = np.zeros((len(LENGTHS), T), np.float32)
    valid = np.zeros((len(LENGTHS), T), bool)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = rng.normal(size=n) * amp
        valid[i, :n] = True
    return wav, valid


def _bank(rng, K=3, Tn=150):
    return (rng.normal(size=(K, Tn)) * np.array([[0.5], [1.0], [0.0]])[:K]).astype(np.float32)


def test_single_clip_white_and_real_noise_match_jax(rng):
    audio = (rng.normal(size=500) * 0.8).astype(np.float32)  # loud: peak-normalised
    key = jax.random.PRNGKey(1)
    want = jnoise.add_white_noise(jnp.asarray(audio), 5.0, key)
    got = noise.add_white_noise(torch.from_numpy(audio), 5.0, noise=jax_normal(key, audio.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    clip = rng.normal(size=170).astype(np.float32)
    tiled = noise.tile_noise(torch.from_numpy(clip), 500, 37)
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(jnoise.tile_noise(jnp.asarray(clip), 500, 37)))
    for n in (tiled, torch.zeros(500)):  # silent noise keeps scale 1
        want = jnoise.add_real_noise(jnp.asarray(audio), jnp.asarray(n.numpy()), 10.0)
        got = noise.add_real_noise(torch.from_numpy(audio), n, 10.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("snr", [10.0, np.array([0.0, 5.0, 10.0, 20.0], np.float32)])
@pytest.mark.parametrize("amp", [0.1, 3.0])
def test_batch_white_noise_matches_jax(rng, snr, amp):
    wav, valid = _batch(rng, amp=amp)
    key = jax.random.PRNGKey(2)
    want = jnoise.batch_add_white_noise(jnp.asarray(wav), jnp.asarray(valid), jnp.asarray(snr), key)
    got = noise.batch_add_white_noise(torch.from_numpy(wav), torch.from_numpy(valid),
                                      torch.as_tensor(snr), noise=jax_normal(key, wav.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("per_sample", [False, True])
def test_bank_mixing_matches_jax(rng, per_sample):
    wav, valid = _batch(rng)
    bank = _bank(rng)
    key = jax.random.PRNGKey(3)
    want = jnoise.batch_mix_noise_bank(jnp.asarray(wav), jnp.asarray(valid), jnp.asarray(bank),
                                       jnp.asarray(5.0), key, noise_type=1,
                                       per_sample_type=per_sample)
    k_type, k_off = jax.random.split(key)
    B = wav.shape[0]
    types = (jax.random.randint(k_type, (B,), 0, bank.shape[0]) if per_sample
             else jnp.full((B,), 1, jnp.int32))
    offsets = jax.random.randint(k_off, (B,), 0, bank.shape[1])
    got = noise.batch_mix_noise_bank(
        torch.from_numpy(wav), torch.from_numpy(valid), torch.from_numpy(bank), 5.0,
        noise_type=1, per_sample_type=per_sample,
        types=torch.from_numpy(np.array(types)), offsets=torch.from_numpy(np.array(offsets)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _snr_db(clean, noisy, valid):
    n = (noisy - clean) * valid
    return 10 * torch.log10(((clean * valid) ** 2).sum(-1) / (n**2).sum(-1))


def test_bank_mixing_hits_the_snr_and_stays_in_padding(rng):
    wav, valid = _batch(rng)
    w, v = torch.from_numpy(wav), torch.from_numpy(valid)
    g = torch.Generator().manual_seed(0)
    out = noise.batch_mix_noise_bank(w, v, torch.from_numpy(_bank(rng)[:2]), 7.0, g,
                                     per_sample_type=True)
    rows = v.any(-1)
    torch.testing.assert_close(_snr_db(w, out, v)[rows], torch.full((3,), 7.0), atol=1e-3, rtol=0)
    assert torch.equal(out[~v], w[~v])  # padding untouched


def test_white_noise_snr_and_peak_normalisation(rng):
    wav, valid = _batch(rng, T=20000)
    w, v = torch.from_numpy(wav), torch.from_numpy(valid)
    g = torch.Generator().manual_seed(1)
    out = noise.batch_add_white_noise(w, v, 10.0, g)
    rows = v.any(-1)
    # the realised power of >= 255 gaussian draws is within ~1 dB of target
    snr = _snr_db(w, out, v)[rows]
    assert torch.all((snr - 10.0).abs() < 1.0), snr
    assert torch.equal(out[~v], w[~v])
    # a loud batch: every row with a sample beyond 1 is scaled to peak 1
    loud = noise.batch_add_white_noise(w * 30, v, 10.0, torch.Generator().manual_seed(1))
    torch.testing.assert_close(loud.abs().amax(-1)[rows], torch.ones(3))
    same = noise.batch_add_white_noise(w * 30, v, 10.0, torch.Generator().manual_seed(1))
    assert torch.equal(loud, same)  # the generator is the only source of draws
