"""The port's fused conv + LN + GELU (its plain version, which the CPU
runs) against the JAX package's Pallas kernel in interpret mode, as
tests/test_pallas_conv.py runs it, and the whole front end (layer 0 plus
``pallas_conv_stack``) against the JAX ``ConvFeatureExtractor`` and the
port's own.

Tolerance: f32 atol 3e-6 (tests/test_pallas_conv.py's) for the whole
stack, 2e-6 / rtol 1e-5 per layer; the polynomial erf within 5e-7 of
scipy's erf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.layers import (
    ConvFeatureExtractor as JaxConvFeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.ops.conv import (
    fused_conv_ln_gelu as jax_fused_conv_ln_gelu,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_encoder_to_torch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    ConvFeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops.conv import (
    conv_layer_params,
    erf_poly,
    fused_conv_ln_gelu,
    pallas_conv_stack,
)

SPEC = ((8, 10, 5), (8, 3, 2), (8, 2, 2))


def test_polynomial_erf_accuracy():
    x = torch.linspace(-4, 4, 1001, dtype=torch.float64)
    np.testing.assert_allclose(erf_poly(x).numpy(), sp.erf(x.numpy()), atol=5e-7)


@pytest.mark.parametrize("k, s, approx", [(3, 2, False), (2, 2, True), (10, 5, False),
                                          (3, 1, True)])
def test_layer_matches_pallas_interpret(rng, k, s, approx):
    c_in = 1 if k == 10 else 8
    x = rng.normal(size=(2, 97, c_in)).astype(np.float32)
    w = (rng.normal(size=(k, c_in, 8)) * 0.3).astype(np.float32)
    scale = (rng.normal(size=8) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=8) * 0.1).astype(np.float32)
    want = jax_fused_conv_ln_gelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                  jnp.asarray(bias), k, s, tile=16, interpret=True,
                                  approx_gelu=approx)
    got = fused_conv_ln_gelu(*(torch.from_numpy(a) for a in (x, w, scale, bias)), k, s,
                             approx_gelu=approx)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


def test_stack_matches_jax_extractor_and_the_ports(rng):
    wav = (rng.normal(size=(3, 413)) * 0.3).astype(np.float32)
    jce = JaxConvFeatureExtractor(conv_layers=SPEC, dtype=jnp.float32)
    params = jce.init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    want = np.asarray(jce.apply({"params": params}, jnp.asarray(wav)))

    sd = flax_encoder_to_torch(jax.tree.map(np.asarray, params))
    ce = ConvFeatureExtractor(SPEC)
    ce.load_state_dict(sd)
    w0, scale0, bias0 = conv_layer_params(sd, 0, torch.float32)
    x0 = fused_conv_ln_gelu(torch.from_numpy(wav)[:, :, None], w0, scale0, bias0, 10, 5)
    got = pallas_conv_stack(x0, sd, SPEC)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-6)
    with torch.no_grad():
        module = ce(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=3e-6)
