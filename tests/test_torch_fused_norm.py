"""The port's fused LayerNorm (its plain version, which the CPU runs)
against the JAX package's Pallas kernel in interpret mode, forward and
backward (``jax.grad`` through the custom VJP), as tests/test_fused_norm.py
runs the JAX side.

Tolerance: f32 forward atol 2e-5 / rtol 2e-5 (tests/test_fused_norm.py's,
the two reductions sum in another order); bf16 one rounding of outputs up
to ~4 (atol 3e-2); gradients atol 3e-4 / rtol 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.ops.fused_norm import (
    fused_layernorm as jax_fused_layernorm,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.ops.fused_norm import (
    copy_rows,
    fused_layernorm,
)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-4, rtol=3e-4)


def _inputs(rng, shape, with_res, with_aff):
    C = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    scale = rng.normal(size=C).astype(np.float32) if with_aff else None
    bias = rng.normal(size=C).astype(np.float32) if with_aff else None
    return x, res, scale, bias


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("with_aff", [False, True])
@pytest.mark.parametrize("act", [None, "gelu_tanh"])
def test_forward_matches_pallas_interpret(rng, with_res, with_aff, act):
    x, res, scale, bias = _inputs(rng, (3, 41, 256), with_res, with_aff)  # ragged rows
    want = jax_fused_layernorm(_j(x), _j(scale), _j(bias), residual=_j(res), activation=act,
                               block_rows=32)
    got = fused_layernorm(_t(x), _t(scale), _t(bias), residual=_t(res), activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_bf16_forward_keeps_dtype_and_matches(rng):
    x, res, scale, bias = _inputs(rng, (2, 32, 768), True, True)
    want = jax_fused_layernorm(_j(x, jnp.bfloat16), _j(scale), _j(bias),
                               residual=_j(res, jnp.bfloat16), block_rows=32)
    got = fused_layernorm(_t(x, torch.bfloat16), _t(scale), _t(bias),
                          residual=_t(res, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("act", [None, "gelu_tanh"])
def test_backward_matches_jax_custom_vjp(rng, with_res, act):
    x, res, scale, bias = _inputs(rng, (2, 24, 128), with_res, True)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jax_loss(x, res, scale, bias):
        out = jax_fused_layernorm(x, scale, bias, residual=res, activation=act, block_rows=16)
        return jnp.sum(out * g)

    argnums = (0, 1, 2, 3) if with_res else (0, 2, 3)
    want = jax.grad(jax_loss, argnums=argnums)(_j(x), _j(res), _j(scale), _j(bias))
    leaves = [None if a is None else _t(a).requires_grad_(True) for a in (x, res, scale, bias)]
    out = fused_layernorm(leaves[0], leaves[2], leaves[3], residual=leaves[1], activation=act)
    (out * torch.from_numpy(g)).sum().backward()
    got = [leaves[i].grad for i in argnums]
    for gg, ww in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), **GRAD_TOL)


def test_copy_rows_plain_version_is_a_copy(rng):
    x = torch.from_numpy(rng.normal(size=(7, 512)).astype(np.float32)).to(torch.bfloat16)
    out = copy_rows(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
