"""The whole d2v update, port against JAX: 15 steps of
``make_d2v_train_step`` from one state carried over from JAX
(``flax_d2v_state_to_torch``), each step fed the JAX step's draws
(dropout off; tests/test_torch_d2v_model.py holds dropout itself), with
the EMA and Adam's first moment stored in bf16 and an EMA of every
encoder module; then the optimizer alone against optax. The f32 run (15
updates with clone_batch 2, mask noise and channel masking) is
``tests/test_torch_d2v_run.py``'s, through ``run_d2v_pretrain``.

Tolerances: losses and metrics at every step METRIC_TOL; parameters, EMA
blocks and Adam's moments at the end STATE_TOL. Carve-outs, each for a
stated reason:
- the key-projection slice of every ``attn.qkv.bias`` has no gradient
  (softmax ignores a per-query constant), so Adam normalises rounding
  noise there into steps of about lr: held to 2 lr a step;
- leaves stored in bfloat16 are rounded from f32 values that may differ in
  their last f32 bits between the frameworks, so a rounding can flip by one
  bf16 ulp (2^-8 relative). In the EMA that stays at the ulp (held to
  rtol 2^-7). A flipped first moment moves that element's Adam step, and
  15 updates compound it (on this CPU: losses 2.2e-4 relative, weights
  6.6e-5): the bf16 run holds its first two steps at METRIC_TOL and the
  rest at BF16_TRAJ_TOL, over 3x those; ``test_optimizer_update_matches_optax``
  holds the optimizer alone, bf16 moment included, at STATE_TOL on the
  same inputs."""

import jax
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    d2v_pretrain as jd2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_pretrain as td2v,
)

from torch_parity import (  # one_torch_thread: an autouse fixture
    METRIC_TOL,
    STATE_TOL,
    assert_params_close,
    d2v_cfgs,
    d2v_state_to_torch,
    jax_d2v_draws,
    one_torch_thread,
)

STEPS = 15
BF16_TOL = dict(atol=STATE_TOL["atol"], rtol=2.0**-7)
BF16_TRAJ_TOL = dict(atol=2.5e-4, rtol=2e-3)
CASES = {
    # bf16 storage of the EMA and Adam's first moment, an EMA of every
    # encoder module
    "bfloat16": dict(clone_batch=2, ema_dtype="bfloat16", adam_mu_dtype="bfloat16",
                     ema_encoder_only=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_whole_update_matches_jax(rng, case):
    jcfg, jp, tcfg, tp = d2v_cfgs(warmup_steps=3, max_steps=STEPS, learning_rate=1e-3,
                                  ema_decay=0.99, ema_end_decay=0.999, ema_anneal_end_step=10,
                                  **CASES[case])
    model, tx, state = jd2v.init_d2v_state(jcfg, jp, jax.random.PRNGKey(0), example_len=640)
    tmodel, ttx, _ = td2v.init_d2v_state(tcfg, tp)
    tstate = d2v_state_to_torch(state)
    step = jd2v.make_d2v_train_step(model, tx)
    tstep = td2v.make_d2v_train_step(tmodel, ttx)
    wav = (rng.normal(size=(2, 640)) * 0.3).astype(np.float32)
    pad = np.zeros((2, 640), bool)
    pad[1, 480:] = True
    t = td2v.conv_frames(640, tcfg.conv_feature_layers)
    losses = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(100 + i)
        draws = jax_d2v_draws(key, jp, 2 * jp.clone_batch, t, tcfg.embed_dim)
        tstate, got = tstep(tstate, torch.from_numpy(wav), torch.from_numpy(pad), None, draws)
        state, want = step(state, wav, pad, key)
        tol = BF16_TRAJ_TOL if case == "bfloat16" and i >= 2 else METRIC_TOL
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), **tol, err_msg=f"step {i} {k}")
        losses.append(float(got["loss"]))
    ref = d2v_state_to_torch(state)
    assert int(tstate.step) == int(ref.step) == STEPS
    assert int(tstate.opt_state.count) == int(ref.opt_state.count) == STEPS
    lr_bound = 2 * jp.learning_rate * STEPS
    tol = BF16_TRAJ_TOL if case == "bfloat16" else STATE_TOL
    assert_params_close(tstate.params, ref.params, tcfg.embed_dim, tol=tol,
                        key_bias_atol=lr_bound)
    assert_params_close(tstate.ema_blocks, ref.ema_blocks, tcfg.embed_dim, tol=tol,
                        key_bias_atol=lr_bound)
    for k, e in ref.ema_blocks.items():
        assert tstate.ema_blocks[k].dtype == e.dtype, k
    for k in ref.params:
        assert tstate.opt_state.mu[k].dtype == ref.opt_state.mu[k].dtype, k
        if case == "float32":
            torch.testing.assert_close(tstate.opt_state.mu[k], ref.opt_state.mu[k],
                                       **STATE_TOL, msg=k)
            torch.testing.assert_close(tstate.opt_state.nu[k], ref.opt_state.nu[k],
                                       **STATE_TOL, msg=k)
    assert np.std(losses) > 1e-3  # the update is live


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_optimizer_update_matches_optax(rng, mu_dtype):
    """The functional AdamW against optax's chain on the same grads, state
    and params for 4 updates (the state re-synced from optax before each):
    clipping on and off, warmup and decay, the bf16 first moment."""
    import jax.numpy as jnp

    _jc, jp, _tc, tp = d2v_cfgs(warmup_steps=2, max_steps=6, learning_rate=1e-2,
                                grad_clip=1.5, adam_mu_dtype=mu_dtype)
    shapes = {"a.weight": (5, 3), "b.bias": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtx = jd2v.build_d2v_optimizer(jp)
    ttx = td2v.build_d2v_optimizer(tp)
    jstate = jtx.init(params)
    for i in range(4):
        grads = {k: (rng.normal(size=s) * (0.1 if i % 2 else 2.0)).astype(np.float32)
                 for k, s in shapes.items()}
        adam = jstate[1][0]
        tstate = td2v.D2vAdamState(
            count=torch.tensor(int(adam.count), dtype=torch.int32),
            mu={k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
                torch.bfloat16 if mu_dtype else torch.float32) for k, v in adam.mu.items()},
            nu={k: torch.from_numpy(np.array(v)) for k, v in adam.nu.items()})
        want, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                  {k: jnp.asarray(v) for k, v in params.items()})
        got, tnew = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
                               {k: torch.from_numpy(v) for k, v in params.items()})
        for k in shapes:
            torch.testing.assert_close(got[k], torch.from_numpy(np.array(want[k])), **STATE_TOL)
            torch.testing.assert_close(
                tnew.mu[k].float(),
                torch.from_numpy(np.array(jstate[1][0].mu[k].astype(jnp.float32))), **STATE_TOL)
            assert tnew.mu[k].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        params = {k: v + np.array(want[k]) for k, v in params.items()}
