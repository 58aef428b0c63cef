"""d2v pretraining over the port's (dp, tp) process grid, on the CPU: the
grids (2, 1), (1, 2), (2, 2) and dp 4 against one port process at the
global batch and against the JAX package's ``make_sharded_d2v_step`` on a
virtual-CPU mesh of the same shape (``tests/test_d2v_pretrain.py:401``,
``:436`` hold the JAX mesh to one device; they are ``slow`` there).

The ranks are gloo processes spawned by ``tests/torch_dist.py`` (one pool of
2 and one of 4); the JAX side runs in this process. Tiny config of
``tests/torch_parity.py`` in f32, global batch 4, clone_batch 2, mask noise
and channel masking, 3 steps.

Tolerances:
- grid vs one process, dropout on (the default rates of the blocks and the
  decoder input, drawn from the generator), ``remat_blocks`` on: losses
  and metrics rtol 1e-5 (summation order); the parameters, EMA blocks and
  both moments STATE_TOL, the key-projection biases within 2 lr a step
  (no gradient reaches them, so Adam turns rounding noise there into steps
  of about lr: ``torch_parity.key_bias_slices``); the metrics bit-equal
  on every rank (the collapse guards must decide alike);
- every leaf's gradient at (1, 2): STATE_TOL against one process (a
  missing all-reduce of the column-parallel input's gradient, or a
  row-parallel bias summed twice, is off by a factor); the encoder's
  training forward: features rtol 1e-5, gradients rtol 1e-4 with an atol
  of 1e-6 of the leaf's largest gradient (f32 sums over every token, whose
  cancellations leave an error of the terms' size, not the result's);
- grid fed the JAX draws (dropout off) vs the JAX mesh: the tolerances of
  ``tests/test_torch_d2v_update.py`` (METRIC_TOL, STATE_TOL, key biases
  2 lr a step). At (2, 2) the JAX mesh itself leaves its single-device
  step: it doubles the gradient of the decoder's first grouped conv
  (``decoder.conv_0.weight``; its first AdamW moment 1.86x the
  single-device one after one step, every other leaf's 0.93x through the
  clip; ROADMAP.md §3). Its own contract (JAX
  ``parallel/d2v_sharded.py:8-10``) is the single-device step at the
  global batch, so (2, 2) is held to that step instead, fed the same
  draws;
- the driver over (2, 2) (validation, a checkpoint, a crash and a resume
  mid-epoch) and ``cli d2v-pretrain --dp 2``: the history rtol 1e-5, the
  written state and exports as above.

``layerdrop`` is no knob of d2v pretraining (the JAX model runs its
blocks without it, and so does the port); the encoder's training forward
takes it, and runs it over tp with dropout and a backward below.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    d2v_pretrain as jd2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel import (
    make_mesh as jax_make_mesh,
    make_sharded_d2v_step as jax_sharded_step,
    place_d2v_state as jax_place,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    d2v_pretrain as td2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    Mesh,
    encoder_param_sharding,
    make_sharded_d2v_step,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    d2v_pretrain as ttrain,
)

import torch_dist
from test_torch_d2v_run import RUN, write_corpus
from torch_mirror import rand_sd
from torch_parity import (  # one_torch_thread: an autouse fixture
    D2V_ENC,
    METRIC_TOL,
    STATE_TOL,
    cfg_pair,
    d2v_cfgs,
    d2v_state_to_torch,
    jax_d2v_draws,
    one_torch_thread,
)

STEPS, B, CROP = 3, 4, 640
STEP_RTOL = dict(rtol=1e-5, atol=1e-6)
PCFG = dict(batch_size=B, crop_size=CROP, clone_batch=2, encoder_zero_mask=False,
            mask_noise_std=0.05, mask_channel_prob=0.2, mask_channel_length=4,
            warmup_steps=2, max_steps=10, learning_rate=1e-3, ema_decay=0.99,
            ema_end_decay=0.999, ema_anneal_end_step=10)
# the generator runs: every dropout at a nonzero rate, an EMA of every
# encoder module, the blocks recomputed in the backward
DROP_ENC = dict(encoder_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                post_mlp_drop=0.1, layerdrop=0.2, prenet_layerdrop=0.2)
DROP_PCFG = dict(PCFG, remat_blocks=True, ema_encoder_only=False)
GRIDS = {"21": (2, 1), "12": (1, 2), "22": (2, 2), "41": (4, 1)}
KEY_BIAS_BOUND = 2 * PCFG["learning_rate"] * STEPS


def _batch():
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(B, CROP)) * 0.3).astype(np.float32)
    pad = np.zeros((B, CROP), bool)
    pad[1, 480:] = True
    pad[3, 520:] = True
    return wav, pad


def _jax_mesh(grid):
    dp, tp = GRIDS[grid]
    if tp == 1:
        return jax_make_mesh(dp, tp=1, axis_names=("dp",))
    return jax_make_mesh(dp * tp, tp=tp)


def _close_states(got: dict, want: dict, what: str, tol=STATE_TOL):
    """Two ``torch_dist.numpy_d2v_state`` dicts: every leaf within ``tol``,
    the key-projection biases' key slices within KEY_BIAS_BOUND."""
    assert set(got) == set(want), what
    e = D2V_ENC["embed_dim"]
    for k, w in want.items():
        g = got[k]
        if k in ("step", "count"):
            assert g == w, (what, k)
            continue
        if k.endswith("attn.qkv.bias") and not k.startswith(("mu.", "nu.")):
            np.testing.assert_allclose(g[e:2 * e], w[e:2 * e], rtol=0, atol=KEY_BIAS_BOUND,
                                       err_msg=f"{what}: {k}")
            g, w = np.concatenate([g[:e], g[2 * e:]]), np.concatenate([w[:e], w[2 * e:]])
        np.testing.assert_allclose(g, w, err_msg=f"{what}: {k}", **tol)


def _close_metrics(got, want, what, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{what}: step {i + 1} {k}", **tol)


# ---------------------------------------------------------------------------
# inputs, the one-process and JAX runs, and the two launches of ranks


@pytest.fixture(scope="module")
def steps():
    """The generator runs (dropout on) and their one-process references:
    the 3-step run and the first step's gradients."""
    _jc, _jp, tcfg, tp = d2v_cfgs(enc=DROP_ENC, dec=dict(input_dropout=0.1), **DROP_PCFG)
    _m, _tx, state = td2v.init_d2v_state(tcfg, tp, torch.Generator().manual_seed(0))
    # nonzero biases from the first step on (a row-parallel bias added on
    # every tp rank shows in the first forward)
    gen = torch.Generator().manual_seed(9)
    params = {k: 0.1 * torch.randn(v.shape, generator=gen) if k.endswith(".bias") else v
              for k, v in state.params.items()}
    state = state._replace(params=params,
                           ema_blocks=td2v.init_ema_blocks(params, tcfg, tp))
    wav, pad = _batch()
    args = dict(cfg=tcfg, pcfg=tp, state=state, wav=wav, pad=pad, steps=STEPS, seed=5)
    return dict(args=args, single=torch_dist.d2v_steps(**args),
                grads=torch_dist.d2v_steps(**dict(args, steps=1), record_grads=True))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's sharded step on a virtual-CPU mesh of each grid's
    shape (at (2, 2) its single-device step: module docstring), 3 steps
    from one state, and the draws it took."""
    jcfg, jp, tcfg, tp = d2v_cfgs(**PCFG)
    model, tx, state = jd2v.init_d2v_state(jcfg, jp, jax.random.PRNGKey(0), example_len=CROP)
    init = jax.tree.map(np.array, state)
    wav, pad = _batch()
    t = td2v.conv_frames(CROP, tcfg.conv_feature_layers)
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    draws = [jax_d2v_draws(k, jp, B * jp.clone_batch, t, tcfg.embed_dim) for k in keys]
    out = {}
    for grid in GRIDS:
        if grid == "22":
            mesh, step = None, jd2v.make_d2v_train_step(model, tx)
            s = jax.tree.map(jnp.asarray, init)
        else:
            mesh = _jax_mesh(grid)
            step = jax_sharded_step(model, tx, mesh)
            with mesh:
                s = jax_place(jax.tree.map(jnp.asarray, init), mesh)
        metrics = []
        for k in keys:
            if mesh is None:
                s, m = step(s, wav, pad, k)
            else:
                with mesh:
                    s, m = step(s, wav, pad, k)
            metrics.append({kk: float(v) for kk, v in m.items()})
        out[grid] = (metrics, torch_dist.numpy_d2v_state(d2v_state_to_torch(s)))
    args = dict(cfg=tcfg, pcfg=tp, state=d2v_state_to_torch(init), wav=wav, pad=pad,
                steps=STEPS, draws=draws)
    return dict(args=args, jax=out)


@pytest.fixture(scope="module")
def enc_case():
    """The encoder's training forward with dropout and layerdrop: random
    fairseq weights (nonzero biases everywhere) and a batch."""
    jenc, tenc = cfg_pair(use_flash_attention=False)
    cfg = dataclasses.replace(tenc, **dict(DROP_ENC, layerdrop=0.5, prenet_layerdrop=0.5))
    state = fairseq_to_torch_encoder(rand_sd(jenc, seed=3), tenc)
    rng = np.random.default_rng(3)
    wav = (rng.normal(size=(3, 700)) * 0.3).astype(np.float32)
    pad = np.zeros((3, 700), bool)
    pad[2, 500:] = True
    x, _ = torch_dist.encoder_training_grads(cfg, state, wav, pad, np.ones((1,), np.float32),
                                             seed=11)
    weight = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    args = dict(cfg=cfg, state=state, wav=wav, pad=pad, weight=weight)
    single = [torch_dist.encoder_training_grads(**args, seed=s) for s in (11, 12)]
    return dict(args=args, single=single)


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    """``run_d2v_pretrain`` on one process (6 updates, validation every 2),
    and ``cli d2v-pretrain`` (3 updates): the written files."""
    base = tmp_path_factory.mktemp("d2v_grid")
    data = write_corpus(str(base / "corpus"))
    _jc, _jp, tcfg, tp = d2v_cfgs(enc=DROP_ENC, dec=dict(input_dropout=0.1),
                                  **dict(RUN, max_steps=6, remat_blocks=True))
    kw = dict(valid_manifests=[data], valid_every=2)
    one = str(base / "one")
    torch_dist.d2v_driver(tcfg, tp, data, one, **kw)
    enc_json = base / "enc.json"
    enc_json.write_text(json.dumps(D2V_ENC))
    argv = ["d2v-pretrain", "--manifests", data, "--save-dir", "out", "--encoder-json",
            str(enc_json), "--steps", "3", "--warmup-steps", "1", "--batch-size", "2",
            "--crop-size", "1500", "--clone-batch", "2", "--min-sample-size", "1000",
            "--log-every", "1", "--device", "cpu"]
    cwd = os.getcwd()
    os.makedirs(base / "cli_one")
    os.makedirs(base / "cli_dp2")
    try:
        torch_dist.d2v_cli_run(argv, str(base / "cli_one"))
    finally:
        os.chdir(cwd)
    return dict(cfg=tcfg, pcfg=tp, data=data, kw=kw, one=one, grid=str(base / "grid"),
                argv=argv, cli_one=str(base / "cli_one" / "out"),
                cli_dp2=str(base / "cli_dp2"))


@pytest.fixture(scope="module")
def two(steps, jax_runs, enc_case, driver):
    """Every 2-rank case in one launch of two gloo processes."""
    cases = []
    for grid in ("21", "12"):
        tp = GRIDS[grid][1]
        cases += [(f"steps_{grid}", tp, torch_dist.d2v_steps, steps["args"]),
                  (f"jax_{grid}", tp, torch_dist.d2v_steps, jax_runs["args"])]
    cases += [
        ("grads_12", 2, torch_dist.d2v_steps, dict(steps["args"], steps=1, record_grads=True)),
        ("place_12", 2, torch_dist.d2v_place_and_gather, dict(
            cfg=steps["args"]["cfg"], pcfg=steps["args"]["pcfg"])),
    ]
    cases += [(f"enc_12_{s}", 2, torch_dist.encoder_training_grads, dict(enc_case["args"], seed=s))
              for s in (11, 12)]
    # last: the command leaves the process group at its end
    cases.append(("cli_dp2", 0, torch_dist.d2v_cli_run, dict(
        argv=driver["argv"] + ["--dp", "2"], cwd=driver["cli_dp2"])))
    return torch_dist.run_ranks(torch_dist.run_scenarios, 2, cases)


@pytest.fixture(scope="module")
def four(steps, jax_runs, driver):
    """Every 4-rank case in one launch of four gloo processes."""
    cases = []
    for grid in ("22", "41"):
        tp = GRIDS[grid][1]
        cases += [(f"steps_{grid}", tp, torch_dist.d2v_steps, steps["args"]),
                  (f"jax_{grid}", tp, torch_dist.d2v_steps, jax_runs["args"])]
    cases.append(("driver_22", 2, torch_dist.d2v_driver, dict(
        cfg=driver["cfg"], pcfg=driver["pcfg"], manifests=driver["data"], out=driver["grid"],
        crash_after=3, **driver["kw"])))
    return torch_dist.run_ranks(torch_dist.run_scenarios, 4, cases)


def _result(ranks, name):
    for r, res in enumerate(ranks):
        v = res[name]
        assert not (isinstance(v, str) and v.startswith("FAILED")), f"rank {r}: {v}"
    return ranks[0][name]


def _ranks(two, four, grid):
    return four if GRIDS[grid][0] * GRIDS[grid][1] == 4 else two


# ---------------------------------------------------------------------------
# the step


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_step_matches_one_process(steps, two, four, grid):
    """Dropout drawn from the generator, the blocks recomputed in the
    backward: the grid's 3 updates are one process's at the global batch,
    and every rank reads the same metrics and holds the same state."""
    ranks = _ranks(two, four, grid)
    metrics, state, _ = _result(ranks, f"steps_{grid}")
    want_m, want_s, _ = steps["single"]
    _close_metrics(metrics, want_m, f"{grid} metrics", STEP_RTOL)
    _close_states(state, want_s, f"{grid} state")
    for r, res in enumerate(ranks[1:], start=1):
        m, s, _ = res[f"steps_{grid}"]
        assert m == metrics, f"rank {r} read other metrics"
        for k, v in s.items():
            np.testing.assert_array_equal(v, state[k], err_msg=f"rank {r}: {k}")
    assert metrics[-1]["loss"] != metrics[0]["loss"]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_fed_jax_draws_matches_the_jax_mesh(jax_runs, two, four, grid):
    metrics, state, _ = _result(_ranks(two, four, grid), f"jax_{grid}")
    want_m, want_s = jax_runs["jax"][grid]
    _close_metrics(metrics, want_m, f"{grid} metrics vs JAX", METRIC_TOL)
    _close_states(state, want_s, f"{grid} state vs JAX")


def test_tp_gradient_of_every_leaf(steps, two):
    """At (1, 2) the gradient of every leaf, gathered to the full layout, is
    one process's: the conv front end, the input projection, the positional
    conv and the LNs upstream of the blocks (the column-parallel inputs'
    backward all-reduce), the replicated biases of proj and fc2 (added once,
    not summed over tp), the sharded qkv, proj, fc1 and fc2, the decoder."""
    _m, _s, grads = _result(two, "grads_12")
    want = steps["grads"][2]
    assert set(grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, err_msg=k, **STATE_TOL)
    for k in ("local_encoder.conv_0.weight", "proj.weight", "pos_conv.pos_conv_0.weight",
              "prenet_ln.weight", "block_0.attn.proj.bias", "block_1.mlp.fc2.bias",
              "prenet_block_0.attn.qkv.weight", "decoder.proj_out.weight"):
        assert np.abs(want[k]).max() > 1e-6, k


def test_place_and_gather_round_trip(steps, two):
    """The student, its EMA blocks and both moments: a rank holds its half
    of every block's qkv (by head), proj and MLP, the rest whole; the
    gather gives the full state back bit for bit."""
    got = _result(two, "place_12")
    cfg = steps["args"]["cfg"]
    C, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    for name in ("prenet_block_0", "block_0", "block_1"):
        for shapes in (got["shapes"], got["mu_shapes"], got["ema_shapes"]):
            assert shapes[f"{name}.attn.qkv.weight"] == (3 * C // 2, C)
            assert shapes[f"{name}.attn.proj.weight"] == (C, C // 2)
            assert shapes[f"{name}.attn.proj.bias"] == (C,)
            assert shapes[f"{name}.mlp.fc1.weight"] == (hidden // 2, C)
            assert shapes[f"{name}.mlp.fc2.weight"] == (C, hidden // 2)
    assert got["shapes"]["prenet_ln.weight"] == (C,)
    assert got["shapes"]["decoder.proj_out.weight"][0] == C
    assert got["round_trip_equal"]


def test_leaf_rule_covers_the_d2v_tree(steps):
    """The split rule keys on the encoder's names: on the d2v student it
    splits the blocks' qkv, proj, fc1 and fc2 and nothing of the decoder,
    the conv stacks, the LNs or the input projection (JAX: any
    params-shaped tree)."""
    _m, _tx, state = td2v.init_d2v_state(steps["args"]["cfg"], steps["args"]["pcfg"])
    mesh = Mesh(dp=1, tp=2, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    split = {k for k, d in encoder_param_sharding(mesh, state.params).items() if d is not None}
    blocks = ("prenet_block_0", "block_0", "block_1")
    want = {f"{b}.{leaf}" for b in blocks for leaf in (
        "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "mlp.fc1.weight",
        "mlp.fc1.bias", "mlp.fc2.weight")}
    assert split == want
    assert set(encoder_param_sharding(mesh, state.ema_blocks)) <= set(state.params)


@pytest.mark.parametrize("seed", [11, 12])
def test_encoder_training_forward_with_layerdrop_over_tp(enc_case, two, seed):
    """The encoder's training forward at (1, 2): layerdrop drawn alike on
    both ranks (else one would skip a block whose all-reduce the other
    enters, and hang), dropout cut to the rank's heads and hidden share;
    features and every gradient equal one process's."""
    x, grads = _result(two, f"enc_12_{seed}")
    want_x, want_g = enc_case["single"][[11, 12].index(seed)]
    np.testing.assert_allclose(x, want_x, rtol=1e-5, atol=2e-6)
    for k, w in want_g.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
    # layerdrop at 0.5 skipped some blocks (no gradient reaches them) and ran
    # others; the front end below them trains
    ran = {k.split(".")[0] for k, w in want_g.items() if "block_" in k and np.abs(w).max() > 0}
    blocks = {k.split(".")[0] for k in want_g if "block_" in k}
    assert 0 < len(ran) < len(blocks), ran
    assert np.abs(want_g["local_encoder.conv_0.weight"]).max() > 0


def test_sharded_step_rejects_an_indivisible_batch(steps):
    a = steps["args"]
    model, tx, _ = td2v.init_d2v_state(a["cfg"], a["pcfg"])
    mesh = Mesh(dp=3, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    step = make_sharded_d2v_step(model, tx, mesh)
    with pytest.raises(ValueError, match="batch_size=4 must divide by dp=3"):
        step(a["state"], a["wav"], a["pad"])


# ---------------------------------------------------------------------------
# the driver and the command line


def _history(d):
    with open(os.path.join(d, "d2v_training_history.json")) as f:
        return [{k: v for k, v in e.items() if k != "wall_s"} for e in json.load(f)]


def _written_state(d, name):
    saved = torch.load(os.path.join(d, name), weights_only=True)["state"]
    return torch_dist.numpy_d2v_state(td2v.D2vTrainState(
        params=saved["params"], ema_blocks=saved["ema_blocks"],
        opt_state=td2v.D2vAdamState(**saved["opt_state"]), step=saved["step"]))


def _close_history(got, want, what):
    assert [sorted(e) for e in got] == [sorted(e) for e in want], what
    for g, w in zip(got, want):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=f"{what}: {w['step']} {k}", **STEP_RTOL)


def _close_encoders(d, want_d, name):
    got = torch.load(os.path.join(d, name), weights_only=True)
    want = torch.load(os.path.join(want_d, name), weights_only=True)
    _close_states({f"params.{k}": v.numpy() for k, v in got.items()},
                  {f"params.{k}": v.numpy() for k, v in want.items()}, name)


def test_driver_over_2x2_writes_the_single_process_files(driver, four):
    """6 updates at (2, 2) with validation every 2 steps, a checkpoint and
    a crash after step 3 (mid-epoch) and a resume: the history, the last
    and best states and both encoder exports of the uninterrupted
    single-process run, written once (rank 0), in its layout."""
    for r, res in enumerate(four):
        v = res["driver_22"]
        assert not (isinstance(v, str) and v.startswith("FAILED")), f"rank {r}: {v}"
    got, one = driver["grid"], driver["one"]
    assert four[0]["driver_22"]["files"] == sorted(os.listdir(one))
    assert sorted(os.listdir(got)) == sorted(os.listdir(one))
    _close_history(_history(got), _history(one), "history")
    assert [e["step"] for e in _history(got) if "valid_loss" in e] == [2, 4, 6]
    for name in ("d2v_last_state.pt", "d2v_best_state.pt"):
        _close_states(_written_state(got, name), _written_state(one, name), name)
    for name in ("encoder_params.pt", "encoder_params_best.pt"):
        _close_encoders(got, one, name)
    with open(os.path.join(got, "d2v_best_state.pt.meta.json")) as f, \
            open(os.path.join(one, "d2v_best_state.pt.meta.json")) as g:
        assert json.load(f)["step"] == json.load(g)["step"]
    # the exported encoder loads as the extraction encoder
    ttrain.load_pretrained_encoder(got, driver["cfg"], "cpu")


def test_driver_mesh_warnings_and_indivisible_batch(driver, caplog, tmp_path):
    """The two ignored flags warn (they are not errors), and a batch that
    does not divide by dp raises the JAX error before any collective."""
    mesh = Mesh(dp=3, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    with caplog.at_level(logging.WARNING), pytest.raises(ValueError,
                                                         match="must divide by dp=3"):
        ttrain.run_d2v_pretrain(driver["cfg"], driver["pcfg"], [driver["data"]],
                                str(tmp_path / "x"), mesh=mesh, transfer_dtype="bfloat16",
                                resident="auto")
    text = caplog.text
    for words in ("transfer_dtype=bfloat16 ignored", "resident corpus ignored"):
        assert words in text, words


def test_cli_dp2_matches_one_process(driver, two):
    """``torchrun --nproc_per_node 2 -m <pkg> d2v-pretrain ... --dp 2`` (two
    gloo ranks): one process's history and encoder, in one save dir."""
    for r, res in enumerate(two):
        v = res["cli_dp2"]
        assert not isinstance(v, str), f"rank {r}: {v}"
        assert v["rc"] == 0
    got = os.path.join(driver["cli_dp2"], "out")
    _close_history(_history(got), _history(driver["cli_one"]), "cli history")
    assert sorted(os.listdir(got)) == sorted(os.listdir(driver["cli_one"]))
    _close_encoders(got, driver["cli_one"], "encoder_params.pt")
