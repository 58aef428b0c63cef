"""The port's (dp, tp) process grid against one process and against the JAX
package's device mesh, on the CPU.

The ranks are gloo processes spawned by ``tests/torch_dist.py`` (2 and 4,
tiny shapes); the JAX side runs here on the 8 virtual CPU devices of
``tests/conftest.py``. Each grid must equal the port's single-process run
at the global batch, and the JAX mesh run:

- the feature DAD step at dp 2 and 4, fed the JAX step's draws (head
  dropout off): metrics and state rtol 1e-5 against one process (the JAX
  package's own mesh-vs-single tolerance, ``tests/test_parallel.py:56``),
  and the single-process parity tolerances of
  ``tests/test_torch_train_step.py`` against JAX;
- the feature trainer at dp 2 over 2 epochs, drawing from its generator
  (dropout on): ``tests/test_parallel.py:230``'s rtol 2e-4 / atol 1e-5;
- extraction at (dp, tp) = (2, 1), (1, 2), (2, 2): atol 2e-5 in f32
  (``tests/test_parallel.py:285``), against one process and JAX;
- the fused step at the same grids, cached clean features and not, against
  one process (rtol 1e-5) and JAX ``make_fused_extract_train_step`` on
  ``make_mesh(4, tp=2)`` (the fused parity tolerances).

And one test for each way a port of the mesh can go wrong: qkv split by
head (not by fused columns), the row-parallel biases added once, the dp
gradient not scaled by dp, the draws rank slices of the global draw.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad import (
    StepScalars as JaxStepScalars,
    init_dad_train_state as jax_init_state,
    set_learning_rate as jax_set_lr,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad.train_step import (
    cosine_lr as jax_cosine_lr,
    epoch_end_dacp as jax_epoch_end,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    Batch as JaxBatch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.convert import (
    fairseq_to_flax_encoder,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.extract import (
    FeatureExtractor as JaxFeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel import (
    FusedConfig as JaxFusedConfig,
    init_fused as jax_init_fused,
    make_fused_extract_train_step as jax_make_fused_step,
    make_mesh as jax_make_mesh,
    make_sharded_dad_train_step as jax_make_sharded_step,
    precompute_clean_features as jax_precompute,
    shard_dad_state as jax_shard_state,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel.fused import (
    FusedBatch as JaxFusedBatch,
    place_fused as jax_place_fused,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepDraws,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    write_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    flax_train_state_to_torch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    conv_out_lengths,
    convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    FusedBatch,
    FusedConfig,
    Mesh,
    batch_sharding,
    encoder_param_sharding,
    make_mesh,
    precompute_clean_features,
    shard_encoder_state,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.fused import (
    init_fused,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.mesh import (
    batch_rows,
)

import torch_dist
from torch_mirror import rand_sd
from torch_parity import TINY, cfg_pair, jax_normal, jax_strong_draws, one_torch_thread  # noqa: F401

# the JAX package's own mesh-vs-single tolerances (tests/test_parallel.py)
STEP_RTOL = 1e-5
TRAINER_TOL = dict(rtol=2e-4, atol=1e-5)
FEAT_ATOL = 2e-5
# port vs JAX (tests/test_torch_train_step.py): summation order only
METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
# DACP lets rows through from the first batch, so consistency and ECDA weigh
OVERRIDES = {"dacp.quantile_start": 0.0, "dacp.quantile_end": 0.2,
             "dacp.threshold_smoothing_alpha": 0.0}
EPOCHS = (0, 3)
B_FEAT, B_WAV, T_WAV = 16, 8, 400
CLASSES = ("ang", "hap", "neu", "sad")


def _cfgs(input_dim=16, batch_size=B_FEAT, **kw):
    args = dict(input_dim=input_dim, hidden_dim=8, batch_size=batch_size, warmup_epochs=1,
                ecda_start_epoch=1, epochs=10, weight_ramp_epochs=2, dropout_rate=0.0)
    args.update(kw)
    return jax_dad_preset("iemocap", OVERRIDES, **args), dad_preset("iemocap", OVERRIDES, **args)


def _feature_batch(rng, labeled, shift=0.0, B=B_FEAT, T=6, D=16):
    feats = (rng.normal(size=(B, T, D)) + shift).astype(np.float32)
    lengths = rng.integers(2, T + 1, B)
    pm = np.arange(T)[None, :] >= lengths[:, None]
    labels = rng.integers(0, 4, B).astype(np.int32) if labeled else np.full(B, -1, np.int32)
    if labeled:
        feats += labels[:, None, None] * 0.5
    row_valid = np.ones(B, bool)
    row_valid[-1] = not labeled  # one padded clean row
    return JaxBatch(feats=feats, padding_mask=pm, labels=labels,
                    ids=np.arange(B, dtype=np.int32), row_valid=row_valid)


def _wav_batch(rng, lengths, labeled):
    B = len(lengths)
    wav = np.zeros((B, T_WAV), np.float32)
    mask = np.ones((B, T_WAV), bool)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.normal(size=n) * 0.3
        mask[i, :n] = False
    labels = np.arange(B, dtype=np.int32) % 4 if labeled else np.full(B, -1, np.int32)
    return JaxFusedBatch(wav=wav, wav_mask=mask, labels=labels, row_valid=np.ones(B, bool))


def _port_fused(batch, ids=False):
    b = FusedBatch(*(torch.from_numpy(np.asarray(v)) for v in batch[:4]))
    return b._replace(ids=torch.arange(len(b.labels), dtype=torch.int32)) if ids else b


def _close(got: dict, want: dict, what: str, **tol):
    assert set(want) <= set(got), (what, sorted(set(want) - set(got)))
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(w, np.float64),
                                   err_msg=f"{what}: {k}", **tol)


def _jax_state(state) -> dict:
    """A JAX DAD state as ``torch_dist.numpy_state`` lays the port's out."""
    return torch_dist.numpy_state(flax_train_state_to_torch(jax.tree.map(np.array, state)))


def _jax_metrics(m) -> dict:
    return {k: float(v) for k, v in m.items() if k != "tracking"}


# ---------------------------------------------------------------------------
# inputs, the JAX runs, and the two launches of ranks


@pytest.fixture(scope="module")
def feat():
    """The feature step: one state, two batch pairs, the JAX draws, and the
    JAX package's single and 8-device dp runs."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = _cfgs()
    head, tx, jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    state = flax_train_state_to_torch(jax.tree.map(np.array, jstate))
    batches = [(_feature_batch(rng, True), _feature_batch(rng, False, 0.3)) for _ in EPOCHS]
    draws, keys = [], []
    for epoch, (_c, noisy) in zip(EPOCHS, batches):
        key = jax.random.PRNGKey(10 + epoch)
        _k_dc, k_weak, k_strong, _k_ds = jax.random.split(key, 4)
        draws.append(StepDraws(weak=jax_normal(k_weak, noisy.feats.shape),
                               strong=jax_strong_draws(k_strong, noisy.feats.shape,
                                                       noisy.padding_mask, jcfg.augment)))
        keys.append(key)
    mesh = jax_make_mesh(8, tp=1, axis_names=("dp",))
    sharded = jax_make_sharded_step(head, tx, jcfg, mesh)
    js = jax_shard_state(jstate, mesh)
    jax_out = []
    for epoch, (clean, noisy), key in zip(EPOCHS, batches, keys):
        js = js._replace(opt_state=jax_set_lr(js.opt_state, jax_cosine_lr(jcfg, epoch)))
        js, m, _tr = sharded(js, clean, noisy, JaxStepScalars.for_epoch(jcfg, epoch),
                             jnp.zeros(4), key)
        js = jax_epoch_end(js, jcfg)
        jax_out.append((_jax_metrics(m), _jax_state(js)))
    single = torch_dist.feature_steps(tcfg, state, batches, EPOCHS, draws, seed=0)
    _j, tcfg_drop = _cfgs(dropout_rate=0.1)
    return dict(cfg=tcfg, cfg_drop=tcfg_drop, state=state, batches=batches, draws=draws,
                jax=jax_out, single=single,
                single_gen=torch_dist.feature_steps(tcfg_drop, state, batches, EPOCHS, None,
                                                    seed=5),
                single_grads=torch_dist.feature_steps(tcfg, state, batches, EPOCHS, draws,
                                                      seed=0, tx=torch_dist.GradRecorder()))


def _enc_cfgs():
    return cfg_pair(use_flash_attention=False)[0], cfg_pair()[1]


@pytest.fixture(scope="module")
def enc():
    """Random fairseq-layout weights (nonzero biases everywhere) for the
    tiny encoder, in both layouts, and ragged clips."""
    jenc, tenc = _enc_cfgs()
    sd = rand_sd(jenc, seed=3)
    rng = np.random.default_rng(1)
    clips = [rng.normal(size=n).astype(np.float32) * 0.1
             for n in (350, 420, 500, 610, 700, 380, 450, 520)]
    return dict(jcfg=jenc, tcfg=tenc, jparams=fairseq_to_flax_encoder(sd, jenc),
                tstate=fairseq_to_torch_encoder(sd, tenc), clips=clips)


@pytest.fixture(scope="module")
def fused(enc):
    """The fused step, cached clean features and inline: the JAX draws and
    the port's single-process runs; for the cached case (the fused
    trainer's) JAX's run on make_mesh(4, tp=2)."""
    rng = np.random.default_rng(2)
    jdad, tdad = _cfgs(input_dim=TINY["embed_dim"], batch_size=B_WAV)
    _j, tdad_drop = _cfgs(input_dim=TINY["embed_dim"], batch_size=B_WAV, dropout_rate=0.1)
    clean = _wav_batch(rng, [400, 350, 300, 400, 250, 380, 400, 330], labeled=True)
    noisy = _wav_batch(rng, [400, 310, 390, 390, 270, 400, 360, 400], labeled=False)
    layers = enc["tcfg"].conv_feature_layers
    frames = int(conv_out_lengths(torch.tensor([T_WAV]), layers)[0])
    fmask = convert_padding_mask(torch.from_numpy(noisy.wav_mask), frames, layers).numpy()
    feat_shape = (B_WAV, frames, TINY["embed_dim"])
    keys = [jax.random.PRNGKey(20 + epoch) for epoch in EPOCHS]
    draws = []
    for key in keys:
        k_inj, _k_dc, k_w, k_s, _k_ds = jax.random.split(key, 5)
        draws.append(StepDraws(inject=jax_normal(k_inj, noisy.wav.shape),
                               weak=jax_normal(k_w, feat_shape),
                               strong=jax_strong_draws(k_s, feat_shape, fmask, jdad.augment)))
    out = {}
    for cached in (True, False):
        jcfg = JaxFusedConfig(encoder=enc["jcfg"], dad=jdad, inject_snr_db=10.0,
                              cache_clean_features=cached)
        tcfg = FusedConfig(encoder=enc["tcfg"], dad=tdad, inject_snr_db=10.0,
                           cache_clean_features=cached)
        encoder, _p, head, tx, jstate = jax_init_fused(jcfg, jax.random.PRNGKey(3),
                                                       example_len=T_WAV)
        state = flax_train_state_to_torch(jax.tree.map(np.array, jstate))
        jax_out = []
        if cached:
            mesh = jax_make_mesh(4, tp=2)
            step = jax_make_fused_step(encoder, head, tx, jcfg, mesh)
            with mesh:
                enc_s, js = jax_place_fused(enc["jparams"], jstate, mesh)
                jclean = jax_precompute(encoder, enc["jparams"], jcfg, clean)
                for epoch, key in zip(EPOCHS, keys):
                    js = js._replace(opt_state=jax_set_lr(js.opt_state,
                                                          jax_cosine_lr(jdad, epoch)))
                    js, m = step(enc_s, js, jclean, noisy,
                                 JaxStepScalars.for_epoch(jdad, epoch), jnp.zeros(4), key)
                    js = jax_epoch_end(js, jdad)
                    jax_out.append((_jax_metrics(m), _jax_state(js)))
        tclean = _port_fused(clean)
        if cached:
            tenc, *_ = init_fused(tcfg, enc["tstate"], device="cpu")
            tclean = precompute_clean_features(tenc, tcfg, tclean)
        args = (tcfg, enc["tstate"], state, tclean, _port_fused(noisy, ids=True), EPOCHS)
        gen_args = (dataclasses.replace(tcfg, dad=tdad_drop),) + args[1:]
        out[cached] = dict(
            args=args, draws=draws, jax=jax_out, gen_args=gen_args,
            single=torch_dist.fused_steps(*args, draws, seed=0),
            single_gen=torch_dist.fused_steps(*gen_args, None, seed=7) if cached else None)
    return out


def _write_stores(root, per_session=6, D=16):
    rng = np.random.default_rng(4)
    clips, labels, names = [], [], []
    for s in range(1, 6):
        for i in range(per_session):
            c = (i + s) % 4
            x = rng.normal(size=(int(rng.integers(5, 30)), D)).astype(np.float32)
            x[:, c] += 3.0
            clips.append(x)
            labels.append(CLASSES[c])
            names.append(f"Ses0{s}{'FM'[i % 2]}_impro0{i % 7}_{'FM'[i % 2]}{i:03d}")
    clean, noisy = os.path.join(root, "clean"), os.path.join(root, "root1-white-10db")
    write_feature_store(clean, clips, labels=labels, utt_names=names)
    write_feature_store(noisy, [c + rng.normal(0, 0.3, c.shape).astype(np.float32)
                                for c in clips], labels=labels, utt_names=names)
    return clean, noisy


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stores"))
    clean, noisy = _write_stores(root)

    def cfg(base):
        return dad_preset("iemocap", input_dim=16, hidden_dim=8, batch_size=8,
                          warmup_epochs=1, ecda_start_epoch=1, epochs=4, weight_ramp_epochs=2,
                          clean_data_dir=clean, noisy_data_dir=noisy,
                          results_base_dir=os.path.join(root, base))

    return dict(args=(cfg("dp"), clean, noisy, 2),
                single=torch_dist.trainer_epochs(cfg("one"), clean, noisy, 2))


FUSED_CLI_ENC = dict(embed_dim=16, depth=1, num_heads=2, prenet_depth=1,
                     conv_feature_layers=[[8, 10, 5], [8, 8, 4]], conv_pos_width=6,
                     conv_pos_groups=2, conv_pos_depth=2, dtype="float32",
                     use_flash_attention=True, normalize_input=False)


@pytest.fixture(scope="module")
def fused_cli(tmp_path_factory):
    """``cli dad --from-wav`` on the JAX tests' EMODB tone corpus with a
    tiny encoder: the argv, and the run on one process (in this one)."""
    import json as json_mod

    from test_fused_trainer import make_corpus

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
        EncoderConfig,
    )

    root = tmp_path_factory.mktemp("fused_cli")
    manifests = make_corpus(str(root), clips_per_spk=4)
    cfg = EncoderConfig(**{**FUSED_CLI_ENC, "conv_feature_layers": tuple(
        tuple(x) for x in FUSED_CLI_ENC["conv_feature_layers"])})
    ckpt = str(root / "e2v.pt")
    torch.save({"model": rand_sd(cfg, seed=0)}, ckpt)
    argv = ["dad", "--corpus", "emodb", "--from-wav", manifests, "--checkpoint", ckpt,
            "--encoder-json", json_mod.dumps(FUSED_CLI_ENC), "--encoder-dtype", "float32",
            "--fold", "0", "--epochs", "2", "--warmup-epochs", "1", "--batch-size", "8",
            "--device", "cpu"]
    os.makedirs(root / "one")
    cwd = os.getcwd()
    try:
        single = torch_dist.cli_run(argv, str(root / "one"))
    finally:
        os.chdir(cwd)
    return dict(argv=argv, root=root, single=single)


@pytest.fixture(scope="module")
def two(feat, enc, fused, trainer, fused_cli):
    """Every 2-rank case in one launch of two gloo processes."""
    f, c = feat, fused[True]
    fs = (f["cfg"], f["state"], f["batches"], EPOCHS)
    cases = [
        ("facts", 1, torch_dist.mesh_facts, {}),
        ("feat", 1, torch_dist.feature_steps, dict(zip(
            ("cfg", "state", "batches", "epochs"), fs), draws=f["draws"], seed=0)),
        ("feat_gen", 1, torch_dist.feature_steps, dict(
            cfg=f["cfg_drop"], state=f["state"], batches=f["batches"], epochs=EPOCHS,
            draws=None, seed=5)),
        ("feat_grads", 1, torch_dist.feature_steps, dict(zip(
            ("cfg", "state", "batches", "epochs"), fs), draws=f["draws"], seed=0,
            tx=torch_dist.GradRecorder())),
        ("trainer", 1, torch_dist.trainer_epochs, dict(zip(
            ("cfg", "clean_dir", "noisy_dir", "epochs"), trainer["args"]))),
    ]
    for tp, name in ((1, "21"), (2, "12")):
        cases += [
            (f"extract_{name}", tp, torch_dist.extract, dict(
                cfg=enc["tcfg"], enc_state=enc["tstate"], clips=enc["clips"], batch_size=4)),
            (f"fused_{name}", tp, torch_dist.fused_steps, dict(
                zip(("cfg", "enc_state", "state", "clean", "noisy", "epochs"), c["args"]),
                draws=c["draws"], seed=0)),
            (f"fused_gen_{name}", tp, torch_dist.fused_steps, dict(
                zip(("cfg", "enc_state", "state", "clean", "noisy", "epochs"), c["gen_args"]),
                draws=None, seed=7)),
        ]
    # last: the command leaves the process group at its end
    os.makedirs(fused_cli["root"] / "dp2")
    cases.append(("cli_dp2", 0, torch_dist.cli_run, dict(
        argv=fused_cli["argv"] + ["--dp", "2"], cwd=str(fused_cli["root"] / "dp2"))))
    return torch_dist.run_ranks(torch_dist.run_scenarios, 2, cases)


@pytest.fixture(scope="module")
def four(feat, enc, fused):
    """Every 4-rank case in one launch of four gloo processes."""
    f, c, u = feat, fused[True], fused[False]
    keys = ("cfg", "enc_state", "state", "clean", "noisy", "epochs")
    cases = [
        ("facts", 1, torch_dist.mesh_facts, {}),
        ("feat", 1, torch_dist.feature_steps, dict(
            cfg=f["cfg"], state=f["state"], batches=f["batches"], epochs=EPOCHS,
            draws=f["draws"], seed=0)),
        ("extract_22", 2, torch_dist.extract, dict(
            cfg=enc["tcfg"], enc_state=enc["tstate"], clips=enc["clips"], batch_size=4)),
        ("fused_22", 2, torch_dist.fused_steps, dict(zip(keys, c["args"]), draws=c["draws"],
                                                     seed=0)),
        ("fused_uncached_22", 2, torch_dist.fused_steps, dict(
            zip(keys, u["args"]), draws=u["draws"], seed=0)),
    ]
    return torch_dist.run_ranks(torch_dist.run_scenarios, 4, cases)


def _result(ranks, name):
    """The case's result on rank 0, after checking every rank failed to
    raise and returned the same (the state is replicated)."""
    for r, res in enumerate(ranks):
        v = res[name]
        assert not (isinstance(v, str) and v.startswith("FAILED")), f"rank {r}: {v}"
    return ranks[0][name]


def _same_on_every_rank(ranks, name):
    first = ranks[0][name]
    for res in ranks[1:]:
        for a, b in zip(first, res[name]):
            for x, y in zip(a, b):
                if isinstance(x, dict):
                    for k in x:
                        np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                                      err_msg=f"{name}: {k}")


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_grid_and_subgroups(two, four):
    for ranks, world in ((two, 2), (four, 4)):
        for r, res in enumerate(ranks):
            facts = _result(ranks, "facts") if r == 0 else res["facts"]
            for tp, f in facts.items():
                assert (f["dp"], f["tp"], f["rank"]) == (world // tp, tp, r)
                assert (f["dp_rank"], f["tp_rank"]) == (r // tp, r % tp)  # tp the inner axis
                assert f["tp_ranks"] == [r // tp * tp + t for t in range(tp)]
                assert f["dp_ranks"] == [d * tp + r % tp for d in range(world // tp)]
                assert f["backend"] == "gloo"


def test_make_mesh_errors_and_batch_sharding(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="n_devices=2 not divisible by tp=3"):
        make_mesh(tp=3, device="cpu")
    with pytest.raises(ValueError, match="need 4 processes, have 2"):
        make_mesh(4, device="cpu")
    mesh = Mesh(dp=2, tp=2, rank=3, device=torch.device("cpu"), dp_group=None, tp_group=None)
    assert (mesh.dp_rank, mesh.tp_rank) == (1, 1)
    assert batch_rows(mesh, 8) == slice(4, 8)
    x = np.arange(24).reshape(8, 3)
    got = batch_sharding(mesh, (x, torch.tensor(1.0), None))
    np.testing.assert_array_equal(got[0].numpy(), x[4:])
    assert got[1] == 1.0 and got[2] is None
    with pytest.raises(ValueError, match="batch_size=6 must divide by dp=4"):
        batch_sharding(dataclasses.replace(mesh, dp=4), np.zeros((6, 2)))


def test_shard_encoder_state_splits_qkv_by_head_and_reassembles(enc):
    """Trap 1: a rank holds its heads of each of q, k and v, not a
    contiguous slice of the fused qkv rows; the shards reassemble the full
    weights, and the layout classes the entries as the JAX
    ``_encoder_leaf_spec`` does."""
    full = enc["tstate"]
    C, H = TINY["embed_dim"], TINY["num_heads"]
    Dh = C // H
    tp = 2
    mesh = Mesh(dp=1, tp=tp, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    spec = encoder_param_sharding(mesh, full)
    shards = [shard_encoder_state(full, mesh, tp_rank=r) for r in range(tp)]
    qkv = "block_0.attn.qkv.weight"
    assert spec[qkv] == 0 and spec["block_0.attn.proj.weight"] == 1
    assert spec["block_0.mlp.fc1.bias"] == 0 and spec["block_0.mlp.fc2.weight"] == 1
    assert spec["block_0.attn.proj.bias"] is None and spec["block_0.mlp.fc2.bias"] is None
    assert spec["proj.weight"] is None and spec["local_encoder.conv_0.weight"] is None
    w = full[qkv]  # (3C, C): rows [q heads | k heads | v heads]
    for r in range(tp):
        heads = range(r * H // tp, (r + 1) * H // tp)
        want = torch.cat([w[s * C + h * Dh: s * C + (h + 1) * Dh] for s in range(3) for h in heads])
        torch.testing.assert_close(shards[r][qkv], want, rtol=0, atol=0)
    assert not torch.equal(shards[0][qkv], w[: 3 * C // tp])  # not the fused columns' split
    for k, v in full.items():
        d = spec[k]
        if d is None:
            assert all(s[k] is v for s in shards)
        elif k.endswith("qkv.weight") or k.endswith("qkv.bias"):
            parts = [s[k].chunk(3) for s in shards]
            torch.testing.assert_close(torch.cat([torch.cat([p[i] for p in parts])
                                                  for i in range(3)]), v, rtol=0, atol=0)
        else:
            torch.testing.assert_close(torch.cat([s[k] for s in shards], dim=d), v,
                                       rtol=0, atol=0)
    # a one-axis mesh holds everything whole
    dp_only = Mesh(dp=2, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    assert all(v is None for v in encoder_param_sharding(dp_only, full).values())


# ---------------------------------------------------------------------------
# the dp DAD step and the feature trainer


@pytest.mark.parametrize("world", [2, 4])
def test_dp_feature_step_matches_one_process_and_jax(feat, two, four, world):
    ranks = two if world == 2 else four
    got = _result(ranks, "feat")
    _same_on_every_rank(ranks, "feat")
    for (gm, gtr, gs), (sm, str_, ss), (jm, js) in zip(got, feat["single"], feat["jax"]):
        _close(gm, sm, "metrics vs one process", rtol=STEP_RTOL, atol=1e-7)
        _close(gs, ss, "state vs one process", rtol=STEP_RTOL, atol=1e-6)
        for k in ("pseudo_label", "is_masked_in", "ids"):
            np.testing.assert_array_equal(gtr[k], str_[k])
        _close(gm, jm, "metrics vs JAX mesh", **METRIC_TOL)
        _close(gs, js, "state vs JAX mesh", **STATE_TOL)
    assert got[1][0]["consistency_loss"] > 0 and got[1][0]["ecda_loss"] > 0


def test_dp_gradient_is_the_global_batch_gradient(feat, two):
    """Trap 3: every rank computes the same global loss, so the all-gather's
    backward sums dp copies of each rank's gradient; the step divides the
    summed gradient by dp. Held to one process's gradient at the global
    batch (a factor of 2 would be off by 100 %)."""
    got = _result(two, "feat_grads")
    for g, s in zip(got, feat["single_grads"]):
        _close(g[3], s[3], "head gradient", rtol=STEP_RTOL, atol=1e-7)
        assert max(np.abs(v).max() for v in s[3].values()) > 1e-3


def test_dp_draws_are_rank_slices_of_the_global_draw(feat, two):
    """Trap 4: with head dropout on and every draw from the generator (the
    trainer's order), 2 ranks equal one process at twice the rows."""
    got = _result(two, "feat_gen")
    for (gm, _gt, gs), (sm, _st, ss) in zip(got, feat["single_gen"]):
        _close(gm, sm, "metrics", rtol=STEP_RTOL, atol=1e-7)
        _close(gs, ss, "state", rtol=STEP_RTOL, atol=1e-6)


def test_feature_trainer_dp_matches_single(trainer, two):
    avgs, state = _result(two, "trainer")
    want_avgs, want_state = trainer["single"]
    for a, b in zip(avgs, want_avgs):
        _close(a, b, "epoch means", **TRAINER_TOL)
    _close(state, want_state, "state after 2 epochs", **TRAINER_TOL)


def test_feature_trainer_mesh_rules(trainer, tmp_path):
    cfg, clean, noisy, _ = trainer["args"]
    mesh = Mesh(dp=2, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
        CrossDomainTrainer,
    )

    for kw, words in ((dict(scan_chunk=4), "scan_chunk"), (dict(resident=True), "resident=True")):
        with pytest.raises(ValueError, match=words):
            CrossDomainTrainer(cfg, mesh=mesh, device="cpu", **kw)
    with pytest.raises(ValueError, match="batch_size=8 must divide by dp=3"):
        CrossDomainTrainer(cfg, mesh=dataclasses.replace(mesh, dp=3), device="cpu")
    # a rank other than 0 writes nothing: no results tree, checkpoint or report
    cfg = dataclasses.replace(cfg, results_base_dir=str(tmp_path / "results"))
    t = CrossDomainTrainer(cfg, mesh=dataclasses.replace(mesh, rank=1), device="cpu")
    assert not t.is_writer and t._resident is None
    results = {"weighted_accuracy": 50.0}
    t.save_checkpoint(0, results, results, is_best=True)
    t.save_resume_checkpoint(0)
    t._save_analysis_data()
    assert not os.path.exists(tmp_path / "results")


# ---------------------------------------------------------------------------
# extraction over dp x tp


@pytest.fixture(scope="module")
def extraction(enc):
    single = torch_dist.extract(enc["tcfg"], enc["tstate"], enc["clips"], batch_size=4)
    jax_feats = [np.array(f) for f in JaxFeatureExtractor(
        enc["jcfg"], enc["jparams"], batch_size=4, buckets=(1024,)).extract_clips(enc["clips"])]
    return single, jax_feats


@pytest.mark.parametrize("grid", ["21", "12", "22"])
def test_extraction_over_the_grid(extraction, two, four, grid):
    """Trap 2 lies on this path too: the tp ranks' proj and fc2 biases
    (random, nonzero) are added once, after the sum."""
    got = _result(four if grid == "22" else two, f"extract_{grid}")
    single, jax_feats = extraction
    for g, s, j in zip(got, single, jax_feats):
        assert g.shape == s.shape == np.asarray(j).shape
        np.testing.assert_allclose(g, s, rtol=0, atol=FEAT_ATOL)
        np.testing.assert_allclose(g, np.asarray(j), rtol=0, atol=FEAT_ATOL)


def test_extraction_rejects_an_indivisible_batch(enc):
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
        FeatureExtractor,
    )

    mesh = Mesh(dp=4, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    with pytest.raises(ValueError, match="divide"):
        FeatureExtractor(enc["tcfg"], enc["tstate"], batch_size=6, device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# the fused step over dp x tp


@pytest.mark.parametrize("grid", ["21", "12", "22"])
def test_fused_step_over_the_grid(fused, two, four, grid):
    """Cached clean features (the fused trainer's configuration)."""
    ranks = four if grid == "22" else two
    got = _result(ranks, f"fused_{grid}")
    _same_on_every_rank(ranks, f"fused_{grid}")
    case = fused[True]
    for (gm, gs), (sm, ss), (jm, js) in zip(got, case["single"], case["jax"]):
        _close(gm, sm, "metrics vs one process", rtol=STEP_RTOL, atol=1e-6)
        _close(gs, ss, "state vs one process", rtol=STEP_RTOL, atol=1e-6)
        _close(gm, jm, "metrics vs JAX mesh", **METRIC_TOL)
        _close(gs, js, "state vs JAX mesh", **STATE_TOL)
    assert got[1][0]["consistency_loss"] > 0


def test_fused_step_with_inline_clean_extraction_over_dp_and_tp(fused, four):
    """Both streams through the tp-sharded encoder, at (2, 2)."""
    got = _result(four, "fused_uncached_22")
    for (gm, gs), (sm, ss) in zip(got, fused[False]["single"]):
        _close(gm, sm, "metrics vs one process", rtol=STEP_RTOL, atol=1e-6)
        _close(gs, ss, "state vs one process", rtol=STEP_RTOL, atol=1e-6)


@pytest.mark.parametrize("grid", ["21", "12"])
def test_fused_draws_are_rank_slices_of_the_global_draw(fused, two, grid):
    """Trap 4 on the fused step: injection, dropout and augmentation all
    from the generator."""
    got = _result(two, f"fused_gen_{grid}")
    for (gm, gs), (sm, ss) in zip(got, fused[True]["single_gen"]):
        _close(gm, sm, "metrics", rtol=STEP_RTOL, atol=1e-6)
        _close(gs, ss, "state", rtol=STEP_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the command line


def test_cli_from_wav_over_dp_2_matches_one_process(fused_cli, two):
    """``torchrun --nproc_per_node 2 -m <pkg> dad --from-wav ... --dp 2`` (two
    gloo ranks, the resident corpus on each): the history of one process
    at the same global batch, in one results tree."""
    ranks = [r["cli_dp2"] for r in two]
    for r, res in enumerate(ranks):
        assert not isinstance(res, str), f"rank {r}: {res}"
        assert res["rc"] == 0
    got, want = ranks[0]["history"], fused_cli["single"]["history"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), err_msg=k, **TRAINER_TOL)
    assert len(ranks[0]["best"]) == 1



def _options(parser, command):
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {o: (a.default, a.type, a.choices) for a in sub.choices[command]._actions
            for o in a.option_strings}


def _jax_parser():
    import argparse

    captured = {}

    def parse(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(SystemExit):
            jax_cli.main(["--help"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


@pytest.mark.parametrize("command", ["dad", "extract", "preprocess", "inject"])
def test_cli_flags_agree_with_jax(command):
    """--dp/--tp agree with the JAX CLI in name, default and type on dad
    and extract (preprocess has neither in both); the top-level inject has
    the JAX flags exactly (no --tolerance), beside the port's --device."""
    port, jax_opts = _options(cli.build_parser(), command), _options(_jax_parser(), command)
    for flag in ("--dp", "--tp"):
        assert (flag in port) == (flag in jax_opts), flag
        if flag in port:
            assert port[flag] == jax_opts[flag], flag
    if command == "inject":
        assert set(port) - {"--device"} == set(jax_opts)
        assert "--tolerance" not in port
