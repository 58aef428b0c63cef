"""The port's fused wav->train trainer against the JAX package's, on the
JAX tests' EMODB tone corpus (``tests/test_fused_trainer.py::make_corpus``
at 4 clips a speaker: 10 speakers x 4 clips of 0.25-0.45 s, class coded in
frequency and amplitude) and its tiny encoder (``TINY_ENC``, f32, weights
converted with ``flax_encoder_to_torch``), one wav bucket and one
extraction bucket of 8000 samples, batch 8, 3 epochs, warmup 1, head
dropout off.

In the whole-trainer comparison the port is fed the JAX trainer's own
draws: ``PRNGKey(seed + 1)`` split once per step, each step's key split in 5
(injection, clean dropout, weak, strong, student dropout) as the JAX fused
step splits it. Both load one pretrain head, so the anchor calibrations
start from one student. To hold the trainer loop apart from the encoder,
the port runs from a ``shared`` dict whose clean and noisy stores are the
JAX extraction's arrays; the port's own extraction is compared with the
JAX one separately. Each training step still runs the noisy stream through
each framework's encoder.

Tolerances: extracted features EXTRACT_TOL (f32, 2 blocks over up to 1800
frames: summation order and the LayerNorm variance formula, as
``tests/test_torch_models.py``); losses, DACP series and anchors
METRIC_TOL; parameters of the best .pth STATE_TOL (atol 2e-6 / rtol 1e-4,
``tests/test_torch_trainer.py``'s). Accuracies, disagreement rates, the
best epoch and the layered results path are compared exactly.

Bank injection in root2 mode (a NOISEX type drawn a clip) draws noise
types that ``StepDraws`` does not carry: it is held to the JAX package by
its bank (bit-equal), its fixed domain (bit-equal,
``tests/test_torch_wavdata.py``) and a trainer run whose losses are finite.
Root1 mode (one type) is fed the JAX offsets through ``bank_offsets`` in
``tests/test_torch_experiments.py``.
"""

import json
import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    paired_epoch as jax_paired_epoch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel.fused import (
    FusedConfig as JaxFusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train.fused_trainer import (
    FusedCrossDomainTrainer as JaxFusedTrainer,
    prepare_fused_shared as jax_prepare_shared,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepDraws,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    FeatureStore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    load_torch_file,
    save_torch_file,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    conv_out_lengths,
    convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    FusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    FusedCrossDomainTrainer,
    fused_trainer,
    prepare_fused_shared,
    refresh_noisy_domain,
)

from test_fused_trainer import TINY_ENC, _make_noise_root, make_corpus, tiny_enc_params
from torch_parity import jax_normal, jax_strong_draws, port_cfg, to_torch

EXTRACT_TOL = dict(atol=3e-5, rtol=1e-4)
METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
D, HIDDEN = TINY_ENC.embed_dim, 8
# DACP lets rows through from the first post-warmup batch, so the
# consistency and ECDA terms carry weight (tests/test_torch_trainer.py)
OVERRIDES = {"dacp.quantile_start": 0.0, "dacp.quantile_end": 0.2,
             "dacp.threshold_smoothing_alpha": 0.0}
PORT_ENC = port_cfg(TINY_ENC)
BUCKETS = (8000,)


def _cfg_kw(root, **kw):
    out = dict(batch_size=8, epochs=3, warmup_epochs=1, ecda_start_epoch=1,
               weight_ramp_epochs=2, validation_interval=1, hidden_dim=HIDDEN,
               dropout_rate=0.0, results_base_dir=os.path.join(root, "results"))
    out.update(kw)
    return out


def _write_pretrain(path):
    """A pretrain head (D -> 8 -> 4) both frameworks load."""
    g = torch.Generator().manual_seed(1)
    save_torch_file({"pre_net.weight": torch.randn(HIDDEN, D, generator=g) * 0.3,
                     "pre_net.bias": torch.zeros(HIDDEN),
                     "post_net.weight": torch.randn(4, HIDDEN, generator=g) * 0.3,
                     "post_net.bias": torch.zeros(4)}, path)
    return path


def _port_store(s):
    """A JAX FeatureStore's arrays as the port's FeatureStore."""
    return FeatureStore(feats=np.asarray(s.feats), sizes=np.asarray(s.sizes),
                        offsets=np.asarray(s.offsets), labels=s.labels, groups=s.groups,
                        label_names=s.label_names, utt_names=s.utt_names)


def _jax_trainer_draws(jt, jcfg):
    """{(epoch, step): StepDraws} replaying the JAX fused trainer's keys."""
    key = jax.random.PRNGKey(jcfg.random_seed + 1)
    layers = TINY_ENC.conv_feature_layers
    draws = {}
    for epoch in range(jcfg.epochs):
        for step, (_c, wb) in enumerate(jax_paired_epoch(jt.clean_train, jt.noisy_wav_train,
                                                         epoch)):
            key, k = jax.random.split(key)
            k_inj, _k_dc, k_w, k_s, _k_ds = jax.random.split(k, 5)
            T = wb.wav.shape[1]
            t_frames = int(conv_out_lengths(torch.tensor([T]), layers)[0])
            fmask = convert_padding_mask(torch.from_numpy(wb.wav_mask), t_frames, layers).numpy()
            shape = (wb.wav.shape[0], t_frames, D)
            draws[(epoch, step)] = StepDraws(
                inject=jax_normal(k_inj, wb.wav.shape),
                weak=jax_normal(k_w, shape),
                strong=jax_strong_draws(k_s, shape, fmask, jcfg.augment))
    return draws


def _json(path):
    with open(path) as f:
        return json.load(f)


def _reports(t):
    return os.path.join(t.results_dir, "reports")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trainer's run and both startups, shared by the tests below."""
    root = str(tmp_path_factory.mktemp("fused_port"))
    corpus = make_corpus(root, clips_per_spk=4)
    ckpt = _write_pretrain(os.path.join(root, "pm.ckpt"))
    kw = _cfg_kw(root, pretrained_weight=ckpt)
    jcfg = jax_dad_preset("emodb", OVERRIDES, **kw)
    cfg = dad_preset("emodb", OVERRIDES, **kw)
    params = tiny_enc_params()
    jfused = JaxFusedConfig(encoder=TINY_ENC, dad=jcfg, inject_snr_db=10.0)
    jshared = jax_prepare_shared(jcfg, corpus, TINY_ENC, params,
                                 replace(jfused, cache_clean_features=True), None,
                                 extract_buckets=BUCKETS)
    jt = JaxFusedTrainer(jcfg, corpus, TINY_ENC, params, fused_cfg=jfused, fold=0,
                         experiment_name="jax", prefetch_depth=0, wav_buckets=BUCKETS,
                         shared=jshared)
    jout = jt.train()
    fused = FusedConfig(encoder=PORT_ENC, dad=cfg, inject_snr_db=10.0)
    shared = prepare_fused_shared(cfg, corpus, PORT_ENC, to_torch(params),
                                  replace(fused, cache_clean_features=True), None,
                                  extract_buckets=BUCKETS, device="cpu")
    return dict(root=root, corpus=corpus, cfg=cfg, jcfg=jcfg, fused=fused, params=params,
                jshared=jshared, shared=shared, jt=jt, jout=jout,
                draws=_jax_trainer_draws(jt, jcfg))


def test_prepare_fused_shared_matches_jax(run):
    shared, jshared = run["shared"], run["jshared"]
    np.testing.assert_array_equal(shared["wav_store"].samples, jshared["wav_store"].samples)
    for name in ("clean_store", "noisy_store"):
        got, want = shared[name], jshared[name]
        np.testing.assert_array_equal(got.sizes, want.sizes)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.utt_names == want.utt_names
        np.testing.assert_allclose(got.feats, np.asarray(want.feats), **EXTRACT_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("resident", [False, True], ids=["streamed", "resident"])
def test_whole_trainer_matches_jax(run, resident):
    draws = run["draws"]
    shared = dict(run["shared"], clean_store=_port_store(run["jshared"]["clean_store"]),
                  noisy_store=_port_store(run["jshared"]["noisy_store"]))
    t = FusedCrossDomainTrainer(
        run["cfg"], run["corpus"], PORT_ENC, None, fused_cfg=run["fused"], fold=0,
        experiment_name=f"port_{resident}", wav_buckets=BUCKETS, shared=shared,
        resident=resident, device="cpu", step_draws=lambda e, s: draws[(e, s)])
    assert (t._resident is not None) == resident
    jt, jout = run["jt"], run["jout"]
    np.testing.assert_allclose(t.anchors.numpy(), np.asarray(jt.anchors), **METRIC_TOL)
    out = t.train()

    history = _json(os.path.join(_reports(t), "training_history.json"))
    jhistory = _json(os.path.join(_reports(jt), "training_history.json"))
    assert sorted(history) == sorted(jhistory)
    for k, v in jhistory.items():
        if k.startswith("disagreement_rate"):
            assert history[k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(history[k]), np.asarray(v), **METRIC_TOL,
                                       err_msg=k)
    assert len(history["total_loss"]) == 3 and len(history["dacp_ema_thresholds"]) == 2
    assert max(history["consistency_loss"][1:]) > 0 and max(history["ecda_loss"][1:]) > 0
    assert history["supervised_ce_loss"][2] < history["supervised_ce_loss"][0]

    assert t.best_results["epoch"] == jt.best_results["epoch"]
    assert out["best_noisy_weighted_acc"] == jout["best_noisy_weighted_acc"]
    for domain in ("clean_test", "noisy_test"):
        for k, v in jout[domain].items():
            np.testing.assert_array_equal(np.asarray(out[domain][k]), np.asarray(v),
                                          err_msg=f"{domain} {k}")
    best, jbest = (load_torch_file(os.path.join(x.results_dir, "models",
                                                "emodb_cross_domain_best.pth")) for x in (t, jt))
    assert sorted(best) == sorted(jbest)
    for k, v in jbest.items():
        torch.testing.assert_close(best[k], v, **STATE_TOL, msg=k)
    assert t.results_dir.split(os.sep)[-4:] == jt.results_dir.split(os.sep)[-4:]


def test_resident_scanned_equals_per_step_and_auto_falls_back(run):
    """The chunked resident runner equals a loop of resident steps at the
    chunk-common buckets from one generator seed; "auto" streams under a
    tiny budget and still trains."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
        StepScalars,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.resident import (
        paired_index_epoch,
    )

    cfg = run["cfg"]
    t = FusedCrossDomainTrainer(cfg, run["corpus"], PORT_ENC, None, fused_cfg=run["fused"],
                                experiment_name="scan", wav_buckets=(4000, 8000),
                                shared=run["shared"], resident=True, scan_chunk=3,
                                device="cpu")
    pairs = list(paired_index_epoch(t.clean_train, t.noisy_wav_train, 1))[:3]
    t_c, t_w = max(tc for (_i, tc), _ in pairs), max(tw for _, (_i, tw) in pairs)
    assert len({tw for _, (_i, tw) in pairs}) > 1 or t_w == 8000
    scalars = StepScalars.for_epoch(cfg, 1)
    clean_c, wav_c = t._resident
    step = fused_trainer.make_resident_fused_step(t.encoder, t.head, t.tx, t.fused_cfg)
    g = torch.Generator().manual_seed(3)
    s_loop, loop = t.state, []
    for (ci, _), (wi, _) in pairs:
        s_loop, m = step(s_loop, clean_c, wav_c, torch.from_numpy(ci), torch.from_numpy(wi),
                         scalars, t.anchors, g, t_clean=t_c, t_wav=t_w,
                         frame_cap=t.clean_train.max_frames)
        loop.append(float(m["total_loss"]))
    s_scan, m = t._resident_runner(
        t.state, clean_c, wav_c, torch.from_numpy(np.stack([c for (c, _), _ in pairs])),
        torch.from_numpy(np.stack([w for _, (w, _) in pairs])), scalars, t.anchors,
        torch.Generator().manual_seed(3), t_clean=t_c, t_wav=t_w,
        frame_cap=t.clean_train.max_frames)
    assert m["total_loss"].tolist() == loop
    assert m["tracking"]["ids"].shape == (3, 8)
    for k, v in s_loop.ssrl.student.items():
        assert torch.equal(s_scan.ssrl.student[k], v), k
    avg = t.train_epoch(0)  # trailing short chunk included
    assert np.isfinite(avg["total_loss"])

    auto = FusedCrossDomainTrainer(cfg, run["corpus"], PORT_ENC, None, fused_cfg=run["fused"],
                                   experiment_name="auto", wav_buckets=BUCKETS,
                                   shared=run["shared"], resident="auto",
                                   resident_max_bytes=16, prefetch_depth=0, device="cpu")
    assert auto._resident is None
    assert np.isfinite(auto.train_epoch(0)["total_loss"])


def test_bank_mode_trains_and_its_bank_matches_jax(run, tmp_path):
    """Root2 (a random NOISEX type per clip) at two SNRs: the bank on the
    device is the JAX package's, the results directory is named as the
    JAX package names it, and a run trains with finite losses."""
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio.noise import (
        load_noise_bank,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train.fused_trainer import (
        injection_display_name as jax_display_name,
    )

    noise_root = _make_noise_root(tmp_path)
    cfg = replace(run["cfg"], epochs=1, results_base_dir=str(tmp_path / "results"))
    fused = FusedConfig(encoder=PORT_ENC, dad=cfg, inject_snr_choices=(5.0, 15.0),
                        inject_noise_bank_mode="random")
    shared = refresh_noisy_domain(run["shared"], fused, noise_root)
    assert shared["clean_store"] is run["shared"]["clean_store"]
    t = FusedCrossDomainTrainer(cfg, run["corpus"], PORT_ENC, None, fused_cfg=fused,
                                noise_root=noise_root, wav_buckets=BUCKETS, shared=shared,
                                device="cpu")
    jfused = JaxFusedConfig(encoder=TINY_ENC, dad=run["jcfg"], inject_snr_choices=(5.0, 15.0),
                            inject_noise_bank_mode="random")
    assert t.cfg.noisy_data_dir == jax_display_name(jfused) == "fused/root2-multi_5_15db"
    np.testing.assert_array_equal(t._noise_bank.numpy(), load_noise_bank(noise_root, 8000))
    out = t.train()
    hist = _json(os.path.join(_reports(t), "training_history.json"))
    assert len(hist["total_loss"]) == 1 and np.isfinite(hist["total_loss"]).all()
    assert 0 <= out["best_noisy_weighted_acc"] <= 100
