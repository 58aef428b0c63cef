"""The device-resident corpus (``parallel/resident.py``) against the host
batches and the JAX package: the index projection of an epoch, the
gathers (bit for bit with the host-assembled batches: zero fill, True =
pad, -1 labels and ids on padded rows, the frame cap, subset views, bf16
storage of bf16 values), the one-copy materialisers, and the resident
feature trainer against the streamed one and the JAX resident trainer
over 3 epochs at ``tests/test_torch_trainer.py``'s METRIC_TOL / STATE_TOL
(the port fed the JAX trainer's draws, as there)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    PaddedBatchIterator as JaxPaddedBatchIterator,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.store import (
    FeatureStore as JaxFeatureStore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel import (
    resident as jax_resident,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    CrossDomainTrainer as JaxTrainer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    FeatureStore,
    PaddedBatchIterator,
    PaddedWavIterator,
    WavStore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.batching import (
    paired_epoch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    load_torch_file,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    resident,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel.resident import (
    _gather_fused_pair,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    CrossDomainTrainer,
)

from test_torch_trainer import (
    METRIC_TOL,
    OVERRIDES,
    STATE_TOL,
    _assert_bias_logs_close,
    _assert_history_close,
    _cfg_kw,
    _json,
    _reports,
    _write_pretrain,
    _write_stores,
)
from torch_parity import jax_trainer_draws


def _feature_store(rng, n=30, dim=4, cls=JaxFeatureStore):
    sizes = rng.integers(3, 40, n).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    feats = rng.normal(size=(int(sizes.sum()), dim)).astype(np.float32)
    return cls(feats=feats, sizes=sizes, offsets=offsets,
               labels=rng.integers(0, 4, n).astype(np.int32))


def _wav_store(rng, n=21):
    sizes = rng.integers(500, 9000, n).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return WavStore(samples=rng.normal(size=int(sizes.sum())).astype(np.float32), sizes=sizes,
                    offsets=offsets, labels=rng.integers(0, 4, n).astype(np.int32))


def _port(store):
    return FeatureStore(feats=store.feats, sizes=store.sizes, offsets=store.offsets,
                        labels=store.labels)


@pytest.mark.parametrize("bucket_shuffle", [False, True])
def test_index_batches_match_jax_and_the_iterators(rng, bucket_shuffle):
    wavs = _wav_store(rng)
    js = _feature_store(rng)
    kw = dict(shuffle=True, seed=5, bucket_shuffle=bucket_shuffle)
    iters = [
        (PaddedWavIterator(wavs, 4, buckets=(2000, 4000, 8000, 16000), **kw),
         lambda b: (b.ids, b.wav.shape[1])),
        (PaddedWavIterator(wavs, 4, buckets=(2000, 4000, 8000, 16000), shuffle=False),
         lambda b: (b.ids, b.wav.shape[1])),
        (PaddedBatchIterator(_port(js), 7, buckets=(8, 16, 32, 64), max_frames=20, **kw),
         lambda b: (b.ids, b.feats.shape[1])),
    ]
    jit = JaxPaddedBatchIterator(js, 7, buckets=(8, 16, 32, 64), max_frames=20, **kw)
    for it, key in iters:
        for epoch in (0, 2):
            got = list(resident.index_batches(it, epoch))
            it.set_epoch(epoch)
            want = [key(b) for b in it]
            assert len(got) == len(want) == len(it)
            for (idx, T), (ids, wT) in zip(got, want):
                np.testing.assert_array_equal(idx, ids)
                assert idx.dtype == np.int32 and T == wT
    for epoch in (0, 1):
        got, want = (list(m.index_batches(i, epoch)) for m, i in
                     ((resident, iters[2][0]), (jax_resident, jit)))
        for (a, ta), (b, tb) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert ta == tb
    clean = PaddedBatchIterator(_port(js), 7, buckets=(8, 16, 32, 64), **kw)
    noisy = PaddedWavIterator(wavs, 4, buckets=(2000, 4000, 8000, 16000), **kw)
    pairs = list(resident.paired_index_epoch(clean, noisy, 1))
    want = list(paired_epoch(clean, noisy, 1))
    assert len(pairs) == len(want) == min(len(clean), len(noisy))
    for ((ci, tc), (ni, tn)), (cb, nb) in zip(pairs, want):
        np.testing.assert_array_equal(ci, cb.ids)
        np.testing.assert_array_equal(ni, nb.ids)
        assert (tc, tn) == (cb.feats.shape[1], nb.wav.shape[1])


@pytest.mark.parametrize("view", ["whole", "subset"])
def test_gathers_equal_the_host_batches(rng, view):
    wavs = _wav_store(rng)
    feats = _port(_feature_store(rng))
    if view == "subset":
        wavs, feats = wavs.subset([5, 2, 17, 9, 11, 0, 3]), feats.subset(
            [22, 4, 9, 1, 28, 13, 6, 17, 2])
    wav_c = resident.resident_from_store(wavs, "cpu", labeled=False)
    feat_c = resident.resident_from_store(feats, "cpu")
    assert wav_c.flat.shape[0] == int(wavs.sizes.sum()) == resident.resident_nbytes(wavs) // 4
    assert (wav_c.labels == -1).all()

    wit = PaddedWavIterator(wavs, 4, buckets=(2000, 4000, 8000), shuffle=True, seed=2,
                            labeled=False)
    fit = PaddedBatchIterator(feats, 4, buckets=(8, 16, 32, 64), shuffle=True, seed=3,
                              max_frames=20)
    for epoch in (0, 1):
        for (idx, T), b in zip(list(resident.index_batches(wit, epoch)), list(wit)):
            wav, mask = resident.gather_clips(wav_c, torch.from_numpy(idx), T)
            assert torch.equal(wav, torch.from_numpy(b.wav))
            assert torch.equal(mask, torch.from_numpy(b.wav_mask))
        for (idx, T), b in zip(list(resident.index_batches(fit, epoch)), list(fit)):
            got = resident.gather_feature_batch(feat_c, torch.from_numpy(idx), T, 20)
            for x, y in zip(got, b):
                assert x.dtype == torch.from_numpy(y).dtype
                assert torch.equal(x, torch.from_numpy(y))

    # the fused pair: clean features (bf16 storage of bf16 values) + wavs
    bf = FeatureStore(feats=torch.from_numpy(feats.feats).bfloat16().float().numpy(),
                      sizes=feats.sizes, offsets=feats.offsets, labels=feats.labels)
    bf_c = resident.resident_from_store(bf, "cpu", dtype="bfloat16")
    assert bf_c.flat.dtype == torch.bfloat16
    assert resident.resident_nbytes(bf, "bfloat16") == bf_c.flat.nbytes
    cit = PaddedBatchIterator(bf, 4, buckets=(8, 16, 32, 64), shuffle=True, seed=4)
    for ((ci, tc), (wi, tw)), (cb, wb) in zip(list(resident.paired_index_epoch(cit, wit, 0)),
                                              list(paired_epoch(cit, wit, 0))):
        clean, noisy = _gather_fused_pair(bf_c, wav_c, torch.from_numpy(ci),
                                          torch.from_numpy(wi), tc, tw, None)
        for x, y in ((clean.feats, cb.feats), (clean.frame_mask, cb.padding_mask),
                     (clean.labels, cb.labels), (clean.row_valid, cb.row_valid),
                     (noisy.wav, wb.wav), (noisy.wav_mask, wb.wav_mask),
                     (noisy.labels, wb.labels), (noisy.row_valid, wb.row_valid),
                     (noisy.ids, wb.ids)):
            assert torch.equal(x, torch.from_numpy(y))


def test_gathers_match_jax(rng):
    js = _feature_store(rng)
    c, jc = resident.resident_from_store(_port(js), "cpu"), jax_resident.resident_from_store(js)
    idx = np.array([3, -1, 17, 0, 29, -1], np.int32)
    for t, cap in ((32, None), (64, 20), (16, 20)):
        got = resident.gather_feature_batch(c, torch.from_numpy(idx), t, cap)
        want = jax_resident.gather_feature_batch(jc, jnp.asarray(idx), t, cap)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_materialize_helpers_keep_order():
    per_step = [{"a": torch.tensor(float(i)), "b": torch.tensor(10.0 * i, dtype=torch.float64)}
                for i in range(5)]
    rows = resident.materialize_metrics(per_step, ("b", "a"))
    assert rows.dtype == np.float32 and rows.tolist() == [[10.0 * i, i] for i in range(5)]
    assert resident.materialize_metrics([], ("a",)).shape == (0, 1)
    tracked = [{"ids": torch.arange(3) + 3 * i, "s": torch.full((3,), float(i))}
               for i in range(4)]
    host = resident.materialize_tracking(tracked)
    assert [h["ids"].tolist() for h in host] == [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(4)]
    assert [float(h["s"][0]) for h in host] == [0.0, 1.0, 2.0, 3.0]
    assert resident.materialize_tracking([]) == []


def test_resident_feature_trainer_matches_streamed_and_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path))
    ckpt = _write_pretrain(str(tmp_path / "pm.ckpt"), hidden=8)
    kw = _cfg_kw(tmp_path, clean, noisy, dropout_rate=0.0, pretrained_weight=ckpt)
    jcfg, cfg = jax_dad_preset("iemocap", OVERRIDES, **kw), dad_preset("iemocap", OVERRIDES, **kw)
    jt = JaxTrainer(jcfg, fold=0, experiment_name="jax", resident=True)
    assert jt._resident is not None
    jout = jt.train()
    draws = jax_trainer_draws(jt, jcfg)
    runs = {}
    for name, res in (("streamed", False), ("resident", True)):
        t = CrossDomainTrainer(cfg, fold=0, experiment_name=name, device="cpu", resident=res,
                               step_draws=lambda e, s: draws[(e, s)])
        assert (t._resident is not None) == res
        runs[name] = (t, t.train())
    t, out = runs["resident"]
    history = _json(os.path.join(_reports(t), "training_history.json"))
    _assert_history_close(history, _json(os.path.join(_reports(jt), "training_history.json")))
    assert max(history["consistency_loss"][1:]) > 0 and max(history["ecda_loss"][1:]) > 0
    _assert_bias_logs_close(_json(os.path.join(_reports(t), "confirmation_bias_log.json")),
                            _json(os.path.join(_reports(jt), "confirmation_bias_log.json")))
    assert t.best_results["epoch"] == jt.best_results["epoch"]
    assert out["best_noisy_weighted_acc"] == jout["best_noisy_weighted_acc"]
    best, jbest = (load_torch_file(os.path.join(x.results_dir, "models",
                                                "iemocap_cross_domain_best.pth")) for x in (t, jt))
    for k, v in jbest.items():
        torch.testing.assert_close(best[k], v, **STATE_TOL, msg=k)
    # resident and streamed: the same batches and draws, the same numbers
    s, _ = runs["streamed"]
    for name in ("training_history.json", "confirmation_bias_log.json"):
        assert _json(os.path.join(_reports(s), name)) == _json(os.path.join(_reports(t), name))
    for k, v in s.state.ssrl.student.items():
        assert torch.equal(t.state.ssrl.student[k], v), k


def test_resident_auto_falls_back_to_streaming_over_its_budget(tmp_path, monkeypatch):
    """Several length buckets: "auto" streams under a tiny budget, and
    holds the stores when they fit."""
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path), seed=3, long_every=7)
    cfg = dad_preset("iemocap", OVERRIDES,
                     **_cfg_kw(tmp_path, clean, noisy, length_buckets=(16, 32, 64)))
    auto = CrossDomainTrainer(cfg, fold=0, experiment_name="auto", device="cpu",
                              resident="auto", resident_max_bytes=16)
    assert auto._resident is None
    assert np.isfinite(auto.train_epoch(0)["total_loss"])
    assert CrossDomainTrainer(cfg, fold=0, experiment_name="auto_fits", device="cpu",
                              resident="auto")._resident is not None
