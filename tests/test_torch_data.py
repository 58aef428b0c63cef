"""The port's host data plumbing against the JAX package's, on the same
seeded numpy inputs: feature stores (files and arrays), fold splits,
bucketed batches (the port's iterator, and the port's native batcher on the
same clips, each against the JAX package's numpy path, which builds
nothing) and the prefetch pipeline.

Everything here is exact: stores, splits and batches are compared bit for
bit, the bf16 transfer round trip too.
"""

import threading
import time

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    batching as jax_batching,
    folds as jax_folds,
    store as jax_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.prefetch import (
    prefetch as jax_prefetch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    batching,
    folds,
    store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.prefetch import (
    prefetch,
    tree_map,
)

from torch_parity import native_batches

IEMOCAP = ["ang", "hap", "neu", "sad"]
LM = {k: i for i, k in enumerate(IEMOCAP)}
SIDECAR_FILES = {"emo": ("train.npy", "train.lengths", "train.emo"),
                 "lbl": ("train.npy", "train.lengths", "train.lbl", "train.spk")}


def _clips(rng, n, dim=6, lo=3, hi=150):
    """Clip lengths from a lognormal tail, so batches span several buckets."""
    lengths = np.clip(rng.lognormal(np.log(20), 0.8, n).astype(int), lo, hi)
    return [rng.normal(size=(int(t), dim)).astype(np.float32) for t in lengths]


def _corpus(rng, n=47, sidecar="emo"):
    clips = _clips(rng, n)
    labels = [IEMOCAP[i % 4] for i in range(n)]
    if sidecar == "emo":
        names = [f"Ses0{i % 5 + 1}{'FM'[i % 2]}_impro0{i % 7}_F{i:03d}" for i in range(n)]
        return dict(clips=clips, labels=labels, utt_names=names, sidecar="emo")
    speakers = [f"spk{i % 4}" for i in range(n)]
    return dict(clips=clips, labels=labels, speakers=speakers, sidecar="lbl")


def _assert_stores_equal(a, b):
    for f in ("feats", "sizes", "offsets", "labels", "groups"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert x.dtype == y.dtype, f
    assert a.label_names == b.label_names and a.utt_names == b.utt_names


@pytest.mark.parametrize("sidecar", ["emo", "lbl"])
def test_stores_cross_load_with_identical_files(tmp_path, rng, sidecar):
    corpus = _corpus(rng, sidecar=sidecar)
    jax_store.write_feature_store(str(tmp_path / "jax"), **corpus)
    store.write_feature_store(str(tmp_path / "port"), **corpus)
    for name in SIDECAR_FILES[sidecar]:
        with open(tmp_path / "jax" / name, "rb") as f, open(tmp_path / "port" / name, "rb") as g:
            assert f.read() == g.read(), name
    for d in ("jax", "port"):
        for kw in ({}, dict(min_length=10, max_length=80)):
            _assert_stores_equal(store.load_feature_store(str(tmp_path / d), LM, **kw),
                                 jax_store.load_feature_store(str(tmp_path / d), LM, **kw))
    assert (store.read_label_sidecars(str(tmp_path / "port"))
            == jax_store.read_label_sidecars(str(tmp_path / "jax")))
    sub = store.load_feature_store(str(tmp_path / "port"), LM).subset([5, 1, 9])
    jsub = jax_store.load_feature_store(str(tmp_path / "jax"), LM).subset([5, 1, 9])
    _assert_stores_equal(sub, jsub)
    assert sub.validate() and jsub.validate()


def test_corrupt_store_is_refused_as_by_jax(tmp_path, rng):
    corpus = _corpus(rng)
    store.write_feature_store(str(tmp_path), **corpus)
    with open(tmp_path / "train.lengths", "a") as f:
        print(3, file=f)
    for load in (store.load_feature_store, jax_store.load_feature_store):
        with pytest.raises(ValueError, match="corrupt feature store"):
            load(str(tmp_path), LM)


@pytest.mark.parametrize("corpus", ["iemocap", "casia", "emodb"])
def test_corpus_fold_split_matches_jax_for_every_fold(rng, corpus):
    if corpus == "iemocap":
        groups, n_folds = rng.integers(1, 6, 90), 5
    elif corpus == "casia":
        groups, n_folds = rng.choice(["liuchanhg", "wangzhe", "zhaoquanyin", "ZhaoZuoxiang"], 90), 4
    else:
        groups, n_folds = np.array([f"emodb_spk_{s}" for s in rng.choice(folds.EMODB_SPEAKERS, 90)]), 10
    for fold in range(n_folds):
        got = folds.corpus_fold_split(corpus, fold, groups)
        want = jax_folds.corpus_fold_split(corpus, fold, groups)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert sum(len(g) for g in got) > 0


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in batching.Batch._fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
            assert getattr(g, f).dtype == getattr(w, f).dtype, f


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("shuffle,bucket_shuffle,max_frames",
                         [(False, False, None), (True, False, None), (True, True, None),
                          (True, False, 70)])
def test_batches_bit_equal_to_jax_over_three_epochs(tmp_path, rng, native, shuffle,
                                                    bucket_shuffle, max_frames):
    store.write_feature_store(str(tmp_path), **_corpus(rng, n=61))
    port_store = store.load_feature_store(str(tmp_path), LM)
    jax_st = jax_store.load_feature_store(str(tmp_path), LM)
    kw = dict(buckets=(16, 32, 64), shuffle=shuffle, seed=5, max_frames=max_frames,
              bucket_shuffle=bucket_shuffle)
    it = batching.PaddedBatchIterator(port_store, 8, **kw)
    jit = jax_batching.PaddedBatchIterator(jax_st, 8, use_native=False, **kw)
    assert jit._native is None
    assert len(it) == len(jit) == 8
    shapes = set()
    for epoch in range(3):
        it.set_epoch(epoch)
        jit.set_epoch(epoch)
        want = list(jit)
        got = native_batches(port_store, want, max_frames) if native else list(it)
        _assert_batches_equal(got, want)
        shapes |= {b.feats.shape[1] for b in got}
    assert len(shapes) > 1  # the lengths reach several buckets
    for b in (16, 17, 64, 65, 200):
        assert batching.pad_to_bucket(b, (16, 32, 64)) == jax_batching.pad_to_bucket(b, (16, 32, 64))


def test_paired_epoch_matches_jax(tmp_path, rng):
    store.write_feature_store(str(tmp_path / "c"), **_corpus(rng, n=40))
    store.write_feature_store(str(tmp_path / "n"), **_corpus(rng, n=33))

    def iters(mod, st):
        c = st.load_feature_store(str(tmp_path / "c"), LM)
        n = st.load_feature_store(str(tmp_path / "n"), LM)
        return (mod.PaddedBatchIterator(c, 8, (16, 32, 64), shuffle=True, seed=3),
                mod.PaddedBatchIterator(n, 8, (16, 32, 64), shuffle=True, seed=3 + 7919))

    port, jax_its = iters(batching, store), iters(jax_batching, jax_store)
    for epoch in range(3):
        got = list(batching.paired_epoch(*port, epoch))
        want = list(jax_batching.paired_epoch(*jax_its, epoch))
        assert len(got) == 5  # truncated to the shorter stream
        for (gc, gn), (wc, wn) in zip(got, want):
            _assert_batches_equal([gc, gn], [wc, wn])


# ---------------------------------------------------------------------------
# prefetch


def test_prefetch_preserves_order_and_values():
    items = [np.full((3,), i) for i in range(20)]
    for depth in (0, 3):
        got = list(prefetch(iter(items), depth=depth))
        assert len(got) == 20
        for i, g in enumerate(got):
            np.testing.assert_array_equal(g, items[i])


def test_prefetch_depth_zero_is_synchronous_and_still_transfers():
    seen = []

    def gen():
        for i in range(4):
            seen.append(i)
            yield batching.Batch(np.full((2, 3, 4), i, np.float32), np.zeros((2, 3), bool),
                                 np.zeros(2, np.int32), None, np.ones(2, bool))

    it = prefetch(gen(), depth=0, to_device=True, device="cpu")
    first = next(it)
    assert seen == [0]  # nothing assembled ahead
    assert isinstance(first.feats, torch.Tensor) and first.ids is None
    assert torch.equal(first.feats, torch.zeros(2, 3, 4))
    assert [int(b.feats[0, 0, 0]) for b in it] == [1, 2, 3]


def test_prefetch_propagates_worker_exception():
    def bad():
        yield np.zeros(2)
        raise RuntimeError("boom")

    for depth in (0, 2):
        it = prefetch(bad(), depth=depth)
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)


def test_prefetch_worker_stops_when_abandoned():
    produced = []

    def slow():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(slow(), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n and n < 10
    assert not any(t.name == "dad-torch-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_transfer_round_trip_equals_jax_bf16(rng):
    x = (rng.normal(size=(4, 33, 7)) * 3).astype(np.float32)
    x[0, 0, :3] = [1.0 + 2**-8, 1.0 + 3 * 2**-9, -65504.5]  # ties and rounding
    item = {"feats": x, "mask": np.zeros((4, 33), bool), "n": 7}
    (want,) = list(jax_prefetch([item], depth=0, transfer_fp32_as="bfloat16"))
    for depth in (0, 2):
        (got,) = list(prefetch([item], depth=depth, transfer_fp32_as="bfloat16", device="cpu"))
        assert got["feats"].dtype == torch.float32 and got["mask"].dtype == torch.bool
        assert got["n"] == 7
        np.testing.assert_array_equal(got["feats"].numpy(), np.asarray(want["feats"]))
        assert not np.array_equal(got["feats"].numpy(), x)  # it did round
    with pytest.raises(ValueError, match="not a float dtype"):
        next(prefetch([item], depth=0, transfer_fp32_as="int8", device="cpu"))


def test_prefetch_to_the_gpu_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(prefetch([np.zeros(2)], depth=2, to_device=True))


def test_tree_map_keeps_structure():
    b = batching.Batch(np.zeros(1), np.ones(1), [np.zeros(2), 3], None, {"a": np.ones(1)})
    out = tree_map(lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, b)
    assert isinstance(out, batching.Batch) and out.ids is None
    assert isinstance(out.labels, list) and out.labels[1] == 3
    assert isinstance(out.row_valid["a"], torch.Tensor)
