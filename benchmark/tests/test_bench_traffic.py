"""Traffic and corpora: the same from one seed, the same work (multiset of
lengths and gaps) from every seed, in another order."""

import numpy as np
import pytest

from benchmark.lib import corpus

LENGTHS = {"mean_s": 4.5, "sigma": 0.6, "min_s": 0.6, "max_s": 30.0}


def test_serve_schedule_is_deterministic_by_seed():
    a = corpus.serve_schedule(2**31 + 17, 140.0, 30.0, LENGTHS)
    b = corpus.serve_schedule(2**31 + 17, 140.0, 30.0, LENGTHS)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(corpus.serve_audio(5), corpus.serve_audio(5))


def test_every_seed_asks_the_same_work_in_another_order():
    a = corpus.serve_schedule(1, 140.0, 30.0, LENGTHS)
    b = corpus.serve_schedule(2, 140.0, 30.0, LENGTHS)
    assert len(a["lengths"]) == 4200
    np.testing.assert_array_equal(np.sort(a["lengths"]), np.sort(b["lengths"]))
    # the gaps are one set of exponential quantiles (the last gap of each
    # order falls after the window)
    da, db = (np.sort(np.diff(s["arrivals"])) for s in (a, b))
    i = np.clip(np.searchsorted(db, da), 1, len(db) - 1)
    near = np.minimum(np.abs(da - db[i - 1]), np.abs(da - db[i])) < 1e-9
    assert near.sum() >= len(da) - 1
    assert not np.array_equal(a["lengths"], b["lengths"])


def test_serve_schedule_shapes():
    s = corpus.serve_schedule(3, 140.0, 30.0, LENGTHS)
    assert s["arrivals"][0] == 0.0 and np.all(np.diff(s["arrivals"]) > 0)
    assert s["arrivals"][-1] < 30.0
    assert s["lengths"].min() >= 0.6 * 16000 and s["lengths"].max() == 30 * 16000
    # the mean of a lognormal with mean 4.5 s, its top clipped at 30 s
    assert 4.3 < s["lengths"].mean() / 16000 < 4.6
    assert np.all(s["offsets"] + s["lengths"] <= corpus.BASE_SECONDS * 16000)
    # open loop at the offered rate: the gaps average 1 / rate
    assert np.diff(s["arrivals"]).mean() == pytest.approx(1 / 140.0, rel=0.05)


def test_d2v_corpus_and_crops():
    spec = {"clips": 4290, "mean_s": 4.5, "sigma": 0.6, "min_s": 0.6, "max_s": 30.0,
            "min_samples": 32000}
    sizes = corpus.d2v_lengths(11, spec)
    assert sizes.min() >= 32000 and 3000 < len(sizes) < 4290
    np.testing.assert_array_equal(np.sort(sizes), np.sort(corpus.d2v_lengths(12, spec)))
    it1, it2 = corpus.crop_batches(11, sizes, 16, 160000, 128), corpus.crop_batches(11, sizes, 16, 160000, 128)
    for _ in range(3):
        (i1, s1), (i2, s2) = next(it1), next(it2)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(s1, s2)
        assert np.all(s1 % 128 == 0)
        assert np.all((s1 == 0) | (sizes[i1] > 160000))
        assert np.all(s1 + np.minimum(160000, sizes[i1] - s1) <= sizes[i1])
