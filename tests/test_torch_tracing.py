"""The port's span recorder (``utils/profiling.py``) and the spans the
serving path and the d2v step record into it, on the CPU: every request
spanned and its batch named, children inside their parents, the ring
bounded, and no torch call made by the recorder."""

import base64
import json
import math
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio.wavio import (
    write_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
    PredictionServer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    d2v_pretrain as td2v,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (
    profiling,
)

from test_torch_serving import _wavs, pair  # noqa: F401 — the module's fixture
from torch_parity import d2v_cfgs, one_torch_thread  # noqa: F401 — an autouse fixture

B = 4  # the pair's batch size


def since(t0, names=None):
    """The process recorder's spans that began at or after ``t0``."""
    return [s for s in profiling.spans(t0) if s.start >= t0 and (names is None or s.name in names)]


def inside(spans, outer):
    """The spans that lie within ``outer``."""
    return [s for s in spans if outer.start <= s.start and s.end <= outer.end]


def assert_one_each_inside(spans, batches):
    """Each batch holds one assembly and one results span, and each
    assembly lies in a batch."""
    for b in batches:
        assert sorted(s.name for s in inside(spans, b)
                      if s.name in ("serving.assemble", "serving.results")) == [
            "serving.assemble", "serving.results"]
    for s in spans:
        if s.name == "serving.assemble":
            assert len([b for b in batches if b.start <= s.start and s.end <= b.end]) == 1


def _post(base, payload):
    req = urllib.request.Request(base + "/predict", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.getcode(), json.loads(r.read())


def test_server_spans_name_every_request_and_its_batch(pair):  # noqa: F811
    _jp, tp = pair["int16"]
    t0 = time.monotonic()
    server = PredictionServer(tp, port=0, max_wait_ms=20.0)
    server.start()
    try:
        base = f"http://{server.host}:{server.port}"
        clips = _wavs(4)
        bodies = [{"wav": c.astype(np.float32).tolist()} for c in clips[:4]]
        bodies.append({"pcm16": base64.b64encode(clips[4].astype("<i2").tobytes()).decode()})
        bodies += [{"features": np.ones((t, 16), np.float32).tolist()} for t in (9, 20)]
        codes = [None] * len(bodies)

        def worker(i):
            codes[i] = _post(base, bodies[i])[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert codes == [200] * len(bodies)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"nonsense": 1})
        e.value.close()
        n = len(bodies) + 1
        deadline = time.monotonic() + 10  # a handler closes its span after the reply
        while len(since(t0, {"serving.request"})) < n and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        server.shutdown()
    assert not server._dispatcher.is_alive()

    spans = since(t0)
    requests = [s for s in spans if s.name == "serving.request"]
    queued = [s for s in spans if s.name == "serving.queue"]
    batches = {s.attrs["batch"]: s for s in spans if s.name == "serving.batch"}
    assert len(requests) == n
    # every accepted request waited in the queue once, inside its request
    assert len(queued) == len(bodies)
    # each queue span names a batch, and the batches hold exactly the requests
    named = [s.attrs["batch"] for s in queued]
    assert set(named) == set(batches)
    assert all(named.count(b) <= B for b in batches)
    for s in queued:
        batch = batches[s.attrs["batch"]]
        assert s.start <= s.end <= batch.start
        assert any(r.start <= s.start and batch.end <= r.end for r in requests)
    assert all(b.attrs == {"batch": bid} for bid, b in batches.items())
    assert_one_each_inside(spans, list(batches.values()))
    collects = [s for s in spans if s.name == "serving.collect"]
    assert collects and all(c.end <= min(b.start for b in batches.values()
                                         if b.start >= c.start) for c in collects)


@pytest.mark.parametrize("kind", ["wavs", "features"])
def test_predictor_batch_spans_carry_their_shapes(pair, kind):  # noqa: F811
    _jp, tp = pair["float32"]
    rng = np.random.default_rng(7)
    if kind == "wavs":
        clips, predict = _wavs(5), tp.predict_wavs
    else:
        clips = [rng.normal(size=(t, 16)).astype(np.float32) for t in (5, 30, 12, 40, 7)]
        predict = tp.predict_features
    t0 = time.monotonic()
    predict(clips)
    batches = since(t0, {"serving.batch"})
    assert len(batches) == math.ceil(len(clips) / B)
    by_id = {s.attrs["batch"]: s for s in batches}
    of = tp.last_batch_ids()
    assert len(of) == len(clips) and set(of) == set(by_id)
    # the clips go to batches in order of length, B at a time
    by_len = sorted(range(len(clips)), key=lambda i: len(clips[i]))
    assert [of[i] for i in by_len] == [sorted(by_id)[k // B] for k in range(len(clips))]
    assert all(s.attrs == {"batch": bid} for bid, s in by_id.items())
    assert_one_each_inside(since(t0), batches)


LENS = (2000, 2400, 2800, 3000)
RUN = dict(crop_size=1500, min_sample_size=1000, batch_size=2, max_steps=4, warmup_steps=1,
           clone_batch=2)


@pytest.mark.parametrize("mode", ["step", "resident"])
def test_d2v_step_spans_hold_one_loss_and_one_update(tmp_path, mode):
    rng = np.random.default_rng(0)
    man = tmp_path / "corpus"
    os.makedirs(man / "wavs")
    for i, n in enumerate(LENS):
        write_wav(str(man / "wavs" / f"clip{i}.wav"), rng.normal(size=n) * 0.1, 16000)
    (man / "train.tsv").write_text(
        str(man / "wavs") + "\n" + "".join(f"clip{i}.wav\t{n}\n" for i, n in enumerate(LENS)))
    _jc, _jp, cfg, pcfg = d2v_cfgs(**RUN)
    t0 = time.monotonic()
    td2v.run_d2v_pretrain(cfg, pcfg, [str(man)], str(tmp_path / "out"), log_every=2,
                          checkpoint_every=100, resident=mode == "resident", device="cpu")
    spans = since(t0, {"d2v_pretrain.loss", "d2v_pretrain.update"})
    # a loss then its update, once a step, in turn
    assert [s.name for s in sorted(spans, key=lambda s: s.start)] == [
        "d2v_pretrain.loss", "d2v_pretrain.update"] * RUN["max_steps"]
    ordered = sorted(spans, key=lambda s: s.start)
    assert all(a.end <= b.start for a, b in zip(ordered, ordered[1:]))
    assert all(s.attrs == {} for s in spans)


def test_ring_is_bounded_and_counts_drops():
    rec = profiling.Recorder(capacity=4)
    for i in range(10):
        rec.add_span(f"s{i}", float(i), i + 0.5, i=i)
    kept = rec.spans()
    assert [s.name for s in kept] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    assert [s.attrs for s in rec.spans(7.2, 8.1)] == [{"i": 7}, {"i": 8}]
    # the newest dropped span ended at 5.5: stretches from 5.6 on are whole
    assert not rec.intact_since(5.5) and rec.intact_since(5.6)
    assert profiling.Recorder().intact_since(-1e300)


def test_recorder_calls_no_torch(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the recorder called torch")

    rec = profiling.Recorder()
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    with rec.span("outer", n=1):
        with rec.span("inner"):
            rec.add_span("handed", 0.0, 1.0, k=2)
    got = rec.spans()
    assert [s.name for s in got] == ["handed", "inner", "outer"]
    handed, inner, outer = got
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert outer.attrs == {"n": 1} and handed.attrs == {"k": 2} and inner.attrs == {}
    assert (handed.start, handed.end) == (0.0, 1.0)
    assert rec.dropped == 0


def test_a_block_that_raises_is_still_recorded():
    rec = profiling.Recorder()
    with pytest.raises(KeyError):
        with rec.span("fails", k=1):
            raise KeyError("x")
    (s,) = rec.spans()
    assert s.name == "fails" and s.attrs == {"k": 1} and s.start <= s.end


def test_threads_lose_no_span_or_count():
    rec = profiling.Recorder(capacity=1000)
    n_threads, per = (os.cpu_count() or 4) * 2, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with rec.span("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * per
    kept = rec.spans()
    assert len(kept) == 1000 and rec.dropped == total - 1000
    assert all(s.name == "s" and s.start <= s.end and s.attrs == {} for s in kept)
