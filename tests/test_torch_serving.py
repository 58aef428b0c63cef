"""The port's serving path end to end against the JAX package's:
FeatureExtractor -> EmotionPredictor -> PredictionServer at a tiny size on
the CPU, attention through the kernel path on both sides (Pallas in
interpret mode / the plain version)."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.eval.serving import (
    EmotionPredictor as JaxEmotionPredictor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.convert import (
    fairseq_to_flax_encoder,
    ssrl_to_torch_state_dict as jax_ssrl_to_torch_state_dict,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.extract import (
    FeatureExtractor as JaxFeatureExtractor,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import (
    init_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval.serving import (
    EmotionPredictor,
    PredictionServer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
    torch_state_dict_to_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
)

from torch_mirror import rand_sd
from torch_parity import F32_TOL, cfg_pair, port_cfg

WAV_BUCKETS = (200, 400)
FRAME_BUCKETS = (8, 32)
# class probabilities through encoder + head, f32 on both sides: the
# encoder's F32_TOL carried through pooling and a 4-way softmax
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX predictor, port predictor) over the same weights."""
    jcfg, tcfg = cfg_pair()
    sd = rand_sd(jcfg, seed=5)
    jax_dad = jax_dad_preset("iemocap", input_dim=jcfg.embed_dim, hidden_dim=8)
    _head, ssrl = init_ssrl(jax.random.PRNGKey(2), input_dim=jcfg.embed_dim, hidden_dim=8)
    ssrl_sd = {k: torch.from_numpy(np.array(v))
               for k, v in jax_ssrl_to_torch_state_dict(ssrl).items()}

    def make(i16):
        jp = JaxEmotionPredictor(
            jax_dad, ssrl,
            extractor=JaxFeatureExtractor(jcfg, fairseq_to_flax_encoder(sd, jcfg),
                                          batch_size=4, buckets=WAV_BUCKETS),
            batch_size=4, frame_buckets=FRAME_BUCKETS,
            wav_transfer_dtype="int16" if i16 else "float32")
        tp = EmotionPredictor(
            port_cfg(jax_dad), torch_state_dict_to_ssrl(ssrl_sd),
            extractor=FeatureExtractor(tcfg, fairseq_to_torch_encoder(sd, tcfg),
                                       batch_size=4, buckets=WAV_BUCKETS, device="cpu"),
            batch_size=4, frame_buckets=FRAME_BUCKETS,
            wav_transfer_dtype="int16" if i16 else "float32", device="cpu")
        return jp, tp

    return {"float32": make(False), "int16": make(True)}


def _wavs(seed=0):
    rng = np.random.default_rng(seed)
    # 5 clips -> two micro-batches of 4; lengths span both buckets, and the
    # int16 clip is accepted by both transfer modes
    clips = [rng.normal(size=n).astype(np.float32) * 0.3 for n in (150, 390, 60, 230)]
    clips.append((rng.normal(size=310) * 3000).astype(np.int16))
    return clips


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["label"] == w["label"] and g["label_id"] == w["label_id"]
        assert list(g["probs"]) == list(w["probs"])
        np.testing.assert_allclose(list(g["probs"].values()), list(w["probs"].values()),
                                   atol=PROB_ATOL)
        assert abs(sum(g["probs"].values()) - 1.0) < 1e-5


@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_predict_wavs_matches_jax(pair, transfer):
    jp, tp = pair[transfer]
    clips = _wavs()
    _assert_same(tp.predict_wavs(clips), jp.predict_wavs(clips))
    assert tp.batches_run == 2 and tp.requests_served == 5


def test_predict_features_matches_jax(pair):
    jp, tp = pair["float32"]
    rng = np.random.default_rng(3)
    clips = [rng.normal(size=(t, 16)).astype(np.float32) for t in (5, 30, 12, 40, 7)]
    _assert_same(tp.predict_features(clips), jp.predict_features(clips))


def test_extract_clips_matches_jax(pair):
    jp, tp = pair["float32"]
    clips = [c.astype(np.float32) for c in _wavs(1)[:4]]
    want = jp.extractor.extract_clips(clips)
    got = tp.extractor.extract_clips(clips)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **F32_TOL)


def test_warmup_runs_every_bucket_and_resets_counters(pair, monkeypatch):
    _jp, tp = pair["float32"]
    seen = []
    real = tp.extractor.forward_batch
    monkeypatch.setattr(tp.extractor, "forward_batch",
                        lambda wav, mask: seen.append(wav.shape[1]) or real(wav, mask))
    tp.warmup()
    assert seen == list(WAV_BUCKETS)
    assert tp.batches_run == 0 and tp.requests_served == 0


def _post(base, payload):
    req = urllib.request.Request(base + "/predict", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.getcode(), json.loads(r.read())


def test_http_server_end_to_end(pair):
    jp, tp = pair["int16"]
    server = PredictionServer(tp, port=0, max_wait_ms=20.0)
    server.start()
    try:
        base = f"http://{server.host}:{server.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["wav_input"]
        assert health["wav_transfer_dtype"] == "int16"

        clips = _wavs(2)
        bodies = [{"wav": c.astype(np.float32).tolist()} for c in clips[:4]]
        bodies.append({"pcm16": base64.b64encode(clips[4].astype("<i2").tobytes()).decode()})
        bodies.append({"features": np.ones((9, 16), np.float32).tolist()})
        results = [None] * len(bodies)

        def worker(i):
            results[i] = _post(base, bodies[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        want = jp.predict_wavs(
            [c if c.dtype == np.int16 else c.astype(np.float32) for c in clips])
        want.append(jp.predict_features([np.ones((9, 16), np.float32)])[0])
        for (code, out), w in zip(results, want):
            assert code == 200
            _assert_same([out], [w])

        for bad in ({"nonsense": 1}, {"features": [[1.0, 2.0]]}, {"wav": [[0.1]]},
                    {"pcm16": "!!!"}, {"wav": [0.0] * 500_000}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, bad)
            assert e.value.code == 400
            e.value.close()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["requests_served"] >= 6
    finally:
        server.shutdown()
    assert not server._dispatcher.is_alive()


def test_entry_points_need_an_explicit_cpu(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jp, tp = pair["float32"]
    sd = tp.extractor.model.state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FeatureExtractor(tp.extractor.cfg, sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmotionPredictor(tp.cfg, tp.ssrl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="extractor is on cpu"):
        EmotionPredictor(tp.cfg, tp.ssrl, extractor=tp.extractor)


def test_cli_serve_and_unported_commands(pair, tmp_path, monkeypatch, capsys):
    _jp, tp = pair["float32"]
    weights = tmp_path / "dad.pth"
    reference_layout = {f"{role}_{k}": v for role, sd in zip(("student", "teacher"), tp.ssrl)
                        for k, v in sd.items()}
    torch.save({"model_state_dict": reference_layout}, weights)
    served = []
    monkeypatch.setattr(PredictionServer, "serve_forever", lambda self: served.append(self))
    assert cli.main(["serve", "--weights", str(weights), "--device", "cpu",
                     "--port", "0", "--no-warmup"]) == 0
    (server,) = served
    server.shutdown()  # never served: closes the socket
    predictor = server.predictor
    assert predictor.device.type == "cpu" and predictor.extractor is None
    assert predictor.wav_transfer_dtype == "int16" and predictor.batch_size == 16
    for name, value in tp.ssrl.student.items():
        assert torch.equal(predictor.ssrl.student[name], value)

    with pytest.raises(SystemExit):
        cli.main(["serve", "--weights", str(weights), "--bogus"])
