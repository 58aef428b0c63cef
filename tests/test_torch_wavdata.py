"""The port's wav plumbing against the JAX package's on the same files:
wav decoding, the numpy injectors and noise loaders, manifests, the wav
store (from a manifest and from a packed directory), the wav batch
iterator, and the fused trainer's fixed noisy domain. Every comparison is
bit for bit (byte for byte for files)."""

import os
import struct

import numpy as np
import pytest

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio import (
    noise as jax_noise,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio import (
    wavio as jax_wavio,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    EncoderConfig as JaxEncoderConfig,
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    manifests as jax_manifests,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    wavstore as jax_wavstore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.binarized import (
    pack_manifest,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel.fused import (
    FusedConfig as JaxFusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    fused_trainer as jax_fused,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio import (
    noise,
    wavio,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig,
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    manifests,
    wavstore,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    FusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    fused_trainer,
)

from test_fused_trainer import _make_noise_root, make_corpus

SR = 16000


def _riff(path, data: bytes, tag: int, channels: int, bits: int, extensible: bool = False):
    """A RIFF/WAVE file with the given format tag, written byte by byte."""
    block = channels * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHIH14s", 0xFFFE, channels, SR, SR * block, block, bits, 22,
                          bits, 0, tag, b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, SR, SR * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    if len(data) % 2:
        body += b"\x00"
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _samples(kind: str, n: int, channels: int) -> bytes:
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, n * channels)
    if kind == "pcm8":
        return (x * 127 + 128).astype(np.uint8).tobytes()
    if kind == "pcm16":
        return (x * 32767).astype("<i2").tobytes()
    if kind == "pcm24":
        v = (x * (2**23 - 1)).astype(np.int32)
        b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return b.tobytes()
    if kind == "pcm32":
        return (x * (2**31 - 1)).astype("<i4").tobytes()
    if kind == "float32":
        return x.astype("<f4").tobytes()
    return x.astype("<f8").tobytes()


FORMATS = {  # kind -> (format tag, bits)
    "pcm8": (1, 8), "pcm16": (1, 16), "pcm24": (1, 24), "pcm32": (1, 32),
    "float32": (3, 32), "float64": (3, 64),
}


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("extensible", [False, True], ids=["plain", "extensible"])
@pytest.mark.parametrize("kind", list(FORMATS))
def test_read_wav_and_read_mono_match_jax(tmp_path, kind, extensible, channels):
    tag, bits = FORMATS[kind]
    path = str(tmp_path / f"{kind}.wav")
    _riff(path, _samples(kind, 1001, channels), tag, channels, bits, extensible)
    got, sr = wavio.read_wav(path)
    want, jsr = jax_wavio.read_wav(path)
    assert sr == jsr == SR and got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((1001, 2) if channels == 2 else (1001,))
    np.testing.assert_array_equal(wavio.read_mono(path), jax_wavio.read_mono(path))


def test_write_wav_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((3001,), (1500, 2)):
        x = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
        wavio.write_wav(str(tmp_path / "port.wav"), x, SR)
        jax_wavio.write_wav(str(tmp_path / "jax.wav"), x, SR)
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
        np.testing.assert_array_equal(wavio.read_wav(str(tmp_path / "jax.wav"))[0],
                                      jax_wavio.read_wav(str(tmp_path / "port.wav"))[0])
    with pytest.raises(ValueError, match="sample rate"):
        wavio.write_wav(str(tmp_path / "8k.wav"), x, 8000)
        wavio.read_mono(str(tmp_path / "8k.wav"))


def test_numpy_injectors_and_noise_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    clip = rng.normal(0, 0.3, 5000)
    for snr in (-5.0, 0.0, 10.0, 20.0):
        np.testing.assert_array_equal(
            noise.add_white_noise_np(clip, snr, np.random.default_rng(11)),
            jax_noise.add_white_noise_np(clip, snr, np.random.default_rng(11)))
    loud = clip * 5  # peak normalisation taken
    np.testing.assert_array_equal(noise.add_white_noise_np(loud, 0.0, np.random.default_rng(1)),
                                  jax_noise.add_white_noise_np(loud, 0.0, np.random.default_rng(1)))
    short, stereo = rng.normal(size=777), rng.normal(size=(900, 2))
    for src in (short, stereo, rng.normal(size=9000)):
        np.testing.assert_array_equal(noise.tile_noise_np(src, 5000),
                                      jax_noise.tile_noise_np(src, 5000))
    seg = noise.tile_noise_np(short, 5000)
    for snr in (0.0, 15.0):
        np.testing.assert_array_equal(noise.add_real_noise_np(loud, seg, snr),
                                      jax_noise.add_real_noise_np(loud, seg, snr))
    np.testing.assert_array_equal(noise.add_real_noise_np(clip, np.zeros(5000), 5.0),
                                  jax_noise.add_real_noise_np(clip, np.zeros(5000), 5.0))

    root = _make_noise_root(tmp_path)
    got, want = noise.load_noise_clips(root), jax_noise.load_noise_clips(root)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(noise.load_noise_bank(root, 7000),
                                  jax_noise.load_noise_bank(root, 7000))
    os.remove(os.path.join(root, "volvo.wav"))
    with pytest.raises(FileNotFoundError, match="volvo"):
        noise.load_noise_clips(root)


@pytest.mark.parametrize("sidecar", ["emo", "lbl"])
def test_manifests_match_jax_byte_for_byte(tmp_path, sidecar):
    entries = [("Ses01F_impro01_F000.wav", 16000, "ang", "spk1", "Ses01F_impro01_F000"),
               ("sub\\dir/Ses02M_script02_M001.wav", 4321, "neu", "spk2", "Ses02M_script02_M001")]
    for mod, name in ((manifests, "port"), (jax_manifests, "jax")):
        mod.write_manifest(str(tmp_path / name), "/corpus/root",
                           [mod.ManifestEntry(*e) for e in entries], sidecar)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert manifests.read_manifest(str(tmp_path / "jax")) == \
        jax_manifests.read_manifest(str(tmp_path / "jax"))
    assert manifests.read_manifest(str(tmp_path / "jax"))[1][1] == ("sub/dir/Ses02M_script02_M001.wav",
                                                                    4321)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavdata")
    dest = make_corpus(str(root), clips_per_spk=4)
    packed = str(root / "packed")
    pack_manifest(dest, packed)
    return dest, packed


def _assert_stores_equal(got, want):
    for f in ("samples", "sizes", "offsets", "labels", "groups"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.label_names == want.label_names and got.utt_names == want.utt_names


def test_wav_store_from_manifest_and_packed_dir_matches_jax(corpus):
    dest, packed = corpus
    label_map = dad_preset("emodb").label_map
    for d in (dest, packed):
        assert wavstore.is_packed_dir(d) == (d == packed)
        got = wavstore.load_wav_store(d, label_map)
        _assert_stores_equal(got, jax_wavstore.load_wav_store(d, label_map))
        assert got.num == 40 and got.samples.dtype == np.float32
    _assert_stores_equal(wavstore.load_wav_store(packed, label_map),
                         wavstore.load_wav_store(dest, label_map))
    sub = [7, 3, 30]
    _assert_stores_equal(wavstore.load_wav_store(dest, label_map).subset(sub),
                         jax_wavstore.load_wav_store(dest, label_map).subset(sub))


@pytest.mark.parametrize("shuffle, bucket_shuffle", [(False, False), (True, False), (True, True)],
                         ids=["ordered", "shuffled", "bucket_shuffled"])
def test_padded_wav_iterator_matches_jax(corpus, shuffle, bucket_shuffle):
    dest, _packed = corpus
    label_map = dad_preset("emodb").label_map
    store = wavstore.load_wav_store(dest, label_map).subset(np.arange(3, 37))
    jstore = jax_wavstore.load_wav_store(dest, label_map).subset(np.arange(3, 37))
    for labeled in (True, False):
        kw = dict(buckets=(4000, 6000, 8000), shuffle=shuffle, seed=5, labeled=labeled,
                  bucket_shuffle=bucket_shuffle)
        it, jit = wavstore.PaddedWavIterator(store, 8, **kw), jax_wavstore.PaddedWavIterator(
            jstore, 8, **kw)
        assert len(it) == len(jit) == 5
        for epoch in range(3):
            it.set_epoch(epoch)
            jit.set_epoch(epoch)
            got, want = list(it), list(jit)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


MODES = {
    "white": dict(inject_snr_db=10.0),
    "white_multi": dict(inject_snr_choices=(20.0, 10.0)),
    "fixed": dict(inject_snr_db=15.0, inject_noise_bank_mode="fixed", inject_noise_type=1),
    "random": dict(inject_snr_db=5.0, inject_noise_bank_mode="random"),
    "random_multi": dict(inject_snr_choices=(0.0, 5.0), inject_noise_bank_mode="random"),
    "fixed_multi": dict(inject_snr_choices=(10.0, 20.0), inject_noise_bank_mode="fixed",
                        inject_noise_type=3),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_fixed_noisy_domain_and_display_names_match_jax(corpus, tmp_path, mode):
    dest, _packed = corpus
    label_map = dad_preset("emodb").label_map
    store = wavstore.load_wav_store(dest, label_map)
    jstore = jax_wavstore.load_wav_store(dest, label_map)
    fused = FusedConfig(encoder=EncoderConfig(), dad=dad_preset("emodb"), **MODES[mode])
    jfused = JaxFusedConfig(encoder=JaxEncoderConfig(), dad=jax_dad_preset("emodb"),
                            **MODES[mode])
    assert fused_trainer.injection_display_name(fused) == jax_fused.injection_display_name(jfused)
    clips = None
    if fused.inject_noise_bank_mode:
        clips = noise.load_noise_clips(_make_noise_root(tmp_path))
    got = fused_trainer.inject_fixed(store, fused, clips, seed=42)
    want = jax_fused.inject_fixed(jstore, jfused, clips, seed=42)
    assert len(got) == len(want) == store.num
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    feats = [np.full((len(c) // 320, 4), i, np.float32) for i, c in enumerate(got)]
    feats[2] = np.zeros((0, 4), np.float32)  # a clip too short for one frame
    s, js = fused_trainer.store_from_clips(feats, store, 4), jax_fused.store_from_clips(
        feats, jstore, 4)
    for f in ("feats", "sizes", "offsets", "labels", "groups"):
        np.testing.assert_array_equal(getattr(s, f), getattr(js, f), err_msg=f)
    assert s.utt_names == js.utt_names
    empty = fused_trainer.store_from_clips([np.zeros((0, 4), np.float32)] * 2,
                                           store.subset([0, 1]), 4)
    assert empty.feats.shape == (0, 4) and empty.dim == 4
