"""Stage 1 of the port (``cli manifest``, ``fix-format``, ``inject``,
``preprocess``) against the JAX package's, on the same synthetic raw
corpora, wav trees and noise banks.

Tolerances:
- manifests and sidecars (IEMOCAP with EmoEvaluation, CASIA, EMODB, and
  ``fix_manifest_paths`` on a reshaped tree), reformatted wavs and the
  numpy engine's noisy wavs: byte-identical; verify results: equal;
- the native engine, held against the JAX numpy engine (which builds
  nothing, so it never races) by ``tests/test_native_inject.py``'s
  criteria: real noise within 2/32767 (both write int16), white noise at
  10 dB within 0.5 dB of its target with the same output from the same
  seeds, and files its reader rejects byte-identical to the numpy engine's
  (they go through the numpy loop);
- ``run_noise_grid``: identical records and trees; with extraction, stores
  as in ``tests/test_torch_extract.py``.
"""

import json
import os
import shutil
import struct
import wave

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio import (
    cli as jax_audio_cli,
    format as jax_format,
    verify as jax_verify,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio.noise import (
    add_white_noise_np as jax_add_white_noise_np,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio.wavio import (
    read_wav,
    write_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    manifests as jax_manifests,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.exp.preprocess import (
    run_noise_grid as jax_run_noise_grid,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio import (
    cli as audio_cli,
    format as port_format,
    verify as port_verify,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio.native_inject import (
    inject_files_native,
    native_inject_available,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    manifests,
    native,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.exp import (
    run_noise_grid,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    convert,
)

from test_torch_extract import ENC, assert_stores_match, jax_cfg, port_cfg
from torch_mirror import rand_sd

NOISE_FILES = ["babble.wav", "f16.wav", "factory1.wav", "hfchannel.wav", "volvo.wav"]
LSB = 1.0 / 32767.0


def _tone(n=16000, sr=16000, f=440.0, amp=0.3):
    return amp * np.sin(2 * np.pi * f * np.arange(n) / sr)


def _files(d):
    """{relpath: bytes} of every file under ``d``."""
    out = {}
    for dirpath, _dirs, names in os.walk(d):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _snr(clean, noisy):
    n = min(len(clean), len(noisy))
    return 10 * np.log10(np.mean(clean[:n] ** 2) / np.mean((noisy[:n] - clean[:n]) ** 2))


# ---------------------------------------------------------------------------
# manifests


def _iemocap_raw(tmp_path, rng):
    """IEMOCAP's raw layout: Session{N}/sentences/wav/<dialog>/<utt>.wav and
    EmoEvaluation files (excited folds into happy; frustrated is filtered;
    one labelled utterance has no wav)."""
    ev = tmp_path / "EmoEvaluation"
    os.makedirs(ev)
    root = tmp_path / "IEMOCAP"
    lines = {}
    for s, dialog in ((1, "Ses01F_impro01"), (1, "Ses01M_script02_1"), (3, "Ses03F_impro05")):
        rows = []
        for j, emo in enumerate(["neu", "exc", "fru", "ang", "sad", "hap", "xxx"]):
            utt = f"{dialog}_{'FM'[j % 2]}{j:03d}"
            rows.append(f"[{j}.5 - {j + 1}.25]\t{utt}\t{emo}\t[2.5, 3.0, 3.0]")
            if emo != "sad" or s != 3:  # Ses03's sad clip is missing on disk
                d = root / f"Session{s}" / "sentences" / "wav" / dialog
                os.makedirs(d, exist_ok=True)
                write_wav(str(d / f"{utt}.wav"), rng.normal(size=300 + 37 * j) * 0.1, 16000)
        lines[dialog] = rows
    for dialog, rows in lines.items():
        (ev / f"{dialog}.txt").write_text("% header line\n\n" + "\n".join(rows) + "\n")
    (ev / "notes.md").write_text("not an evaluation file\n")
    return str(root), str(ev)


def _assert_dirs_identical(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k


def test_iemocap_manifest_from_emo_evaluation_is_byte_identical(tmp_path, rng):
    root, ev = _iemocap_raw(tmp_path, rng)
    labels = manifests.parse_iemocap_emo_evaluation(ev)
    assert labels == jax_manifests.parse_iemocap_emo_evaluation(ev)
    assert set(labels.values()) == {"neu", "hap", "ang", "sad"}  # fru, xxx dropped
    entries = manifests.build_iemocap_manifest(root, str(tmp_path / "port"), labels=labels)
    jentries = jax_manifests.build_iemocap_manifest(root, str(tmp_path / "jax"), labels=labels)
    assert [vars(e) for e in entries] == [vars(e) for e in jentries]
    assert len(entries) == len(labels) - 1  # the missing wav is skipped
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")


def test_iemocap_manifest_from_a_label_file_is_byte_identical(tmp_path, rng):
    root, ev = _iemocap_raw(tmp_path, rng)
    label_path = tmp_path / "labels.tsv"
    label_path.write_text("".join(f"{u}\t{lbl}\n\n" for u, lbl in
                                  manifests.parse_iemocap_emo_evaluation(ev).items()))
    assert cli.main(["manifest", "--corpus", "iemocap", "--root", root, "--dest",
                     str(tmp_path / "port"), "--label_path", str(label_path)]) == 0
    jax_manifests.build_iemocap_manifest(root, str(tmp_path / "jax"), label_path=str(label_path))
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")


def _casia_raw(tmp_path, rng):
    root = tmp_path / "CASIA"
    for spk, emo in [("liuchanhg", "angry"), ("Chang.Liu", "normal"), ("wangzhe", "happy"),
                     ("ZhaoZuoxiang", "sad"), ("Quanyin.Zhao", "Neutral"),
                     ("ignored_spk", "angry"), ("wangzhe", "surprise")]:
        d = root / spk / emo
        os.makedirs(d, exist_ok=True)
        for k in (201, 202):
            write_wav(str(d / f"{k}.wav"), rng.normal(size=160 + k) * 0.1, 16000)
        (d / "readme.txt").write_text("x")
    write_wav(str(root / "loose.wav"), rng.normal(size=100) * 0.1, 16000)  # too shallow
    return str(root)


def _emodb_raw(tmp_path, rng):
    root = tmp_path / "emodb" / "wav"
    os.makedirs(root)
    for n in ["03a01Aa.wav", "08b02Tb.wav", "09a03Lc.wav", "10b01Na.wav", "03a02Xa.wav",
              "03a01Fa.wav", "notes.wav", "16b10Ab.WAV"]:
        write_wav(str(root / n), rng.normal(size=400) * 0.1, 16000)
    return str(root)


@pytest.mark.parametrize("corpus", ["iemocap", "casia", "emodb"])
def test_cli_manifest_matches_the_jax_builders(tmp_path, rng, corpus):
    if corpus == "iemocap":
        root, ev = _iemocap_raw(tmp_path, rng)
        extra = ["--eval_dir", ev]
        jax_manifests.build_iemocap_manifest(
            root, str(tmp_path / "jax"), labels=jax_manifests.parse_iemocap_emo_evaluation(ev))
    else:
        root = _casia_raw(tmp_path, rng) if corpus == "casia" else _emodb_raw(tmp_path, rng)
        extra = []
        getattr(jax_manifests, f"build_{corpus}_manifest")(root, str(tmp_path / "jax"))
    assert cli.main(["manifest", "--corpus", corpus, "--root", root, "--dest",
                     str(tmp_path / "port"), *extra]) == 0
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    root_line, files = manifests.read_manifest(str(tmp_path / "port"))
    assert root_line == root and len(files) == {"iemocap": 14, "casia": 10, "emodb": 5}[corpus]


@pytest.mark.parametrize("name", ["03a01Aa.wav", "08b02Tb.wav", "09a03Lc.wav", "10b01Na",
                                  "03a02Xa.wav", "03a01Fa.wav", "3a01Aa.wav", "x03a01Aa.wav",
                                  "16b10Ab.WAV"])
def test_parse_emodb_filename_matches_jax(name):
    assert manifests.parse_emodb_filename(name) == jax_manifests.parse_emodb_filename(name)


def test_fix_manifest_paths_on_a_reshaped_tree_is_byte_identical(tmp_path, rng):
    old_root, new_root = tmp_path / "old", tmp_path / "new"
    os.makedirs(new_root / "spk1" / "deep")
    os.makedirs(new_root / "spk2")
    write_wav(str(new_root / "spk1" / "a.wav"), rng.normal(size=100) * 0.1, 16000)
    write_wav(str(new_root / "spk1" / "deep" / "b.wav"), rng.normal(size=120) * 0.1, 16000)
    write_wav(str(new_root / "spk2" / "c.wav"), rng.normal(size=90) * 0.1, 16000)
    src = tmp_path / "m"
    os.makedirs(src)
    (src / "train.tsv").write_text(f"{old_root}\na.wav\t100\nb.wav\t120\ngone.wav\t50\n"
                                   "spk2/c.wav\t90\n")
    (src / "train.emo").write_text("Ses01F_x_F000\tang\n")
    for d in ("port", "jax"):
        shutil.copytree(src, tmp_path / d)
    assert manifests.fix_manifest_paths(str(tmp_path / "port"), str(new_root)) == 3
    assert jax_manifests.fix_manifest_paths(str(tmp_path / "jax"), str(new_root)) == 3
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    root, files = manifests.read_manifest(str(tmp_path / "port"))
    assert root == str(new_root)
    assert files == [("spk1/a.wav", 100), ("spk1/deep/b.wav", 120), ("spk2/c.wav", 90)]


# ---------------------------------------------------------------------------
# fix-format


@pytest.mark.parametrize("sr,channels", [(32000, 2), (44100, 1), (8000, 1), (16000, 2),
                                         (16000, 1), (22050, 3)])
def test_format_check_and_fix_are_byte_identical(tmp_path, sr, channels):
    n = sr // 3
    x = np.stack([_tone(n, sr, f=150.0 * (c + 1), amp=0.4) for c in range(channels)], axis=1)
    p_in = str(tmp_path / "in.wav")
    write_wav(p_in, x[:, 0] if channels == 1 else x, sr)
    assert port_format.check_audio_format(p_in) == jax_format.check_audio_format(p_in)
    assert port_format.check_audio_format(p_in) == (sr == 16000 and channels == 1, sr, channels)
    got = port_format.fix_audio_format(p_in, str(tmp_path / "port.wav"))
    want = jax_format.fix_audio_format(p_in, str(tmp_path / "jax.wav"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert port_format.check_audio_format(str(tmp_path / "port.wav")) == (True, 16000, 1)


@pytest.mark.parametrize("check_only", [False, True])
def test_cli_fix_format_walks_a_tree_like_jax(tmp_path, capsys, check_only):
    src = tmp_path / "src"
    os.makedirs(src / "a" / "b")
    write_wav(str(src / "ok.wav"), _tone(1600), 16000)
    write_wav(str(src / "a" / "stereo.wav"), np.stack([_tone(3200, 32000)] * 2, axis=1), 32000)
    write_wav(str(src / "a" / "b" / "slow.wav"), _tone(800, 8000), 8000)
    (src / "a" / "notes.txt").write_text("x")
    for d in ("port", "jax"):
        shutil.copytree(src, tmp_path / d)
    flag = ["--check-only"] if check_only else []
    assert cli.main(["fix-format", "--root", str(tmp_path / "port"), *flag]) == 0
    got = capsys.readouterr().out.replace(str(tmp_path / "port"), "ROOT")
    assert jax_cli.main(["fix-format", "--root", str(tmp_path / "jax"), *flag]) == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "jax"), "ROOT")
    assert got == want and "checked 3 wavs" in got
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    assert (_files(tmp_path / "port") == _files(src)) == check_only


# ---------------------------------------------------------------------------
# inject: the numpy engine


def _tree(root, n=6, lengths=None):
    """A wav tree spk/clip{i}.wav of tones; returns the relpaths."""
    os.makedirs(os.path.join(root, "spk"), exist_ok=True)
    rels = []
    for i in range(n):
        rel = f"spk/clip{i}.wav"
        t = lengths[i] if lengths else 16000 + 777 * i
        write_wav(os.path.join(root, rel), _tone(t, f=220.0 * (1 + i % 4)), 16000)
        rels.append(rel)
    return rels


def _manifest(tmp_path, root, rels, as_dir=False):
    d = tmp_path / "manifest"
    os.makedirs(d, exist_ok=True)
    with open(d / "train.tsv", "w") as f:
        print(str(root), file=f)
        for rel in rels:
            print(f"{rel}\t16000", file=f)
    return str(d if as_dir else d / "train.tsv")


def _noise_root(tmp_path, seed=1, sizes=(5000, 3000, 4000, 2500, 6000)):
    d = tmp_path / "5types"
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for fname, n in zip(NOISE_FILES, sizes):
        x = rng.normal(size=n) * 0.1
        write_wav(str(d / fname), np.stack([x, 0.5 * x], axis=1) if fname == "f16.wav" else x,
                  16000)
    return str(d)


MODES = {"white": [], "type_specific": ["--noise_mode", "type_specific", "--noise_type", "f16"],
         "random": ["--noise_mode", "random"]}


def _inject_argv(clean, out, manifest, mode, noise_root, *extra, snr="10", seed="42"):
    argv = ["inject", "--input_root", str(clean), "--output_root", str(out), "--snr_db", snr,
            "--manifest_path", manifest, "--seed", seed, *extra]
    if mode != "white":
        argv += ["--noise_root", noise_root, *MODES[mode]]
    return argv


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("as_dir", [False, True])
def test_numpy_engine_is_byte_identical_to_jax(tmp_path, mode, as_dir):
    clean = tmp_path / "clean"
    rels = _tree(str(clean))
    manifest = _manifest(tmp_path, clean, rels, as_dir=as_dir)
    noise_root = _noise_root(tmp_path)
    assert cli.main(_inject_argv(clean, tmp_path / "port", manifest, mode, noise_root,
                                 "--verify")) == 0
    assert jax_audio_cli.main(_inject_argv(clean, tmp_path / "jax", manifest, mode, noise_root,
                                           "--verify")) == 0
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == len(rels)
    for tol, n in ((2.0, 20), (0.5, 3)):
        got = port_verify.verify_noise_injection(str(clean), str(tmp_path / "port"), rels, 10.0,
                                                 tolerance_db=tol, num_samples=n)
        want = jax_verify.verify_noise_injection(str(clean), str(tmp_path / "jax"), rels, 10.0,
                                                 tolerance_db=tol, num_samples=n)
        assert got == want and got[0]


def test_numpy_engine_fails_fast_like_jax(tmp_path):
    clean = tmp_path / "clean"
    rels = _tree(str(clean), n=2)
    (clean / rels[0]).write_bytes(b"RIFFgarbagegarbage")
    manifest = _manifest(tmp_path, clean, rels)
    with pytest.raises(Exception) as got:
        audio_cli.main(_inject_argv(clean, tmp_path / "port", manifest, "white", None))
    with pytest.raises(Exception) as want:
        jax_audio_cli.main(_inject_argv(clean, tmp_path / "jax", manifest, "white", None))
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("snr", [0.0, -5.0])
def test_verify_judges_peak_normalized_mixes_like_jax(tmp_path, snr):
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "clean")
    os.makedirs(tmp_path / "noisy")
    rels = []
    for i in range(4):
        rel = f"loud{i}.wav"
        x = _tone(amp=0.95, f=200.0 + 60 * i)
        x = np.stack([x, x], axis=1) if i == 2 else x  # a stereo clean source
        noisy = jax_add_white_noise_np(x if x.ndim == 1 else x.mean(axis=1), snr, rng)
        write_wav(str(tmp_path / "clean" / rel), x, 16000)
        write_wav(str(tmp_path / "noisy" / rel), noisy, 16000)
        rels.append(rel)
    args = (str(tmp_path / "clean"), str(tmp_path / "noisy"), rels, snr)
    got = port_verify.verify_noise_injection(*args, tolerance_db=2.0)
    assert got == jax_verify.verify_noise_injection(*args, tolerance_db=2.0)
    clean, _ = read_wav(str(tmp_path / "clean" / rels[0]))
    noisy, _ = read_wav(str(tmp_path / "noisy" / rels[0]))
    assert port_verify.estimate_snr(clean, noisy) == jax_verify.estimate_snr(clean, noisy)
    assert (port_verify.estimate_snr_scale_corrected(clean, noisy)
            == jax_verify.estimate_snr_scale_corrected(clean, noisy))


def test_cli_missing_noise_file_raises_like_jax(tmp_path):
    clean = tmp_path / "clean"
    rels = _tree(str(clean), n=1)
    manifest = _manifest(tmp_path, clean, rels)
    os.makedirs(tmp_path / "empty")
    for main in (audio_cli.main, jax_audio_cli.main):
        with pytest.raises(FileNotFoundError):
            main(_inject_argv(clean, tmp_path / "o", manifest, "random", str(tmp_path / "empty")))
    with pytest.raises(SystemExit) as e:  # the package CLI turns ValueError into exit 2
        cli.main(_inject_argv(clean, tmp_path / "o", manifest, "white", None, "--noise_root",
                              _noise_root(tmp_path), "--noise_type", "pink"))
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# inject: the native engine, against the JAX numpy engine


def test_native_engine_builds_here():
    assert native_inject_available()


@pytest.mark.parametrize("mode", ["type_specific", "random"])
def test_native_real_noise_is_within_two_lsb_of_jax_numpy(tmp_path, mode):
    clean = tmp_path / "clean"
    rels = _tree(str(clean))
    manifest = _manifest(tmp_path, clean, rels)
    noise_root = _noise_root(tmp_path)
    assert cli.main(_inject_argv(clean, tmp_path / "port", manifest, mode, noise_root,
                                 "--engine", "native", "--verify")) == 0
    assert jax_audio_cli.main(_inject_argv(clean, tmp_path / "jax", manifest, mode,
                                           noise_root)) == 0
    for rel in rels:
        got, sr = read_wav(str(tmp_path / "port" / rel))
        want, jsr = read_wav(str(tmp_path / "jax" / rel))
        assert sr == jsr and got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 2 * LSB


def test_native_white_noise_hits_the_snr_and_follows_its_seeds(tmp_path):
    clean = tmp_path / "clean"
    rels = _tree(str(clean))
    ins = [str(clean / r) for r in rels]
    seeds = np.arange(len(ins), dtype=np.uint64) + 123
    outs = {k: [str(tmp_path / k / r) for r in rels] for k in ("a", "b", "c")}
    assert not inject_files_native(ins, outs["a"], 10.0, seeds=seeds).any()
    assert not inject_files_native(ins, outs["b"], 10.0, seeds=seeds).any()
    assert not inject_files_native(ins, outs["c"], 10.0, seeds=seeds + 1).any()
    manifest = _manifest(tmp_path, clean, rels)
    assert jax_audio_cli.main(_inject_argv(clean, tmp_path / "jax", manifest, "white",
                                           None)) == 0
    for i, rel in enumerate(rels):
        x, _ = read_wav(ins[i])
        a, _ = read_wav(outs["a"][i])
        c, _ = read_wav(outs["c"][i])
        want, _ = read_wav(str(tmp_path / "jax" / rel))
        assert abs(_snr(x, a) - 10.0) < 0.5 and abs(_snr(x, want) - 10.0) < 0.5
        assert open(outs["a"][i], "rb").read() == open(outs["b"][i], "rb").read()
        assert not np.allclose(a, c)


def test_native_engine_mono_mixes_multichannel_input(tmp_path):
    left, right = _tone(f=300.0), _tone(f=500.0)
    os.makedirs(tmp_path / "clean")
    write_wav(str(tmp_path / "clean" / "st.wav"), np.stack([left, right], axis=1), 16000)
    manifest = _manifest(tmp_path, tmp_path / "clean", ["st.wav"])
    noise_root = _noise_root(tmp_path)
    assert cli.main(_inject_argv(tmp_path / "clean", tmp_path / "port", manifest,
                                 "type_specific", noise_root, "--engine", "native")) == 0
    assert jax_audio_cli.main(_inject_argv(tmp_path / "clean", tmp_path / "jax", manifest,
                                           "type_specific", noise_root)) == 0
    got, _ = read_wav(str(tmp_path / "port" / "st.wav"))
    want, _ = read_wav(str(tmp_path / "jax" / "st.wav"))
    assert got.ndim == 1 and np.max(np.abs(got - want)) <= 2 * LSB
    st = inject_files_native([str(tmp_path / "clean" / "st.wav")], [str(tmp_path / "w.wav")],
                             20.0, seeds=np.array([7], dtype=np.uint64))
    assert not st.any()
    assert abs(_snr((left + right) / 2, read_wav(str(tmp_path / "w.wav"))[0]) - 20.0) < 0.5


def _write_24bit(path, x):
    vals = np.round(np.clip(x, -1, 1) * (2**23 - 1)).astype(np.int32)
    raw = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 16000 * 3, 3, 24)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(raw))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks) + len(raw)) + b"WAVE" + chunks + raw)


def _write_float32(path, x):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(4)
        w.setframerate(16000)
        w.writeframes(x.astype(np.float32).tobytes())
    with open(path, "r+b") as f:  # wave writes PCM (tag 1): patch to IEEE float (3)
        i = f.read(64).find(b"fmt ")
        f.seek(i + 8)
        f.write(struct.pack("<H", 3))


def test_native_engine_falls_back_per_file_to_the_numpy_loop(tmp_path):
    """A 24-bit clip (the native reader takes 16/32-bit PCM and float32)
    goes through the numpy loop: byte-identical to the JAX numpy engine's
    output in real mode, whose mix draws nothing. A float32 clip stays
    native."""
    clean = tmp_path / "clean"
    rels = _tree(str(clean), n=3)
    _write_24bit(str(clean / rels[1]), _tone(12000, f=330.0))
    _write_float32(str(clean / rels[2]), _tone(9000, f=410.0))
    ins = [str(clean / r) for r in rels]
    st = inject_files_native(ins, [str(tmp_path / "probe" / r) for r in rels], 10.0)
    assert st.tolist() == [0, 1, 0]
    manifest = _manifest(tmp_path, clean, rels)
    noise_root = _noise_root(tmp_path)
    assert cli.main(_inject_argv(clean, tmp_path / "port", manifest, "type_specific",
                                 noise_root, "--engine", "native", "--verify")) == 0
    assert jax_audio_cli.main(_inject_argv(clean, tmp_path / "jax", manifest, "type_specific",
                                           noise_root)) == 0
    assert (tmp_path / "port" / rels[1]).read_bytes() == (tmp_path / "jax" / rels[1]).read_bytes()
    for rel in (rels[0], rels[2]):
        got, _ = read_wav(str(tmp_path / "port" / rel))
        want, _ = read_wav(str(tmp_path / "jax" / rel))
        assert np.max(np.abs(got - want)) <= 2 * LSB


def test_native_engine_skips_a_file_that_fails_both_engines(tmp_path, caplog):
    clean = tmp_path / "clean"
    rels = _tree(str(clean), n=2)
    (clean / rels[0]).write_bytes(b"RIFFgarbagegarbage")
    manifest = _manifest(tmp_path, clean, rels)
    assert cli.main(_inject_argv(clean, tmp_path / "port", manifest, "white", None,
                                 "--engine", "native", "--verify")) == 0
    assert (tmp_path / "port" / rels[1]).exists() and not (tmp_path / "port" / rels[0]).exists()
    assert "1 files failed both engines" in caplog.text
    # nothing written at all: verification fails instead of passing vacuously
    (clean / rels[1]).write_bytes(b"RIFFgarbagegarbage")
    assert cli.main(_inject_argv(clean, tmp_path / "none", manifest, "white", None,
                                 "--engine", "native", "--verify")) == 2


def test_native_engine_statuses_for_broken_inputs(tmp_path):
    rels = _tree(str(tmp_path / "clean"), n=1)
    good = str(tmp_path / "clean" / rels[0])
    bad = str(tmp_path / "not_a_wav.wav")
    open(bad, "wb").write(b"garbage")
    short_fmt = str(tmp_path / "short_fmt.wav")
    with open(short_fmt, "wb") as f:  # an 8-byte fmt chunk: rejected, not over-read
        f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 8) + b"\x01\x00\x01\x00\x80>\x00\x00")
        f.write(b"data" + struct.pack("<I", 0))
    outs = [str(tmp_path / f"o{i}.wav") for i in range(3)]
    st = inject_files_native([bad, good, short_fmt], outs, 10.0)
    assert st.tolist() == [1, 0, 1]
    assert os.path.exists(outs[1]) and not os.path.exists(outs[0])
    st = inject_files_native([good], [str(tmp_path / "e.wav")], 10.0,
                             noise_bank={"babble": np.zeros(0, np.float32)},
                             noise_type_per_file=["babble"])
    assert st.tolist() == [1]  # an empty bank entry is a status, not SIGFPE
    st = inject_files_native([good], [str(tmp_path / "nodir" / "x" / "o.wav")], 10.0)
    assert st.tolist() == [0]
    with pytest.raises(ValueError, match="length mismatch"):
        inject_files_native([good], [], 10.0)
    with pytest.raises(ValueError, match="noise_type_per_file"):
        inject_files_native([good], outs[:1], 10.0, noise_bank={"babble": np.ones(9, np.float32)})


def test_native_engine_survives_fuzzed_headers(tmp_path):
    rng = np.random.default_rng(0)
    rels = _tree(str(tmp_path / "clean"), n=1)
    good = bytearray((tmp_path / "clean" / rels[0]).read_bytes())
    ins, outs = [], []
    for i in range(40):
        buf = bytearray(good)
        for _ in range(int(rng.integers(1, 6))):
            buf[int(rng.integers(0, 200))] = int(rng.integers(0, 256))
        p = tmp_path / f"fuzz{i}.wav"
        p.write_bytes(bytes(buf))
        ins.append(str(p))
        outs.append(str(tmp_path / f"out{i}.wav"))
    assert set(inject_files_native(ins, outs, 10.0).tolist()) <= {0, 1, 2}


def test_native_engine_without_its_library_raises(tmp_path, monkeypatch):
    """No numpy fallback for the whole run: a library that cannot be built
    is an error, and the failure is not remembered."""
    clean = tmp_path / "clean"
    rels = _tree(str(clean), n=1)
    manifest = _manifest(tmp_path, clean, rels)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            cli.main(_inject_argv(clean, tmp_path / "o", manifest, "white", None,
                                  "--engine", "native"))
    assert not (tmp_path / "o").exists()
    monkeypatch.undo()
    assert cli.main(_inject_argv(clean, tmp_path / "o", manifest, "white", None,
                                 "--engine", "native")) == 0


# ---------------------------------------------------------------------------
# preprocess: the noise grid


def _grid_tree(tmp_path, n=3):
    clean = tmp_path / "wavs"
    os.makedirs(clean / "s")
    rels = []
    for i in range(n):
        rel = f"s/c{i}.wav"
        write_wav(str(clean / rel), _tone(4000 + 2900 * i, f=300.0 + 50 * i), 16000)
        rels.append(rel)
    mdir = tmp_path / "m"
    os.makedirs(mdir)
    with open(mdir / "train.tsv", "w") as f:
        print(str(clean), file=f)
        for i, rel in enumerate(rels):
            print(f"{rel}\t{4000 + 2900 * i}", file=f)
    with open(mdir / "train.emo", "w") as f:
        for i in range(n):
            print(f"Ses0{i + 1}F_x_F{i:03d}\t{['ang', 'hap', 'neu', 'sad'][i % 4]}", file=f)
    return str(mdir), str(clean), rels


def _relative(records, base):
    return [{k: (os.path.relpath(v, base) if isinstance(v, str) and k != "name" else v)
             for k, v in r.items()} for r in records]


@pytest.mark.parametrize("grid", [dict(snrs=[10, 20]),
                                  dict(snrs=[5], noise_types=["babble", "volvo"]),
                                  dict(snrs=[15, 0], root2=True),
                                  dict(snrs=[10], verify=False, seed=3)])
def test_noise_grid_without_extraction_matches_jax(tmp_path, grid):
    mdir, clean, rels = _grid_tree(tmp_path)
    if grid.get("noise_types") or grid.get("root2"):
        grid = dict(grid, noise_root=_noise_root(tmp_path))
    got = run_noise_grid(mdir, clean, str(tmp_path / "port"), **grid)
    want = jax_run_noise_grid(mdir, clean, str(tmp_path / "jax"), **grid)
    assert _relative(got, tmp_path / "port") == _relative(want, tmp_path / "jax")
    assert len(got) == len(grid["snrs"]) * len(grid.get("noise_types") or [1])
    _assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == len(got) * len(rels)


def test_typed_noise_grid_without_a_bank_raises_like_jax(tmp_path):
    mdir, clean, _ = _grid_tree(tmp_path)
    for grid in (run_noise_grid, jax_run_noise_grid):
        for kw in (dict(noise_types=["babble"]), dict(root2=True)):
            with pytest.raises(ValueError, match="noise_root is required"):
                grid(mdir, clean, str(tmp_path / "o"), snrs=[10], **kw)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_e2v.pt"
    torch.save({"model": rand_sd(jax_cfg(), seed=0)}, str(path))
    return str(path)


def test_noise_grid_with_extraction_matches_jax_and_loads_once(tmp_path, monkeypatch,
                                                               tiny_ckpt):
    mdir, clean, rels = _grid_tree(tmp_path)
    loads = []
    real = convert.load_emotion2vec_checkpoint
    monkeypatch.setattr(convert, "load_emotion2vec_checkpoint",
                        lambda *a: loads.append(a) or real(*a))
    got = run_noise_grid(mdir, clean, str(tmp_path / "port"), snrs=[10, 20],
                         checkpoint=tiny_ckpt, encoder_cfg=port_cfg(), device="cpu")
    want = jax_run_noise_grid(mdir, clean, str(tmp_path / "jax"), snrs=[10, 20],
                              checkpoint=tiny_ckpt, encoder_cfg=jax_cfg())
    assert len(loads) == 1
    assert _relative(got, tmp_path / "port") == _relative(want, tmp_path / "jax")
    for g, w in zip(got, want):
        assert_stores_match(g["feature_dir"], w["feature_dir"])
        _assert_dirs_identical(g["wav_dir"], w["wav_dir"])
        # the noisy manifest: the clean one with the noisy tree as its root
        got_m, want_m = (_files(tmp_path / d / f"manifest-{g['name']}") for d in ("port", "jax"))
        got_m["train.tsv"] = got_m["train.tsv"].replace(str(tmp_path / "port").encode(),
                                                        str(tmp_path / "jax").encode())
        assert got_m == want_m and set(got_m) == {"train.tsv", "train.emo"}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_cli_preprocess_on_the_cpu_matches_jax_cli(tmp_path, tiny_ckpt):
    mdir, clean, _ = _grid_tree(tmp_path)
    noise_root = _noise_root(tmp_path)
    common = ["preprocess", "--manifest-dir", mdir, "--clean-root", clean, "--snrs", "10",
              "--noise-types", "hfchannel", "--noise-root", noise_root, "--checkpoint",
              tiny_ckpt]
    assert cli.main([*common, "--output-base", str(tmp_path / "port"), "--encoder-json",
                     json.dumps(ENC), "--device", "cpu", "--engine", "numpy"]) == 0
    assert jax_cli.main([*common, "--output-base", str(tmp_path / "jax"), "--encoder-json",
                         json.dumps({**ENC, "use_flash_attention": False})]) == 0
    name = "root1-hfchannel-10db"
    assert_stores_match(str(tmp_path / "port" / f"features-{name}"),
                        str(tmp_path / "jax" / f"features-{name}"))
    _assert_dirs_identical(tmp_path / "port" / name, tmp_path / "jax" / name)


# ---------------------------------------------------------------------------
# the command line


@pytest.mark.parametrize("name", ["d2v-pretrain", "d2v-pack"])
def test_subcommands_still_not_ported_exit_2(capsys, name):
    assert name in cli.NOT_PORTED
    assert cli.main([name, "--anything", "x"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_stage_1_subcommands_are_ported():
    parser = cli.build_parser()
    for name in ("manifest", "inject", "extract", "infer", "fix-format", "preprocess"):
        assert name not in cli.NOT_PORTED
        with pytest.raises(SystemExit) as e:
            parser.parse_args([name, "--help"])
        assert e.value.code == 0
    for argv in (["extract", "--data", "d", "--checkpoint", "c", "--save-dir", "s"],
                 ["infer", "--weights", "w", "--test-data", "t"],
                 ["preprocess", "--manifest-dir", "m", "--clean-root", "c", "--output-base", "o"]):
        assert parser.parse_args(argv).device == "cuda"
