"""Offline extraction of the port (``models/extract.py::extract_manifest``,
``cli extract``) against the JAX package's, on the same wav tree and one
set of random fairseq-layout weights (``tests/torch_mirror.py::rand_sd``)
that both packages convert for themselves.

The encoder is a 2-prenet + 2-block one at narrow widths, f32, with conv
strides 5 and 4 (a 1 s bucket is 799 frames). The port's ``extract``
takes attention through the kernel (its plain version on the CPU); the
JAX side runs its plain attention: the same arithmetic. Tolerances: the
``.lengths`` and the sidecars are byte-identical; the ``.npy`` has the
same header and shape and agrees within ``torch_parity.F32_TOL``, the f32
encoder tolerance of ``tests/test_torch_models.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio.wavio import (
    write_wav,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    EncoderConfig as JaxEncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    convert as jax_convert,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.extract import (
    extract_manifest as jax_extract_manifest,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data.native import (
    npy_data_offset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    load_emotion2vec_checkpoint,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.extract import (
    FeatureExtractor,
    extract_manifest,
)

from torch_mirror import rand_sd
from torch_parity import F32_TOL

ENC = dict(embed_dim=16, depth=2, num_heads=2, prenet_depth=2,
           conv_feature_layers=[[8, 10, 5], [8, 8, 4]], conv_pos_width=6,
           conv_pos_groups=2, conv_pos_depth=2, dtype="float32")
LABELS = ["ang", "hap", "neu", "sad"]


CONV = tuple(map(tuple, ENC["conv_feature_layers"]))


def jax_cfg():
    return JaxEncoderConfig(**{**ENC, "use_flash_attention": False, "conv_feature_layers": CONV})


def port_cfg():
    return EncoderConfig(**{**ENC, "use_flash_attention": True, "conv_feature_layers": CONV})


def make_wav_manifest(tmp_path, rng, n=7, sidecar="emo", stereo=(), sr=16000):
    """A wav tree of clips from 0.1 to 1.6 s (three extraction buckets) and
    its manifest dir with an ``.emo`` or ``.lbl``/``.spk`` sidecar."""
    root = tmp_path / "wavs"
    os.makedirs(root / "s", exist_ok=True)
    mdir = tmp_path / "manifest"
    os.makedirs(mdir, exist_ok=True)
    lengths = [1600 + 3700 * i for i in range(n)]
    with open(mdir / "train.tsv", "w") as f:
        print(str(root), file=f)
        for i, t in enumerate(lengths):
            x = 0.2 * np.sin(2 * np.pi * (180 + 60 * i) * np.arange(t) / sr)
            x = x + 0.02 * rng.normal(size=t)
            if i in stereo:
                x = np.stack([x, 0.5 * x[::-1]], axis=1)
            write_wav(str(root / "s" / f"clip{i}.wav"), x, sr)
            print(f"s/clip{i}.wav\t{t}", file=f)
    if sidecar == "emo":
        with open(mdir / "train.emo", "w") as f:
            for i in range(n):
                print(f"Ses0{i % 5 + 1}F_impro0{i}_F{i:03d}\t{LABELS[i % 4]}", file=f)
    else:
        with open(mdir / "train.lbl", "w") as f, open(mdir / "train.spk", "w") as g:
            for i in range(n):
                print(["angry", "happy", "neutral", "sad"][i % 4], file=f)
                print(f"emodb_spk_{i % 3:02d}", file=g)
    return str(mdir)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny_e2v.pt"
    torch.save({"model": rand_sd(jax_cfg(), seed=0)}, str(path))
    return str(path)


def assert_stores_match(got_dir, want_dir, split="train"):
    """Every file of the two stores byte-identical but the features, whose
    .npy headers are identical and values within F32_TOL."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    npy = f"{split}.npy"
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as f, \
                open(os.path.join(want_dir, name), "rb") as g:
            got, want = f.read(), g.read()
        if name == npy:
            off = npy_data_offset(os.path.join(want_dir, npy))
            got, want = got[:off], want[:off]  # magic, version, dtype, shape
        assert got == want, name
    got, want = np.load(os.path.join(got_dir, npy)), np.load(os.path.join(want_dir, npy))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)
    return got.shape


@pytest.mark.parametrize("sidecar", ["emo", "lbl"])
@pytest.mark.parametrize("batch_size", [2, 16])
def test_extract_manifest_matches_jax(tmp_path, rng, checkpoint, sidecar, batch_size):
    mdir = make_wav_manifest(tmp_path, rng, sidecar=sidecar, stereo=(3,))
    n, frames = extract_manifest(mdir, str(tmp_path / "port"), port_cfg(),
                                 load_emotion2vec_checkpoint(checkpoint, port_cfg()),
                                 batch_size=batch_size, device="cpu")
    jn, jframes = jax_extract_manifest(mdir, str(tmp_path / "jax"), jax_cfg(),
                                       jax_convert.load_emotion2vec_checkpoint(checkpoint,
                                                                               jax_cfg()),
                                       batch_size=batch_size)
    assert (n, frames) == (jn, jframes) == (7, frames)
    shape = assert_stores_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert shape == (frames, ENC["embed_dim"])


def test_cli_extract_on_the_cpu_matches_jax_cli(tmp_path, rng, checkpoint):
    mdir = make_wav_manifest(tmp_path, rng)
    enc_json = tmp_path / "enc.json"
    enc_json.write_text(json.dumps(ENC))  # no use_flash_attention: the kernel's path
    assert cli.main(["extract", "--data", mdir, "--checkpoint", checkpoint, "--save-dir",
                     str(tmp_path / "port"), "--encoder-json", str(enc_json),
                     "--batch-size", "4", "--device", "cpu"]) == 0
    jax_json = json.dumps({**ENC, "use_flash_attention": False})
    assert jax_cli.main(["extract", "--data", mdir, "--checkpoint", checkpoint, "--save-dir",
                         str(tmp_path / "jax"), "--encoder-json", jax_json,
                         "--batch-size", "4"]) == 0
    assert_stores_match(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_cli_extract_takes_the_kernel_path_unless_the_json_says(monkeypatch, tmp_path, rng,
                                                                checkpoint):
    seen = []
    real = FeatureExtractor.__init__

    def spy(self, cfg, *a, **kw):
        seen.append(cfg.use_flash_attention)
        real(self, cfg, *a, **kw)

    monkeypatch.setattr(FeatureExtractor, "__init__", spy)
    mdir = make_wav_manifest(tmp_path, rng, n=2)
    for flash in (None, False):
        enc = ENC if flash is None else {**ENC, "use_flash_attention": flash}
        assert cli.main(["extract", "--data", mdir, "--checkpoint", checkpoint, "--save-dir",
                         str(tmp_path / f"out{flash}"), "--encoder-json", json.dumps(enc),
                         "--device", "cpu"]) == 0
    assert seen == [True, False]


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--dp", "1", "--tp", "4"]])
def test_cli_extract_multi_gpu_exits_2_naming_item_9(tmp_path, capsys, flag):
    """Outside ``torchrun`` ``--dp``/``--tp`` exit 2 with the launch to use
    (max(dp, 1) * tp processes), before anything is read or written."""
    rc = cli.main(["extract", "--data", str(tmp_path), "--checkpoint", "none.pt",
                   "--save-dir", str(tmp_path / "f"), "--device", "cpu", *flag])
    assert rc == 2
    n = max(int(flag[flag.index("--dp") + 1]) if "--dp" in flag else 0, 1) * (
        int(flag[flag.index("--tp") + 1]) if "--tp" in flag else 1)
    assert f"--nproc_per_node {n} -m " in capsys.readouterr().err
    assert not (tmp_path / "f").exists()


def test_feature_extractor_mesh_raises_naming_item_9(tmp_path, rng, checkpoint):
    """A batch that does not split over dp is refused; a world of one runs
    ``extract --dp 1`` (gloo on the CPU) and writes the store of the run
    without a mesh."""
    import torch_dist

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        Mesh,
    )

    mesh = Mesh(dp=2, tp=1, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    with pytest.raises(ValueError, match="batch_size=3 must divide by dp=2"):
        FeatureExtractor(port_cfg(), {}, batch_size=3, device="cpu", mesh=mesh)
    mdir = make_wav_manifest(tmp_path, rng, n=3)
    argv = ["extract", "--data", mdir, "--checkpoint", checkpoint, "--encoder-json",
            json.dumps(ENC), "--device", "cpu"]
    assert cli.main(argv + ["--save-dir", str(tmp_path / "one")]) == 0
    with torch_dist.torchrun_env(world=1):
        assert cli.main(argv + ["--save-dir", str(tmp_path / "dp"), "--dp", "1"]) == 0
    for name in ("train.npy", "train.lengths"):
        assert (tmp_path / "one" / name).read_bytes() == (tmp_path / "dp" / name).read_bytes()


def test_extract_refuses_a_wav_that_is_not_16_khz(tmp_path, rng, checkpoint, capsys):
    mdir = make_wav_manifest(tmp_path, rng, n=2, sr=8000)
    with pytest.raises(SystemExit) as e:
        cli.main(["extract", "--data", mdir, "--checkpoint", checkpoint, "--save-dir",
                  str(tmp_path / "f"), "--encoder-json", json.dumps(ENC), "--device", "cpu"])
    assert e.value.code == 2
    assert "expected 16 kHz, got 8000" in capsys.readouterr().err


def test_extract_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path, rng,
                                                            checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mdir = make_wav_manifest(tmp_path, rng, n=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["extract", "--data", mdir, "--checkpoint", checkpoint, "--save-dir",
                  str(tmp_path / "f"), "--encoder-json", json.dumps(ENC)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_manifest(mdir, str(tmp_path / "g"), port_cfg(),
                         load_emotion2vec_checkpoint(checkpoint, port_cfg()))
