"""``cli dad --from-wav`` and ``run_fused_cv`` of the port against the JAX
package's, on the JAX tests' EMODB tone corpus at 4 clips a speaker, with
a tiny strided encoder given as ``--encoder-json`` (f32, conv strides 5 and
4, so a 1 s bucket is 799 frames) and random weights in the fairseq layout
(``tests/torch_mirror.py::rand_sd``)."""

import json
import os

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    EncoderConfig,
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    fairseq_to_torch_encoder,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    dad_trainer,
    fused_trainer,
)

from test_fused_trainer import make_corpus
from torch_mirror import rand_sd

ENC_JSON = dict(embed_dim=16, depth=1, num_heads=2, prenet_depth=1,
                conv_feature_layers=[[8, 10, 5], [8, 8, 4]], conv_pos_width=6,
                conv_pos_groups=2, conv_pos_depth=2, dtype="float32",
                use_flash_attention=False, normalize_input=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_cli")
    manifests = make_corpus(str(root), clips_per_spk=4)
    cfg = EncoderConfig(**{**ENC_JSON, "conv_feature_layers": tuple(
        tuple(x) for x in ENC_JSON["conv_feature_layers"])})
    ckpt = str(root / "e2v.pt")
    torch.save({"model": rand_sd(cfg, seed=0)}, ckpt)
    return manifests, ckpt, cfg


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_from_wav_writes_the_jax_cli_tree(corpus, tmp_path, monkeypatch):
    manifests, ckpt, _cfg = corpus
    argv = ["dad", "--corpus", "emodb", "--from-wav", manifests, "--checkpoint", ckpt,
            "--encoder-json", json.dumps(ENC_JSON), "--encoder-dtype", "float32",
            "--fold", "0", "--epochs", "2", "--warmup-epochs", "1", "--batch-size", "8",
            "--name", "cli"]
    trees = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert main(argv + extra) == 0
        trees[name] = _tree(tmp_path / name)
    assert trees["port"] == trees["jax"]
    assert any(p.endswith(os.path.join("root1", "white", "10db", "fold_1", "models",
                                       "emodb_cross_domain_best.pth")) for p in trees["port"])
    assert any(p.endswith("FINAL_test_set_results.json") for p in trees["port"])


def test_run_fused_cv_prepares_the_startup_once(corpus, tmp_path, monkeypatch):
    manifests, ckpt, enc_cfg = corpus
    calls = []
    real = fused_trainer.prepare_fused_shared

    def counting(*a, **kw):
        calls.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(fused_trainer, "prepare_fused_shared", counting)
    cfg = dad_preset("emodb", batch_size=8, epochs=1, warmup_epochs=1, hidden_dim=8,
                     results_base_dir=str(tmp_path / "results"))
    state = fairseq_to_torch_encoder(torch.load(ckpt)["model"], enc_cfg)
    summary = fused_trainer.run_fused_cv(cfg, manifests, enc_cfg, state, folds=[0, 1],
                                         prefetch_depth=0, device="cpu")
    assert calls == ["cpu"]
    assert len(summary["folds"]) == 2
    assert all("error" not in r for r in summary["folds"]), summary["folds"]
    assert summary["noise"] == "root1-white-10db"
    assert np.isfinite(summary["mean_noisy_weighted_acc"])
    assert os.path.exists(tmp_path / "results" / "final_summary_report.json")


def test_from_wav_without_a_gpu_or_a_checkpoint_fails(corpus, tmp_path, monkeypatch, capsys):
    manifests, ckpt, _cfg = corpus
    monkeypatch.chdir(tmp_path)
    base = ["dad", "--corpus", "emodb", "--from-wav", manifests]
    # as the JAX CLI: a ValueError, exit status 2 with its message
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(base)
        assert e.value.code == 2
        assert "--from-wav needs --checkpoint" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.build_parser().parse_args(base + ["--checkpoint", ckpt])
    assert args.device == "cuda" and args.resident == "auto"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(base + ["--checkpoint", ckpt, "--encoder-json", json.dumps(ENC_JSON)])
    assert not os.path.exists(tmp_path / "emodb_cross_domain_results")


@pytest.mark.parametrize("mode", ["features", "fused"])
def test_fold_all_exits_1_when_a_fold_fails(mode, tmp_path, monkeypatch, capsys):
    """The sweep logs a failed fold and goes on (as the JAX CLI), and the
    exit status says that it failed."""
    def failing(*a, **kw):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.chdir(tmp_path)
    if mode == "features":
        monkeypatch.setattr(dad_trainer, "CrossDomainTrainer", failing)
        argv = ["--clean", "clean", "--noisy", "root1-white-10db"]
    else:
        monkeypatch.setattr(fused_trainer, "prepare_fused_shared", lambda *a, **kw: {})
        monkeypatch.setattr(fused_trainer, "FusedCrossDomainTrainer", failing)
        monkeypatch.setattr(cli, "_build_fused_from_args", lambda args, cfg: (None, None, None))
        argv = ["--from-wav", "manifests", "--checkpoint", "e2v.pt"]
    rc = cli.main(["dad", "--corpus", "casia", "--fold", "all", "--device", "cpu"] + argv)
    assert rc == 1
    assert "fold(s) [1, 2, 3, 4] of 4 failed" in capsys.readouterr().err


def test_cli_from_wav_over_a_world_of_one_equals_the_plain_run(corpus, tmp_path, monkeypatch):
    """``--dp 1`` under a ``torchrun`` launch of one process (gloo on the
    CPU; NCCL on the card, ``chip_smoke.py`` phase 13) runs the mesh step
    and writes what the plain command writes, bit for bit."""
    import torch_dist

    manifests, ckpt, _cfg = corpus
    argv = ["dad", "--corpus", "emodb", "--from-wav", manifests, "--checkpoint", ckpt,
            "--encoder-json", json.dumps(ENC_JSON), "--encoder-dtype", "float32",
            "--fold", "0", "--epochs", "2", "--warmup-epochs", "1", "--batch-size", "8",
            "--device", "cpu"]
    runs = {}
    for name, extra in (("plain", []), ("world1", ["--dp", "1", "--tp", "1"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        with torch_dist.torchrun_env(world=1):
            assert cli.main(argv + extra) == 0
        runs[name] = tmp_path / name
    for rel in _tree(runs["plain"]):
        a, b = runs["plain"] / rel, runs["world1"] / rel
        if rel.endswith(".pth"):
            sa, sb = torch.load(a), torch.load(b)
            assert all(torch.equal(sa[k], sb[k]) for k in sa), rel
        elif rel.endswith("training_history.json") or rel.endswith("confirmation_bias_log.json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
    assert _tree(runs["plain"]) == _tree(runs["world1"])
