"""The port's feature-level DAD trainer against the JAX package's, and its
own invariants: the whole trainer on tiny IEMOCAP-layout stores (5 sessions x 12 clips, D 16, one length
bucket), resume, and ``cli dad``.

In the whole-trainer comparison the port is fed the JAX trainer's own
per-step draws: ``PRNGKey(seed + 1)`` split once per step, each step's key
split in 4 (clean dropout, weak, strong, student dropout) as the JAX step
splits it; head dropout is off (``dropout_rate 0``). Both trainers load the
same pretrain checkpoint into student and teacher, so anchor calibration
starts from the same student. The stores are class-separable, so that the
float differences between the frameworks cannot flip an argmax.

Tolerances (f32 on the CPU, summation order only, as
``tests/test_torch_train_step.py``): METRIC_TOL atol 2e-5 / rtol 1e-4 for
losses, DACP/ECDA series, anchors and certainty scores; STATE_TOL atol
2e-6 / rtol 1e-4 for parameters. Accuracies, disagreement rates,
predictions and the best epoch are compared exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    CrossDomainTrainer as JaxTrainer,
    extract_noise_info as jax_noise_info,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    write_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    load_torch_file,
    save_torch_file,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    CrossDomainTrainer,
    extract_noise_info,
    run_cv,
)

from torch_parity import jax_trainer_draws

METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
CLASSES = ["ang", "hap", "neu", "sad"]
D = 16
# DACP lets rows through from the first batch (as tests/test_torch_train_step.py),
# so the consistency and ECDA terms carry weight
OVERRIDES = {"dacp.quantile_start": 0.0, "dacp.quantile_end": 0.2,
             "dacp.threshold_smoothing_alpha": 0.0}


def _write_stores(root, seed=0, long_every=0, per_session=12):
    """Clean and noisy IEMOCAP-layout stores: Ses01-Ses05, class c shifts
    feature c by 3, the noisy store is the clean one plus N(0, 0.3). Clips
    have 5-39 frames, or with ``long_every`` 5-15 frames and every such
    clip 50 (batches then reach several length buckets)."""
    rng = np.random.default_rng(seed)
    clips, labels, names = [], [], []
    for s in range(1, 6):
        for i in range(per_session):
            c = (i + s) % 4
            if long_every:
                t = 50 if i % long_every == 0 else int(rng.integers(5, 16))
            else:
                t = int(rng.integers(5, 40))
            x = rng.normal(size=(t, D)).astype(np.float32)
            x[:, c] += 3.0
            clips.append(x)
            labels.append(CLASSES[c])
            names.append(f"Ses0{s}{'FM'[i % 2]}_impro0{i % 7}_{'FM'[i % 2]}{i:03d}")
    clean, noisy = os.path.join(root, "clean"), os.path.join(root, "root1-white-10db")
    write_feature_store(clean, clips, labels=labels, utt_names=names)
    write_feature_store(noisy, [c + rng.normal(0, 0.3, c.shape).astype(np.float32)
                                for c in clips], labels=labels, utt_names=names)
    return clean, noisy


def _write_pretrain(path, hidden, seed=1):
    """A pretrain head that routes feature c to class c (plus noise)."""
    g = torch.Generator().manual_seed(seed)
    pre = torch.randn(hidden, D, generator=g) * 0.1
    pre[:4, :4] += torch.eye(4)
    post = torch.randn(4, hidden, generator=g) * 0.1
    post[:, :4] += torch.eye(4)
    save_torch_file({"pre_net.weight": pre, "pre_net.bias": torch.zeros(hidden),
                     "post_net.weight": post, "post_net.bias": torch.zeros(4)}, path)
    return path


def _cfg_kw(tmp_path, clean, noisy, **kw):
    out = dict(clean_data_dir=clean, noisy_data_dir=noisy, input_dim=D, hidden_dim=8,
               batch_size=8, epochs=3, warmup_epochs=1, ecda_start_epoch=1,
               weight_ramp_epochs=2, num_tracked_samples=10,
               results_base_dir=str(tmp_path / "results"))
    out.update(kw)
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_history_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert len(got[k]) == len(v), k
        if k.startswith("disagreement_rate"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), **METRIC_TOL,
                                       err_msg=k)


def _assert_bias_logs_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: g[k] for k in g if k != "certainty_score"} == \
            {k: w[k] for k in w if k != "certainty_score"}
        np.testing.assert_allclose(g["certainty_score"], w["certainty_score"], **METRIC_TOL)


def _reports(trainer):
    return os.path.join(trainer.results_dir, "reports")


def test_whole_trainer_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path))
    ckpt = _write_pretrain(str(tmp_path / "pm.ckpt"), hidden=8)
    kw = _cfg_kw(tmp_path, clean, noisy, dropout_rate=0.0, pretrained_weight=ckpt)
    jcfg = jax_dad_preset("iemocap", OVERRIDES, **kw)
    cfg = dad_preset("iemocap", OVERRIDES, **kw)

    jt = JaxTrainer(jcfg, fold=0, experiment_name="jax")
    jout = jt.train()
    draws = jax_trainer_draws(jt, jcfg)
    t = CrossDomainTrainer(cfg, fold=0, experiment_name="port", device="cpu",
                           step_draws=lambda e, s: draws[(e, s)])
    np.testing.assert_allclose(t.anchors.numpy(), np.asarray(jt.anchors), **METRIC_TOL)
    out = t.train()

    history = _json(os.path.join(_reports(t), "training_history.json"))
    jhistory = _json(os.path.join(_reports(jt), "training_history.json"))
    _assert_history_close(history, jhistory)
    assert len(history["total_loss"]) == 3 and len(history["dacp_ema_thresholds"]) == 2
    assert max(history["consistency_loss"][1:]) > 0 and max(history["ecda_loss"][1:]) > 0
    _assert_bias_logs_close(_json(os.path.join(_reports(t), "confirmation_bias_log.json")),
                            _json(os.path.join(_reports(jt), "confirmation_bias_log.json")))

    assert t.best_results["epoch"] == jt.best_results["epoch"]
    assert out["best_noisy_weighted_acc"] == jout["best_noisy_weighted_acc"]
    for domain in ("clean_test", "noisy_test"):
        for k, v in jout[domain].items():
            np.testing.assert_array_equal(np.asarray(out[domain][k]), np.asarray(v),
                                          err_msg=f"{domain} {k}")
    best, jbest = (load_torch_file(os.path.join(x.results_dir, "models",
                                                "iemocap_cross_domain_best.pth"))
                   for x in (t, jt))
    assert sorted(best) == sorted(jbest)
    for k, v in jbest.items():
        torch.testing.assert_close(best[k], v, **STATE_TOL, msg=k)
    for name in os.listdir(_reports(jt)):
        if name.startswith("BEST_detailed") or name.startswith("detailed"):
            assert _json(os.path.join(_reports(t), name)) == _json(os.path.join(_reports(jt), name))


def test_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path))
    cfg = dad_preset("iemocap", OVERRIDES, **_cfg_kw(tmp_path, clean, noisy))

    whole = CrossDomainTrainer(cfg, experiment_name="whole", device="cpu")
    whole.train(checkpoint_interval=1)
    assert os.path.exists(os.path.join(whole.results_dir, "models", "last_state.pt"))

    cut = CrossDomainTrainer(cfg, experiment_name="cut", device="cpu")
    run_epoch = cut.train_epoch

    def interrupted(epoch):
        if epoch == 1:  # after epoch 0's checkpoint
            raise KeyboardInterrupt
        return run_epoch(epoch)

    cut.train_epoch = interrupted
    with pytest.raises(KeyboardInterrupt):
        cut.train(checkpoint_interval=1)
    resumed = CrossDomainTrainer(cfg, experiment_name="cut", device="cpu")
    assert resumed.try_resume() == 1
    resumed = CrossDomainTrainer(cfg, experiment_name="cut", device="cpu")
    resumed.train(resume=True, checkpoint_interval=1)

    for name in ("training_history.json", "confirmation_bias_log.json"):
        assert _json(os.path.join(_reports(resumed), name)) == \
            _json(os.path.join(_reports(whole), name)), name
    for part in ("student", "teacher"):
        for k, v in getattr(whole.state.ssrl, part).items():
            assert torch.equal(getattr(resumed.state.ssrl, part)[k], v), (part, k)
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_dad_writes_the_jax_cli_tree(tmp_path, monkeypatch):
    clean, noisy = _write_stores(str(tmp_path))
    ckpt = _write_pretrain(str(tmp_path / "pm.ckpt"), hidden=256)
    argv = ["dad", "--corpus", "iemocap", "--clean", clean, "--noisy", noisy, "--weights", ckpt,
            "--fold", "0", "--epochs", "3", "--warmup-epochs", "1", "--batch-size", "8",
            "--name", "cli"]
    trees = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert main(argv + extra) == 0
        trees[name] = _tree(tmp_path / name)
    assert trees["port"] == trees["jax"]
    assert any(p.endswith("iemocap_cross_domain_best.pth") for p in trees["port"])
    assert any(p.endswith("FINAL_test_set_results.json") for p in trees["port"])


def test_cli_dad_refuses_what_is_not_ported(tmp_path, capsys, caplog, monkeypatch):
    """``--dp``/``--tp`` run under ``torchrun`` only: outside it, or at a
    world size other than max(dp, 1) * tp, the command exits 2 and prints
    the launch to use; a world of one runs the mesh (gloo on the CPU).
    ``--resident on`` and ``--from-wav`` are ported (the latter fails
    without ``--checkpoint``, as the JAX CLI does)."""
    import torch_dist

    monkeypatch.chdir(tmp_path)
    base = ["dad", "--corpus", "iemocap", "--device", "cpu"]
    pkg = cli.__name__.split(".")[0]
    for extra, n in ((["--clean", "c", "--noisy", "n", "--dp", "2"], 2),
                     (["--from-wav", "manifests", "--tp", "2"], 2),
                     (["--from-wav", "manifests", "--dp", "2", "--tp", "2"], 4)):
        assert cli.main(base + extra) == 2
        err = capsys.readouterr().err
        assert f"torchrun --standalone --nproc_per_node {n} -m {pkg} dad" in err
    with torch_dist.torchrun_env(world=3):
        assert cli.main(base + ["--clean", "c", "--noisy", "n", "--dp", "2"]) == 2
        assert "needs 2 processes, the launch has 3" in capsys.readouterr().err
    assert "dad" not in cli.NOT_PORTED
    for extra, words in (([], "--clean and --noisy are required"),
                         (["--from-wav", "manifests"], "--from-wav needs --checkpoint")):
        with pytest.raises(SystemExit) as e:
            cli.main(base + extra)
        assert e.value.code == 2
        assert words in capsys.readouterr().err
    clean, noisy = _write_stores(str(tmp_path))
    with caplog.at_level("INFO"):
        assert cli.main(base + ["--clean", clean, "--noisy", noisy, "--resident", "on",
                                "--epochs", "1", "--batch-size", "8"]) == 0
    assert "resident corpus: 36 clips" in caplog.text
    cfg = dad_preset("iemocap", clean_data_dir=clean, noisy_data_dir=noisy, input_dim=D,
                     batch_size=8)
    assert CrossDomainTrainer(cfg, resident=True, device="cpu")._resident is not None
    # the mesh runs: a world of one through the CLI, streamed (resident auto is
    # off under a mesh) and per step
    caplog.clear()
    with torch_dist.torchrun_env(world=1), caplog.at_level("INFO"):
        assert cli.main(base + ["--clean", clean, "--noisy", noisy, "--dp", "1", "--name", "dp",
                                "--epochs", "2", "--warmup-epochs", "1",
                                "--batch-size", "8"]) == 0
    assert "resident corpus" not in caplog.text
    hist = os.path.join("iemocap_mutil-noisy_cross_domain_results", "dp", "root1", "white",
                        "10db", "fold_1", "reports", "training_history.json")
    with open(hist) as f:
        assert len(json.load(f)["total_loss"]) == 2


@pytest.mark.parametrize("argv", [
    ["dad", "--corpus", "iemocap", "--clean", "c", "--noisy", "n"],
    ["dad", "--corpus", "emodb", "--from-wav", "manifests"],
    ["d2v-pretrain", "--manifests", "m", "--save-dir", "out"],
], ids=["dad", "dad_from_wav", "d2v_pretrain"])
def test_chunked_epoch_flag_is_jax_only(argv, capsys):
    """A deliberate difference: the JAX CLI can step an epoch in chunks of
    batches (one ``lax.scan`` dispatch a chunk); the port steps batch by
    batch only, and its parser refuses the flag."""
    flag = "--scan-chunk"
    # the JAX parser takes the flag: only the stray argument is refused
    with pytest.raises(SystemExit) as e:
        jax_cli.main(argv + [flag, "2", "--stray"])
    assert e.value.code == 2
    assert capsys.readouterr().err.rstrip().endswith("unrecognized arguments: --stray")
    cli.build_parser().parse_args(argv)  # the command line parses without it
    with pytest.raises(SystemExit) as e:
        cli.main(argv + [flag, "2"])
    assert e.value.code == 2
    assert f"unrecognized arguments: {flag} 2" in capsys.readouterr().err


def test_cli_dad_without_a_gpu_and_without_device_cpu_fails(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.build_parser().parse_args(["dad", "--corpus", "iemocap", "--clean", clean,
                                          "--noisy", noisy])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["dad", "--corpus", "iemocap", "--clean", clean, "--noisy", noisy])
    assert not os.path.exists(tmp_path / "iemocap_mutil-noisy_cross_domain_results")


def test_run_cv_keeps_the_sweep_alive_and_noise_info_matches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    clean, noisy = _write_stores(str(tmp_path))
    cfg = dad_preset("iemocap", **_cfg_kw(tmp_path, clean, noisy, epochs=2))
    summary = run_cv(cfg, folds=[0, 7], experiment_name="cv", device="cpu")
    assert [("error" in r) for r in summary["folds"]] == [False, True]  # fold 8 of 5 fails
    assert summary["mean_noisy_weighted_acc"] == summary["folds"][0]["best_noisy_weighted_acc"]
    assert os.path.exists(tmp_path / "results" / "cv" / "final_summary_report.json")
    for path in (r"C:\x\root1-babble-0db", "/d/root1-f16.wav-20db", "/d/root2-15db",
                 "/d/root1-white-multi_5_10db", "/d/root2-multi_0_5db", "/d/x-5db", "/d/x"):
        assert extract_noise_info(path) == jax_noise_info(path)
