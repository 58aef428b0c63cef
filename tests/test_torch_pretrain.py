"""The port's supervised pretrain stage against the JAX package's: the
schedulers and early stopping, ``pretrain_fold`` for each reference
variant, ``train_with_early_stopping`` through ``cli pretrain --device
cpu``, and the pretrain-head checkpoint both packages read.

The store is IEMOCAP-layout (Ses01-Ses05), 80 clips of 4-23 frames, D 12,
class c shifting feature c by 1: learnable in a few epochs, not at once,
so validation peaks before the last epoch. Both sides start from the JAX
init (``PRNGKey(seed + fold)``), carried over by
``flax_pretrain_head_to_torch`` into ``pretrain_fold``'s ``init_params``
hook.

Tolerances (f32 on the CPU, summation order only): METRIC_TOL atol 2e-5 /
rtol 1e-4 for losses; STATE_TOL atol 2e-6 / rtol 1e-4 for parameters
(``tests/test_torch_trainer.py``'s). Accuracies, learning rates, epochs,
the best epoch and the test predictions are compared exactly.
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
    pretrain_preset as jax_pretrain_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.store import (
    load_feature_store as jax_load_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.convert import (
    flax_pretrain_head_to_torch as jax_flax_to_torch,
    load_pretrain_head_checkpoint as jax_load_pretrain,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    early_stopping as jax_early_stopping,
    pretrain as jax_pretrain,
    schedules as jax_schedules,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    pretrain_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    load_feature_store,
    write_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_pretrain_head_to_torch,
    load_pretrain_head_checkpoint,
    load_torch_file,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.heads import (
    init_pretrain_head,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    early_stopping,
    pretrain,
    schedules,
)

from torch_parity import jax_pretrain_init

METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=2e-6, rtol=1e-4)
CLASSES = ["ang", "hap", "neu", "sad"]
D = 12
# learns in a few epochs at this rate; plateau and stopping patience small
# enough that the learning rate drops and the run stops early
FOLD_KW = dict(input_dim=D, hidden_dim=8, batch_size=16, length_buckets=(32,),
               learning_rate=0.05, early_stopping_patience=4, lr_scheduler_patience=1,
               max_epochs=20, cosine_t_0=2)
# a fixed validation-loss sequence: falls, plateaus, rises, falls again
VAL_LOSSES = [1.0 / (1 + e) if e < 12 else 0.09 + 0.01 * ((e * 7) % 5) for e in range(40)]


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_store")
    rng = np.random.default_rng(0)
    clips, labels, names = [], [], []
    for i in range(80):
        s = i % 5 + 1
        c = (i * 7 + s) % 4
        x = rng.normal(size=(int(rng.integers(4, 24)), D)).astype(np.float32)
        x[:, c] += 1.0
        clips.append(x)
        labels.append(CLASSES[c])
        names.append(f"Ses0{s}F_impro0{i % 9}_F{i:03d}")
    write_feature_store(str(root), clips, labels=labels, utt_names=names, sidecar="emo")
    return str(root)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_history_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("acc") or k.endswith("f1") or k in ("epochs", "lr"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, **METRIC_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# schedulers and early stopping


def _scheduler_pair(name):
    if name == "plateau":
        return (schedules.ReduceLROnPlateau(0.1, factor=0.5, patience=2, min_lr=1e-3),
                jax_schedules.ReduceLROnPlateau(0.1, factor=0.5, patience=2, min_lr=1e-3),
                False)
    if name == "warm_restarts":
        return (schedules.CosineAnnealingWarmRestarts(0.1, t_0=3, t_mult=2, eta_min=1e-5),
                jax_schedules.CosineAnnealingWarmRestarts(0.1, t_0=3, t_mult=2, eta_min=1e-5),
                True)
    if name == "step":
        return (schedules.StepLR(0.1, step_size=4, gamma=0.7),
                jax_schedules.StepLR(0.1, step_size=4, gamma=0.7), True)
    return (schedules.CosineAnnealingLR(0.1, t_max=40, eta_min=1e-4),
            jax_schedules.CosineAnnealingLR(0.1, t_max=40, eta_min=1e-4), True)


@pytest.mark.parametrize("name", ["plateau", "warm_restarts", "step", "cosine", "stopper"])
def test_schedulers_and_early_stopping_match_jax(name):
    """40 epochs of one validation-loss sequence, stepped as pretrain_fold
    steps them (``epoch + 1``; ``None`` for the per-epoch types): the same
    learning rates, bit for bit, and the same stopping decisions."""
    if name == "stopper":
        ours = early_stopping.EarlyStopper(patience=3, min_delta=0.01, mode="min")
        ref = jax_early_stopping.EarlyStopper(patience=3, min_delta=0.01, mode="min")
        got = [(ours(v, e), ours.best_epoch, ours.counter) for e, v in enumerate(VAL_LOSSES)]
        want = [(ref(v, e), ref.best_epoch, ref.counter) for e, v in enumerate(VAL_LOSSES)]
        assert got == want and got[-1][0]
        return
    ours, ref, per_epoch = _scheduler_pair(name)
    got = [ours.step(e + 1, None if per_epoch else v) for e, v in enumerate(VAL_LOSSES)]
    want = [ref.step(e + 1, None if per_epoch else v) for e, v in enumerate(VAL_LOSSES)]
    assert got == want
    assert min(got) < got[0]


def test_make_lr_scheduler_picks_the_variants_type():
    for variant in ("default", "advanced", "cosine", "debug"):
        ours = schedules.make_lr_scheduler(pretrain_preset("iemocap", variant))
        ref = jax_schedules.make_lr_scheduler(jax_pretrain_preset("iemocap", variant))
        assert type(ours).__name__ == type(ref).__name__
        assert vars(ours) == vars(ref)


# ---------------------------------------------------------------------------
# the pretrain head: init, conversion, checkpoints


def test_init_and_conversion_and_checkpoints(tmp_path):
    """The port's own init draws nn.Linear's distribution from its
    generator; the JAX params convert exactly to both packages' torch
    layout; each package's loader reads the other's checkpoint."""
    gen = torch.Generator().manual_seed(0)
    head, params = init_pretrain_head(gen, input_dim=D, hidden_dim=8)
    assert [k for k in params] == ["pre_net.weight", "pre_net.bias", "post_net.weight",
                                   "post_net.bias"]
    assert params["pre_net.weight"].shape == (8, D) and params["post_net.weight"].shape == (4, 8)
    assert params["pre_net.weight"].abs().max() <= 1 / np.sqrt(D)
    assert params["post_net.bias"].abs().max() <= 1 / np.sqrt(8)
    for k, v in head.state_dict().items():
        assert torch.equal(v, params[k])

    jparams = jax_pretrain_init(pretrain_preset("iemocap", input_dim=D, hidden_dim=8), 0)
    ours = flax_pretrain_head_to_torch(jparams)
    ref = jax_flax_to_torch(jparams)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    with pytest.raises(ValueError, match="not a PretrainHead"):
        flax_pretrain_head_to_torch({"params": {"pre_net": jparams["params"]["pre_net"]}})


@pytest.mark.parametrize("variant", ["default", "advanced", "cosine", "debug"])
def test_pretrain_fold_matches_jax(store_dir, variant):
    jcfg = jax_pretrain_preset("iemocap", variant, **FOLD_KW)
    cfg = pretrain_preset("iemocap", variant, **FOLD_KW)
    want = jax_pretrain.pretrain_fold(jcfg, jax_load_store(store_dir, jcfg.label_map), 0)
    got = pretrain.pretrain_fold(cfg, load_feature_store(store_dir, cfg.label_map), 0,
                                 device="cpu",
                                 init_params=flax_pretrain_head_to_torch(jax_pretrain_init(jcfg, 0)))

    history = got["history"]
    _assert_history_close(history, want["history"])
    epochs = len(history["epochs"])
    assert epochs < cfg.max_epochs, "no early stop"
    assert min(history["lr"]) < history["lr"][0], "no learning-rate drop"
    assert got["best_epoch"] == want["best_epoch"] < epochs
    # the best epoch's parameters, not the last epoch's
    ref = jax_flax_to_torch(want["params"])
    for k, v in ref.items():
        torch.testing.assert_close(got["params"][k], torch.from_numpy(np.array(v)), **STATE_TOL,
                                   msg=k)
    for k in ("y_true", "y_pred"):
        np.testing.assert_array_equal(got["test"][k], want["test"][k])
    for k in ("accuracy", "weighted_accuracy", "f1_macro"):
        assert got["test"][k] == want["test"][k], k


# ---------------------------------------------------------------------------
# the K-fold loop through the command line


def test_cli_pretrain_matches_jax(store_dir, tmp_path, monkeypatch):
    """``cli pretrain --device cpu`` against the JAX CLI on one store: the
    same files, the checkpoint's keys and shapes, its values at STATE_TOL,
    the JSONs and the classification report; each package reads the
    other's checkpoint."""
    real = pretrain.pretrain_fold

    def from_jax_init(cfg, store, fold, **kw):
        return real(cfg, store, fold, init_params=flax_pretrain_head_to_torch(
            jax_pretrain_init(cfg, fold)), **kw)

    monkeypatch.setattr(pretrain, "pretrain_fold", from_jax_init)
    argv = ["pretrain", "--corpus", "iemocap", "--feat-path", store_dir, "--folds", "0",
            "--max-epochs", "6"]
    assert jax_cli.main(argv + ["--save-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(argv + ["--save-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0

    port, ref = tmp_path / "port", tmp_path / "jax"
    names = {n for n in os.listdir(ref) if not n.endswith(".png")}
    assert names == {n for n in os.listdir(port) if not n.endswith(".png")}
    assert names >= {"best_model_fold_1.ckpt", "test_results.json", "training_history.json",
                     "test_classification_report_fold_1.txt"}

    ckpt, jckpt = (str(d / "best_model_fold_1.ckpt") for d in (port, ref))
    got, want = load_torch_file(ckpt), load_torch_file(jckpt)
    assert sorted(got) == sorted(want) == ["post_net.bias", "post_net.weight",
                                           "pre_net.bias", "pre_net.weight"]
    assert got["pre_net.weight"].shape == (256, D) and got["post_net.weight"].shape == (4, 256)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], v, **STATE_TOL, msg=k)
    # each package's loader reads the other's checkpoint
    jax_read = jax_load_pretrain(ckpt)["params"]
    for layer in ("pre_net", "post_net"):
        np.testing.assert_array_equal(jax_read[layer]["kernel"].T, got[f"{layer}.weight"].numpy())
        np.testing.assert_array_equal(jax_read[layer]["bias"], got[f"{layer}.bias"].numpy())
    for k, v in load_pretrain_head_checkpoint(jckpt).items():
        assert torch.equal(v, want[k])

    assert _json(port / "test_results.json") == _json(ref / "test_results.json")
    hist, jhist = (_json(d / "training_history.json") for d in (port, ref))
    assert sorted(hist) == sorted(jhist) == ["fold_1"]
    _assert_history_close(hist["fold_1"], jhist["fold_1"])
    assert len(hist["fold_1"]["epochs"]) == 6
    report = "test_classification_report_fold_1.txt"
    assert (port / report).read_text() == (ref / report).read_text()


def test_cli_pretrain_max_epochs_overrides_the_variant(monkeypatch):
    """As in the JAX CLI, ``--max-epochs`` (default 100) replaces the
    variant's own max_epochs: ``--variant debug`` runs 100 epochs unless
    told otherwise."""
    seen = []
    monkeypatch.setattr(pretrain, "train_with_early_stopping",
                        lambda cfg, folds=None, device="cuda": seen.append((cfg, folds, device)))
    base = ["pretrain", "--corpus", "emodb", "--feat-path", "f", "--variant", "debug"]
    assert cli.main(base) == 0
    assert cli.main(base + ["--max-epochs", "7", "--folds", "1,3", "--device", "cpu"]) == 0
    (cfg, folds, device), (cfg7, folds7, device7) = seen
    assert pretrain_preset("emodb", "debug").max_epochs == 10
    assert cfg.max_epochs == 100 and cfg.early_stopping_patience == 3 and cfg.batch_size == 32
    assert folds is None and device == "cuda"
    assert cfg7.max_epochs == 7 and folds7 == (1, 3) and device7 == "cpu"
