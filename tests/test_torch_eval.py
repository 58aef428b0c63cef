"""The port's evaluation and checkpoint plumbing against the JAX package's:
metrics, report JSONs, the best-checkpoint and pretrain-head files in both
directions, and anchor calibration.

Metrics and reports are exact (the final report's timestamp aside).
Checkpoint tensors round-trip bit for bit. Anchors: f32 on the CPU,
summation order only, METRIC_TOL atol 2e-5 / rtol 1e-4 (as
``tests/test_torch_train_step.py``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.dad import (
    run_anchor_calibration as jax_calibration,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    PaddedBatchIterator as JaxIterator,
    load_feature_store as jax_load_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.eval import (
    metrics as jax_metrics,
    reports as jax_reports,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models import (
    convert as jax_convert,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import (
    init_ssrl as jax_init_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    run_anchor_calibration,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    write_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval import (
    metrics,
    reports,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models import (
    convert,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.heads import (
    DADHead,
    PretrainHead,
    init_ssrl,
)

METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
NOISE_INFO = {"root_type": "root1", "noise_type": "white", "db_value": "10db",
              "display_name": "root1-white-10db"}
CLASSES = ["ang", "hap", "neu", "sad"]


def _cases(rng):
    y = rng.integers(0, 4, 50)
    yield y, np.where(rng.random(50) < 0.7, y, rng.integers(0, 4, 50))  # mostly right
    y3 = rng.integers(0, 3, 30)  # class 3 absent from y_true
    yield y3, rng.integers(0, 4, 30)
    yield np.zeros(0, np.int64), np.zeros(0, np.int64)


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert type(got[k]) is type(want[k]), k


def test_evaluate_domain_equals_jax(rng):
    for y_true, y_pred in _cases(rng):
        _assert_results_equal(metrics.evaluate_domain(y_true, y_pred, 4),
                              jax_metrics.evaluate_domain(y_true, y_pred, 4))
    with pytest.raises(ValueError, match="negative label"):
        metrics.evaluate_domain([0, -1], [0, 1], 4)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_reports_equal_jax_without_the_timestamp(tmp_path, rng):
    (yc, pc), (yn, pn), _ = _cases(rng)
    for mod, d in ((reports, tmp_path / "port"), (jax_reports, tmp_path / "jax")):
        clean = metrics.evaluate_domain(yc, pc, 4)
        noisy = metrics.evaluate_domain(yn, pn, 4)
        mod.best_detailed_results(str(d), NOISE_INFO, 0, 6, clean, noisy, CLASSES, is_best=True)
        mod.best_detailed_results(str(d), NOISE_INFO, 0, 999, clean, noisy, CLASSES, is_best=False)
        mod.final_test_report(str(d), NOISE_INFO, 0, clean, noisy, 61.25)
        mod.save_confusion_matrices(str(d), clean, noisy, 6, CLASSES, "root1-white-10db",
                                    is_best=True)
        mod.save_confusion_matrices(str(d), clean, noisy, 999, CLASSES, "root1-white-10db")
        mod.save_single_confusion(str(d / "single"), noisy, CLASSES, "noisy")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for name in ("BEST_detailed_results_epoch_7.json", "detailed_results_epoch_1000.json"):
        assert ((tmp_path / "port" / "reports" / name).read_bytes()
                == (tmp_path / "jax" / "reports" / name).read_bytes())
    final = [json.loads((tmp_path / d / "reports" / "FINAL_test_set_results.json").read_text())
             for d in ("port", "jax")]
    for f in final:
        assert f["info"].pop("timestamp")
    assert final[0] == final[1]


def _jax_ssrl(seed, D=12, H=8, C=4):
    _head, ssrl = jax_init_ssrl(jax.random.PRNGKey(seed), D, H, C)
    return jax.tree.map(np.asarray, ssrl)


def test_best_pth_loads_across_packages(tmp_path):
    # the JAX package's file in the port
    jssrl = _jax_ssrl(0)
    jax_convert.save_torch_file(jax_convert.ssrl_to_torch_state_dict(jssrl),
                                str(tmp_path / "jax.pth"))
    got = convert.torch_state_dict_to_ssrl(convert.load_torch_file(str(tmp_path / "jax.pth")))
    for role in ("student", "teacher"):
        want = convert.flax_encoder_to_torch(getattr(jssrl, role))
        assert set(getattr(got, role)) == set(want)
        for k, v in want.items():
            assert torch.equal(getattr(got, role)[k], v), (role, k)

    # the port's file in the JAX package, in the reference key layout
    _head, ssrl = init_ssrl(torch.Generator().manual_seed(3), 12, 8, 4)
    ssrl = ssrl._replace(teacher={k: v * 0.5 for k, v in ssrl.teacher.items()})
    sd = convert.ssrl_to_torch_state_dict(ssrl)
    assert sorted(sd) == sorted(jax_convert.ssrl_to_torch_state_dict(jssrl))
    for v in sd.values():
        assert v.device.type == "cpu" and v.dtype == torch.float32 and v.is_contiguous()
    convert.save_torch_file(sd, str(tmp_path / "port.pth"))
    back = jax_convert.torch_state_dict_to_ssrl(jax_convert.load_torch_file(str(tmp_path / "port.pth")))
    for role in ("student", "teacher"):
        want = convert.flax_encoder_to_torch(getattr(back, role))
        for k, v in getattr(ssrl, role).items():
            assert torch.equal(want[k], v), (role, k)


def test_pretrain_head_ckpt_loads_across_packages(tmp_path, rng):
    sd = {"pre_net.weight": rng.normal(size=(8, 12)).astype(np.float32),
          "pre_net.bias": rng.normal(size=8).astype(np.float32),
          "post_net.weight": rng.normal(size=(4, 8)).astype(np.float32),
          "post_net.bias": rng.normal(size=4).astype(np.float32)}
    # written as the JAX package's pretrain stage writes it
    flax = jax_convert.torch_to_flax_pretrain_head(sd)
    jax_convert.save_torch_file(jax_convert.flax_pretrain_head_to_torch(flax),
                                str(tmp_path / "jax.ckpt"))
    got = convert.load_pretrain_head_checkpoint(str(tmp_path / "jax.ckpt"))
    head = PretrainHead(12, 8, 4)
    head.load_state_dict(got)  # the PretrainHead layout, key for key
    for k, v in sd.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    # written by the port, read by the JAX package
    convert.save_torch_file(head.state_dict(), str(tmp_path / "port.ckpt"))
    back = jax_convert.load_pretrain_head_checkpoint(str(tmp_path / "port.ckpt"))
    for k, v in jax_convert.flax_pretrain_head_to_torch(back).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    convert.save_torch_file({"pre_net.weight": torch.zeros(1)}, str(tmp_path / "bad.ckpt"))
    with pytest.raises(KeyError):
        convert.load_pretrain_head_checkpoint(str(tmp_path / "bad.ckpt"))


def test_anchor_calibration_matches_jax(tmp_path, rng):
    D = 12
    clips, labels, names = [], [], []
    for i in range(70):
        c = i % 4
        x = rng.normal(size=(int(rng.integers(4, 60)), D)).astype(np.float32)
        x[:, c] += 1.5
        clips.append(x)
        labels.append(CLASSES[c])
        names.append(f"Ses0{i % 5 + 1}F_impro01_F{i:03d}")
    write_feature_store(str(tmp_path), clips, labels=labels, utt_names=names)
    store = jax_load_store(str(tmp_path), {k: i for i, k in enumerate(CLASSES)})
    kw = dict(input_dim=D, hidden_dim=8, batch_size=16)
    jcfg, cfg = jax_dad_preset("iemocap", **kw), dad_preset("iemocap", **kw)
    clean = JaxIterator(store.subset(np.arange(0, 50)), 32, (16, 32, 64))
    noisy = JaxIterator(store.subset(np.arange(40, 70)), 32, (16, 32, 64))
    jhead, jssrl = jax_init_ssrl(jax.random.PRNGKey(1), D, 8, 4)
    want = jax_calibration(jhead, jssrl.student, clean, noisy, jcfg)
    student = convert.flax_encoder_to_torch(jax.tree.map(np.asarray, jssrl.student))
    for depth in (0, 2):
        got = run_anchor_calibration(DADHead(D, 8, 4), student, clean, noisy, cfg,
                                     prefetch_depth=depth)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **METRIC_TOL)
    assert (want > 0).all()
