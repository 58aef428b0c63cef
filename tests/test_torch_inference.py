"""Inference of the port (``eval/inference.py``, ``cli infer``) against the
JAX package's ``CrossDomainInference`` on the same feature stores and the
same DAD ``.pth`` (written by the JAX package's exporter, read by both).

Tolerances: each batch's predictions, the metrics and the whole
``inference_results.json`` but its timestamp and its confidence statistics
are identical. The confidence statistics (the mean, std, min and max of
each clip's top softmax probability) agree within CONF_TOL: the two
frameworks sum the head's f32 matmuls (768 inputs wide) and softmax in
different orders, so a logit of magnitude L moves by ~L x 1e-7 and a
probability by at most that; the teacher's logits here reach O(10-100).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.eval import (
    inference as jax_inference,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.convert import (
    save_torch_file,
    ssrl_to_torch_state_dict,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import (
    init_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.eval import (
    inference,
)

from helpers import make_iemocap_dir, make_spk_dir

CONF_TOL = 1e-5


def _weights(tmp_path, dim, hidden=8, seed=0):
    """A DAD .pth whose teacher differs from its student."""
    _h, ssrl = init_ssrl(jax.random.PRNGKey(seed), dim, hidden)
    ssrl = ssrl._replace(teacher=jax.tree.map(lambda x: x * 1.5 + 0.1, ssrl.teacher))
    path = str(tmp_path / "dad_best.pth")
    save_torch_file(ssrl_to_torch_state_dict(ssrl), path)
    return path


def _record(inf):
    """Keeps each batch's predictions as numpy arrays in ``inf.preds``."""
    step, inf.preds = inf.eval_step, []

    def recorded(*a):
        preds, logits = step(*a)
        inf.preds.append(np.asarray(preds))
        return preds, logits

    inf.eval_step = recorded
    return inf


def _without_run_details(summary):
    """The summary without its timestamp, through a JSON round trip."""
    out = json.loads(json.dumps(summary))
    out["info"].pop("timestamp")
    return out


def _same_summary(got, want):
    got, want = _without_run_details(got), _without_run_details(want)
    g, w = got.pop("confidence_stats"), want.pop("confidence_stats")
    assert got == want
    assert g.keys() == w.keys()
    for k in g:
        assert abs(g[k] - w[k]) <= CONF_TOL, k


def _compare(port_inf, jax_inf, split):
    got = _record(port_inf).run_inference(split)
    want = _record(jax_inf).run_inference(split)
    assert len(port_inf.preds) == len(jax_inf.preds) > 0
    for g, w in zip(port_inf.preds, jax_inf.preds):
        np.testing.assert_array_equal(g, w)
    _same_summary(got, want)
    with open(os.path.join(port_inf.output_dir, "inference_results.json")) as f, \
            open(os.path.join(jax_inf.output_dir, "inference_results.json")) as g:
        _same_summary(json.load(f), json.load(g))
    return got


CASES = {
    "iemocap": dict(preset="iemocap", spk=None),
    "casia": dict(preset="casia", spk=[f"casia_spk_{i}" for i in range(1, 5)]),
    "emodb": dict(preset="emodb", spk=["emodb_spk_03", "emodb_spk_08", "emodb_spk_09",
                                       "emodb_spk_10", "emodb_spk_11"]),
    "unnamed 4 speakers": dict(preset="casia", spk=["liuchanhg", "wangzhe", "zhaoquanyin",
                                                    "ZhaoZuoxiang"]),
}


@pytest.mark.parametrize("teacher", [False, True])
@pytest.mark.parametrize("split", ["test", "all"])
@pytest.mark.parametrize("case", list(CASES))
def test_inference_matches_jax(tmp_path, case, split, teacher):
    c = CASES[case]
    if c["spk"] is None:
        d, *_ = make_iemocap_dir(tmp_path / "feat", n=45, dim=12)
    else:
        d, *_ = make_spk_dir(tmp_path / "feat", c["spk"], n_per_spk=7, dim=12)
    wpath = _weights(tmp_path, 12)
    kw = dict(input_dim=12, hidden_dim=8, batch_size=8, length_buckets=(8, 16, 32))
    port = inference.CrossDomainInference(wpath, d, str(tmp_path / "port"), fold=1,
                                          cfg=dad_preset(c["preset"], **kw),
                                          use_teacher=teacher, device="cpu")
    ref = jax_inference.CrossDomainInference(wpath, d, str(tmp_path / "jax"), fold=1,
                                             cfg=jax_dad_preset(c["preset"], **kw),
                                             use_teacher=teacher)
    assert port.ds_type == ref.ds_type == ("iemocap" if c["spk"] is None else "speaker")
    got = _compare(port, ref, split)
    assert got["info"]["network"] == ("teacher" if teacher else "student")
    n_all = 45 if c["spk"] is None else 7 * len(c["spk"])
    assert (got["info"]["num_samples"] == n_all) == (split == "all")


def test_inference_with_the_default_preset_and_768_d_features(tmp_path):
    d, *_ = make_iemocap_dir(tmp_path / "feat", n=20, dim=768)
    wpath = _weights(tmp_path, 768, hidden=256, seed=4)
    port = inference.CrossDomainInference(wpath, d, str(tmp_path / "port"), device="cpu")
    ref = jax_inference.CrossDomainInference(wpath, d, str(tmp_path / "jax"))
    assert port.cfg == dad_preset("iemocap")
    _compare(port, ref, "all")


@pytest.mark.parametrize("sidecars", ["emo", "lbl+spk", "lbl", "none"])
def test_detect_dataset_type_matches_jax(tmp_path, sidecars):
    for ext in sidecars.split("+"):
        if ext != "none":
            (tmp_path / f"train.{ext}").write_text("x\n")
    if sidecars == "none":
        for detect in (inference.detect_dataset_type, jax_inference.detect_dataset_type):
            with pytest.raises(FileNotFoundError, match="no label sidecar"):
                detect(str(tmp_path))
    else:
        assert (inference.detect_dataset_type(str(tmp_path))
                == jax_inference.detect_dataset_type(str(tmp_path)))


def test_test_split_needs_speakers_as_in_jax(tmp_path):
    d, *_ = make_spk_dir(tmp_path / "feat", ["casia_spk_1", "casia_spk_2"], n_per_spk=4, dim=12)
    os.remove(os.path.join(d, "train.spk"))
    wpath = _weights(tmp_path, 12)
    kw = dict(input_dim=12, hidden_dim=8, batch_size=8, length_buckets=(32,))
    port = inference.CrossDomainInference(wpath, d, str(tmp_path / "p"), device="cpu",
                                          cfg=dad_preset("casia", **kw))
    ref = jax_inference.CrossDomainInference(wpath, d, str(tmp_path / "j"),
                                             cfg=jax_dad_preset("casia", **kw))
    for inf in (port, ref):
        with pytest.raises(ValueError, match="use --split all"):
            inf.run_inference("test")
    _compare(port, ref, "all")


@pytest.mark.parametrize("split", ["test", "all"])
def test_cli_infer_on_the_cpu_matches_jax_cli(tmp_path, split):
    d, *_ = make_iemocap_dir(tmp_path / "feat", n=25, dim=768)
    wpath = _weights(tmp_path, 768, hidden=256, seed=2)
    common = ["infer", "--weights", wpath, "--test-data", d, "--split", split, "--fold", "2",
              "--teacher"]
    assert cli.main([*common, "--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_cli.main([*common, "--output-dir", str(tmp_path / "jax")]) == 0
    (port_dir,), (jax_dir,) = os.listdir(tmp_path / "port"), os.listdir(tmp_path / "jax")
    assert port_dir.startswith("inference_")
    results, names = {}, {}
    for side, sub in (("port", port_dir), ("jax", jax_dir)):
        out = tmp_path / side / sub
        with open(out / "inference_results.json") as f:
            results[side] = json.load(f)
        names[side] = sorted(os.listdir(out))
    _same_summary(results["port"], results["jax"])
    assert names["port"] == names["jax"]
    assert results["port"]["info"]["network"] == "teacher"


def test_inference_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    d, *_ = make_iemocap_dir(tmp_path / "feat", n=8, dim=12)
    wpath = _weights(tmp_path, 12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.CrossDomainInference(wpath, d, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "--weights", wpath, "--test-data", d, "--output-dir",
                  str(tmp_path / "o")])
