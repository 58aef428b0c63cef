"""The port's analysis suite (``analysis/``, ``cli analyze``), its log-mel
front end (``audio/features.py``) and its profiling helpers
(``utils/profiling.py``) against the JAX package's.

- Every ``analyze`` kind but tsne runs through both CLIs on one results
  directory (``tests/test_pipeline_tools.py``'s fake trainer output) or
  one IEMOCAP-layout store (``tests/helpers.py::make_iemocap_dir``): the
  JSON files must be identical (the distribution report names its
  analyzer, the one field that differs).
- tsne: the embedding pass (``DADHead.embed``) against the JAX package's
  ``_embed_all`` at atol 1e-5, and the silhouette and Calinski-Harabasz
  scores, computed on the embeddings, at rtol 1e-5 (f32 matmul summation
  order). The t-SNE coordinates are not compared.
- log-mel: within atol 1e-4 of the JAX package's (f32 rFFT of one frame
  layout; the log amplifies relative error only where the power is tiny),
  the filterbank exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    cli as jax_cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.analysis import (
    tsne as jax_tsne,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.audio import (
    features as jax_features,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.configs import (
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data import (
    load_feature_store as jax_load_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    PaddedBatchIterator as JaxIterator,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.models.heads import (
    DADHead as JaxDADHead,
    init_ssrl as jax_init_ssrl,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.utils import (
    profiling as jax_profiling,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.analysis import (
    tsne,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.audio import (
    features,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.data import (
    PaddedBatchIterator,
    load_feature_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_encoder_to_torch,
    save_torch_file,
    ssrl_to_torch_state_dict,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.heads import (
    SSRLState,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.utils import (
    profiling,
)

from helpers import make_iemocap_dir
from test_pipeline_tools import _fake_results_dir
from torch_parity import one_torch_thread  # noqa: F401 — an autouse fixture

EMBED_TOL = dict(atol=1e-5, rtol=0)
SCORE_TOL = dict(rtol=1e-5)
D, HIDDEN = 12, 8


def _json_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".json"))


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(autouse=True, scope="module")
def one_native_thread():
    """scikit-learn's t-SNE and scores, and numpy's BLAS, on one thread
    each: beside the other test workers their full pools oversubscribe the
    cores (torch's own pool is ``one_torch_thread``'s)."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    d, *_ = make_iemocap_dir(tmp_path_factory.mktemp("analysis_store"), n=40, dim=D)
    return d


@pytest.mark.parametrize("kind", ["disagreement", "bias", "dacp", "distribution"])
def test_analyze_json_matches_jax(tmp_path, store_dir, kind):
    rd = _fake_results_dir(tmp_path, np.random.default_rng(0))
    src = (["--feat-dir", store_dir] if kind == "distribution" else ["--results-dir", rd])
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        out = str(tmp_path / name)
        assert main(["analyze", "--kind", kind, *src, "--out-dir", out, *extra]) == 0
        outs[name] = out
    names = _json_files(outs["jax"])
    assert names and _json_files(outs["port"]) == names
    for name in names:
        got, want = _json(os.path.join(outs["port"], name)), _json(os.path.join(outs["jax"], name))
        if "analysis_info" in want:
            assert got.pop("analysis_info") == {**want.pop("analysis_info"),
                                                "analyzer": "dad_torch"}
        assert got == want, name
    summary = {"disagreement": "disagreement_summary.json", "bias": "confirmation_bias_summary.json",
               "dacp": "dacp_evolution_summary.json",
               "distribution": "distribution_summary.json"}[kind]
    assert summary in names


def _param_sets(cfg):
    """Two DAD student param sets, as numpy (JAX) and state dicts (port)."""
    out = {}
    for name, seed in (("pretrain", 0), ("dad", 1)):
        _h, ssrl = jax_init_ssrl(jax.random.PRNGKey(seed), cfg.input_dim, cfg.hidden_dim)
        out[name] = jax.tree.map(np.asarray, ssrl.student)
    return out


def test_tsne_embeddings_and_scores_match_jax(tmp_path, store_dir):
    kw = dict(input_dim=D, hidden_dim=HIDDEN, batch_size=16, length_buckets=(32,))
    jcfg, cfg = jax_dad_preset("iemocap", **kw), dad_preset("iemocap", **kw)
    jstore, store = jax_load_store(store_dir, jcfg.label_map), load_feature_store(
        store_dir, cfg.label_map)
    jsets = _param_sets(jcfg)
    sets = {k: flax_encoder_to_torch(v) for k, v in jsets.items()}
    for name in jsets:
        head = JaxDADHead(jcfg.input_dim, jcfg.hidden_dim, jcfg.num_classes, jcfg.dropout_rate)
        X_ref, y_ref = jax_tsne._embed_all(head, jsets[name],
                                           JaxIterator(jstore, 16, (32,)))
        X, y = tsne.embed_all(tsne.make_embedder(cfg, sets[name], "cpu"),
                              PaddedBatchIterator(store, 16, (32,)), "cpu")
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_allclose(X, X_ref, **EMBED_TOL, err_msg=name)
        assert X.shape == (40, HIDDEN)

    want = jax_tsne.analyze_tsne(jcfg, jstore, jsets, str(tmp_path / "jax"), perplexity=5)
    got = tsne.analyze_tsne(cfg, store, sets, str(tmp_path / "port"), perplexity=5, device="cpu")
    assert got == _json(tmp_path / "port" / "tsne_summary.json")
    assert sorted(got) == sorted(want) == ["dad", "pretrain"]
    for name, row in want.items():
        assert got[name]["num_samples"] == row["num_samples"] == 40
        for k in ("silhouette", "calinski_harabasz"):
            np.testing.assert_allclose(got[name][k], row[k], **SCORE_TOL, err_msg=f"{name} {k}")


def test_cli_analyze_tsne_matches_jax(tmp_path, monkeypatch):
    """``analyze --kind tsne`` with a DAD .pth and a pretrain .ckpt: the
    pretrain set is the head's pre_net in a fresh DAD head, as in the JAX
    CLI (768-d, the preset's widths)."""
    d, *_ = make_iemocap_dir(tmp_path / "store", n=24, dim=768)
    g = torch.Generator().manual_seed(0)
    pre = {"pre_net.weight": torch.randn(256, 768, generator=g) * 0.05,
           "pre_net.bias": torch.randn(256, generator=g) * 0.05,
           "post_net.weight": torch.randn(4, 256, generator=g) * 0.05,
           "post_net.bias": torch.zeros(4)}
    save_torch_file(pre, str(tmp_path / "pm.ckpt"))
    student = {"encoder.pre_net.weight": torch.randn(256, 768, generator=g) * 0.05,
               "encoder.pre_net.bias": torch.zeros(256),
               "classifier.fc_layer.weight": torch.randn(4, 256, generator=g) * 0.05,
               "classifier.fc_layer.bias": torch.zeros(4)}
    save_torch_file(ssrl_to_torch_state_dict(SSRLState(student, student)),
                    str(tmp_path / "dad.pth"))
    argv = ["analyze", "--kind", "tsne", "--feat-dir", d, "--weights-pretrain",
            str(tmp_path / "pm.ckpt"), "--weights-dad", str(tmp_path / "dad.pth")]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    got, want = (_json(tmp_path / x / "tsne_summary.json") for x in ("port", "jax"))
    assert sorted(got) == sorted(want) == ["dad", "pretrain"]
    for name, row in want.items():
        assert got[name]["num_samples"] == row["num_samples"] == 24
        for k in ("silhouette", "calinski_harabasz"):
            np.testing.assert_allclose(got[name][k], row[k], **SCORE_TOL, err_msg=f"{name} {k}")


def test_tsne_without_scikit_learn_raises_naming_it(tmp_path, store_dir, monkeypatch):
    for mod in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    cfg = dad_preset("iemocap", input_dim=D, hidden_dim=HIDDEN)
    with pytest.raises(ImportError, match="scikit-learn"):
        tsne.analyze_tsne(cfg, load_feature_store(store_dir, cfg.label_map), {},
                          str(tmp_path / "t"), device="cpu")
    assert not os.path.exists(tmp_path / "t")


def test_analyze_defaults_to_the_gpu():
    args = cli.build_parser().parse_args(["analyze", "--kind", "tsne"])
    assert args.device == "cuda" and args.corpus == "iemocap"


# ---------------------------------------------------------------------------
# log-mel front end and profiling


@pytest.mark.parametrize("shape", [(2, 16000), (3, 4321), (1, 399)])
def test_log_mel_matches_jax(shape):
    wav = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = features.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax_features.log_mel_spectrogram(jnp.asarray(wav)))
    assert got.shape == want.shape == (shape[0], max(1 + (shape[1] - 400) // 160, 0), 80)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        features.frame_signal(torch.from_numpy(wav), 400, 160).numpy(),
        np.asarray(jax_features.frame_signal(jnp.asarray(wav), 400, 160)))
    lengths = np.array([0, 399, 400, 560, 16000])
    np.testing.assert_array_equal(
        features.fbank_lengths(torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_features.fbank_lengths(jnp.asarray(lengths))))


@pytest.mark.parametrize("args", [(), (40, 512, 8000), (128, 400, 16000, 50.0, 7000.0)])
def test_mel_filterbank_matches_jax_exactly(args):
    np.testing.assert_array_equal(features.mel_filterbank(*args),
                                  jax_features.mel_filterbank(*args))


class FakeClock:
    """``time`` stand-in whose perf_counter walks a fixed sequence."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter(self):
        return next(self.ticks)


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 1.5, 2.0, 2.25, 3.0, 3.5, 4.0, 4.125]
    summaries = []
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(module, "time", FakeClock(ticks))
        timer = module.StepTimer(skip_first=1)
        for _ in range(4):
            with timer:
                pass
        summaries.append((timer.summary(clips_per_step=10), timer.steady_times,
                          module.StepTimer(skip_first=2).summary(clips_per_step=4)))
    mean = (0.25 + 0.5 + 0.125) / 3  # the steps after the first
    assert summaries[0][0] == summaries[1][0] == {
        "steps": 4, "mean_step_s": mean, "first_step_s": 1.5, "clips_per_sec": 10 / mean}
    # an empty timer's means are nan in both (nan != nan: compare the reprs)
    assert repr(summaries[0][1:]) == repr(summaries[1][1:])
    assert summaries[0][2]["steps"] == 0 and summaries[0][2]["first_step_s"] is None


def test_trace_and_memory_stats_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert profiling.device_memory_stats() == {}  # no CUDA device here
