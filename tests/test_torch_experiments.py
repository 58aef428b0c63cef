"""The port's experiment harness (``exp/``: the runner, the ablation suites,
the sensitivity sweeps) and its commands against the JAX package's.

- The pure functions (the suites, the noise grids, the cell parser, the
  override split, the markdown writers, the multi-noise aggregate, the
  result scraper) give exactly the JAX outputs, errors included.
- The feature-level suite and sweep run on ``tests/test_torch_trainer.py``'s
  tiny IEMOCAP-layout stores (5 sessions x 12 clips, D 16), the fused
  multi-noise suite on the JAX tests' EMODB tone corpus at 4 clips a
  speaker with their tiny encoder and NOISEX bank
  (``tests/test_fused_trainer.py``), head dropout off. Each experiment's
  trainer is fed the JAX trainer's draws of the same experiment through
  the runners' ``trainer_kw`` (``step_draws``): the experiments of a suite
  share one seed and one data order, so their JAX draws are equal, which
  the tests check before feeding them. Both packages load one pretrain
  head.

Tolerances: METRIC_TOL (atol 2e-5, rtol 1e-4, ``tests/test_torch_trainer.py``)
for the accuracies a row reports; the fused suite's rows come from each
package's own extraction (EXTRACT_TOL apart) and are held to the same
tolerance. Names, overrides, epochs and the layered results paths are
compared exactly.
"""

import functools
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
    apply_overrides as jax_apply_overrides,
    dad_preset as jax_dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.batching import (
    paired_epoch as jax_paired_epoch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.exp import (
    ablation as jax_ablation,
    runner as jax_runner,
    sensitivity as jax_sensitivity,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.parallel.fused import (
    FusedConfig as JaxFusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    CrossDomainTrainer as JaxTrainer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train import (
    fused_trainer as jax_fused_trainer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train.fused_trainer import (
    FusedCrossDomainTrainer as JaxFusedTrainer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch import (
    cli,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.configs import (
    dad_preset,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.dad import (
    StepDraws,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.exp import (
    ablation,
    runner,
    sensitivity,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.layers import (
    conv_out_lengths,
    convert_padding_mask,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
    FusedConfig,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
    CrossDomainTrainer,
    fused_trainer,
)

from test_fused_trainer import TINY_ENC, _make_noise_root, make_corpus, tiny_enc_params
from test_torch_trainer import (
    OVERRIDES,
    _cfg_kw,
    _jax_trainer_draws,
    _write_pretrain,
    _write_stores,
)
from torch_parity import jax_normal, jax_strong_draws, port_cfg, to_torch

METRIC_TOL = dict(atol=2e-5, rtol=1e-4)
PAIR = {"full_method": {}, "no_dacp": {"USE_DACP": False}}
BUCKETS = (8000,)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _raises(fn, *args):
    """(exception type, message) of ``fn(*args)``, or its result."""
    try:
        return fn(*args)
    except Exception as e:  # compared between the packages
        return type(e).__name__, str(e)


def _assert_rows_close(got, want, got_base, want_base):
    """Result rows: names, overrides and epochs equal, the paths equal below
    each package's results base, the accuracies at METRIC_TOL."""
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g["name"]
        assert "error" not in g, g
        for k, v in w.items():
            if k in ("results_dir", "source"):
                assert os.path.relpath(g[k], got_base) == os.path.relpath(v, want_base), k
            elif isinstance(v, float):
                np.testing.assert_allclose(g[k], v, **METRIC_TOL, err_msg=f"{g['name']} {k}")
            else:
                assert g[k] == v, (g["name"], k)


class TrainerRecorder:
    """Keeps every trainer a JAX suite trains (its iterators give the
    draws)."""

    def __init__(self, monkeypatch, cls):
        self.trainers, real = [], cls.train

        def train(trainer, *a, **kw):
            self.trainers.append(trainer)
            return real(trainer, *a, **kw)

        monkeypatch.setattr(cls, "train", train)


def _one_draw_stream(draws: list) -> dict:
    """The draws every experiment of a suite takes, checked equal."""
    first = draws[0]
    for other in draws[1:]:
        assert sorted(other) == sorted(first)
        for key, d in first.items():
            for a, b in zip(jax.tree.leaves(d), jax.tree.leaves(other[key])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return first


# ---------------------------------------------------------------------------
# pure functions


@pytest.mark.parametrize("name", [
    "STANDARD_ABLATIONS", "GRANULAR_ABLATIONS", "NOISE_GRID_TYPES", "NOISE_GRID_SNRS",
])
def test_suites_match_jax(name):
    assert getattr(ablation, name) == getattr(jax_ablation, name)


@pytest.mark.parametrize("args", [(), (("babble", "volvo"), (5, 7.5))])
def test_noise_grids_match_jax(args):
    assert ablation.fused_noise_condition_experiments(*args) == \
        jax_ablation.fused_noise_condition_experiments(*args)
    assert ablation.noise_condition_experiments("/n/base") == \
        jax_ablation.noise_condition_experiments("/n/base")


@pytest.mark.parametrize("spec", [
    "grid", "babble@10", "babble@10, f16@0", "volvo@7.5,factory@-5", "babble", "@10",
    "babble@", "nope@10", "babble@10,babble@10.0", "/d/root1-babble-10db,/d/x",
])
def test_parse_injection_cells_matches_jax(spec):
    assert _raises(ablation.parse_injection_cells, spec) == \
        _raises(jax_ablation.parse_injection_cells, spec)


@pytest.mark.parametrize("overrides", [
    {}, {"USE_DACP": False, "WEIGHT_ECDA": 0.0},
    {"INJECT_NOISE_MODE": "fixed", "INJECT_NOISE_TYPE": "f16", "INJECT_SNR_DB": 5},
    {"INJECT_SNR_CHOICES": [0, 10]}, {"INJECT_SNR_DB": None, "INJECT_NOISE_TYPE": 3},
    {"INJECT_SNR_DB": 10, "INJECT_SNR_CHOICES": (5, 15)},
    {"INJECT_NOISE_MODE": "root3"}, {"INJECT_NOISE_TYPE": "pink"},
])
def test_split_fused_overrides_matches_jax(overrides):
    assert _raises(runner.split_fused_overrides, overrides) == \
        _raises(jax_runner.split_fused_overrides, overrides)
    assert runner.FUSED_INJECTION_KEYS == jax_runner.FUSED_INJECTION_KEYS


@pytest.mark.parametrize("path", ["results.json", "out/grid_results", "a.b/results", "x.tar.json"])
def test_md_path_matches_jax(path):
    assert ablation._md_path(path) == jax_ablation._md_path(path) != path


def test_sweepable_knobs_match_jax():
    assert sensitivity.SWEEPABLE == jax_sensitivity.SWEEPABLE
    assert sensitivity.DEFAULT_GRID == jax_sensitivity.DEFAULT_GRID
    assert sensitivity._PAIRED_KNOBS == jax_sensitivity._PAIRED_KNOBS


MULTI = {
    "babble_10db": {"name": "m_babble_10db", "noisy_wa": 61.25, "noisy_wf1": 58.5},
    "f16_0db": {"name": "m_f16_0db", "noisy_wa": 40.0, "noisy_wf1": 33.125},
    "volvo_5db": {"name": "m_volvo_5db", "error": "boom"},
}


@pytest.mark.parametrize("cells", [MULTI, {"volvo_5db": MULTI["volvo_5db"]}, {}])
def test_aggregate_multi_noise_matches_jax(cells):
    assert ablation._aggregate_multi_noise("m", cells) == \
        jax_ablation._aggregate_multi_noise("m", cells)


ROWS = [
    {"name": "full_method", "noisy_wa": 71.234, "noisy_wf1": 70.1, "clean_wa": 80.0,
     "epoch": 4},
    {"name": "no_dacp", "error": "boom"},
    {"name": "no_scrape"},
]


@pytest.mark.parametrize("writer", ["_write_markdown_table", "_write_multi_noise_markdown"])
def test_markdown_writers_match_jax(tmp_path, writer):
    rows = ROWS if writer == "_write_markdown_table" else [
        ablation._aggregate_multi_noise("m", MULTI), {"name": "gone", "error": "x"},
        ablation._aggregate_multi_noise("e", {})]
    getattr(ablation, writer)(rows, str(tmp_path / "port.md"))
    getattr(jax_ablation, writer)(rows, str(tmp_path / "jax.md"))
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()


def test_scrape_best_results_matches_jax(tmp_path):
    reports = tmp_path / "fold_1" / "reports"
    assert runner.scrape_best_results(str(tmp_path / "fold_1")) is None
    os.makedirs(reports)
    report = {"info": {"epoch": 7},
              "summary": {"noisy": {"w_acc": "63.25%", "w_f1": "61.50%"},
                          "clean": {"w_acc": "77.75%"}}}
    (reports / "BEST_detailed_results_epoch_7.json").write_text(json.dumps(report))
    got = runner.scrape_best_results(str(tmp_path / "fold_1"))
    assert got == jax_runner.scrape_best_results(str(tmp_path / "fold_1"))
    assert got["noisy_wa"] == 63.25 and got["epoch"] == 7


# ---------------------------------------------------------------------------
# the feature-level suite and sweep


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp_stores")
    clean, noisy = _write_stores(str(root))
    return dict(root=root, clean=clean, noisy=noisy,
                ckpt=_write_pretrain(str(root / "pm.ckpt"), hidden=8))


def _feature_cfgs(stores, tmp_path, name):
    kw = dict(dropout_rate=0.0, pretrained_weight=stores["ckpt"])
    return (jax_dad_preset("iemocap", OVERRIDES, **_cfg_kw(tmp_path / f"jax_{name}",
                                                            stores["clean"], stores["noisy"],
                                                            **kw)),
            dad_preset("iemocap", OVERRIDES, **_cfg_kw(tmp_path / f"port_{name}",
                                                       stores["clean"], stores["noisy"], **kw)))


def _feature_draws(recorder, jcfg, overrides_of) -> dict:
    draws = [_jax_trainer_draws(t, jax_apply_overrides(jcfg, overrides_of(i)))
             for i, t in enumerate(recorder.trainers)]
    return _one_draw_stream(draws)


def test_run_ablation_suite_matches_jax(stores, tmp_path, monkeypatch):
    jcfg, cfg = _feature_cfgs(stores, tmp_path, "ablation")
    recorder = TrainerRecorder(monkeypatch, JaxTrainer)
    want = jax_ablation.run_ablation_suite(jcfg, PAIR, output_path=str(tmp_path / "jax.json"))
    draws = _feature_draws(recorder, jcfg, lambda i: list(PAIR.values())[i])
    got = ablation.run_ablation_suite(
        cfg, PAIR, output_path=str(tmp_path / "port.json"), device="cpu",
        trainer_kw={"step_draws": lambda e, s: draws[(e, s)], "resident": True})

    assert got == _json(tmp_path / "port.json")
    _assert_rows_close(got, _json(tmp_path / "jax.json"), cfg.results_base_dir,
                       jcfg.results_base_dir)
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()
    history = _json(os.path.join(got[1]["results_dir"], "reports", "training_history.json"))
    assert history["dacp_ema_thresholds"] == [[0.5] * 4] * 2  # DACP off


def test_run_sensitivity_sweep_matches_jax(stores, tmp_path, monkeypatch):
    jcfg, cfg = _feature_cfgs(stores, tmp_path, "sens")
    recorder = TrainerRecorder(monkeypatch, JaxTrainer)
    want = jax_sensitivity.run_sensitivity_sweep(jcfg, "WEIGHT_ECDA", values=[0.0, 0.5],
                                                 output_dir=str(tmp_path / "jax"))
    draws = _feature_draws(recorder, jcfg, lambda i: {"WEIGHT_ECDA": [0.0, 0.5][i]})
    got = sensitivity.run_sensitivity_sweep(
        cfg, "WEIGHT_ECDA", values=[0.0, 0.5], output_dir=str(tmp_path / "port"),
        device="cpu", trainer_kw={"step_draws": lambda e, s: draws[(e, s)]})
    assert got == _json(tmp_path / "port" / "sensitivity_WEIGHT_ECDA.json")
    _assert_rows_close(got, want, cfg.results_base_dir, jcfg.results_base_dir)
    assert [(r["knob"], r["value"]) for r in got] == [("WEIGHT_ECDA", 0.0), ("WEIGHT_ECDA", 0.5)]


@pytest.mark.parametrize("knob", ["ECDA_GAMMA_DELTA", "WEIGHT_ECDA"])
def test_sensitivity_knob_overrides_match_jax(tmp_path, knob):
    """The paired knob sets both ECDA weights; a plain knob itself; a
    failed point is kept with its knob and value."""
    def fake(name, overrides):
        if overrides.get(knob, overrides.get("ECDA_REPULSION_WEIGHT_DELTA")) == 0.2:
            raise RuntimeError("bad point")
        return {"name": name, "overrides": dict(overrides)}

    kw = dict(values=[0.1, 0.2], output_dir=str(tmp_path / "s"),
              extra_overrides={"USE_ECDA": True}, runner=fake)
    got = sensitivity.run_sensitivity_sweep(dad_preset("iemocap"), knob, **kw)
    want = jax_sensitivity.run_sensitivity_sweep(jax_dad_preset("iemocap"), knob, **kw)
    assert got == want
    if knob == "ECDA_GAMMA_DELTA":
        assert got[0]["overrides"] == {"USE_ECDA": True, "ECDA_COMPACTNESS_WEIGHT_GAMMA": 0.1,
                                       "ECDA_REPULSION_WEIGHT_DELTA": 0.1}
    assert got[1] == {"name": f"sens_{knob}_0.2", "error": "bad point", "knob": knob,
                      "value": 0.2}


# ---------------------------------------------------------------------------
# the fused multi-noise suite


def _jax_fused_bank_draws(jt, jcfg) -> dict:
    """{(epoch, step): StepDraws} replaying a JAX fused trainer's keys in
    bank mode (fixed type): each step key split in 5, its injection key in
    (type, offset) with the offsets drawn over the bank's length."""
    key = jax.random.PRNGKey(jcfg.random_seed + 1)
    layers = TINY_ENC.conv_feature_layers
    bank_len = jt._noise_bank.shape[1]
    draws = {}
    for epoch in range(jcfg.epochs):
        for step, (_c, wb) in enumerate(jax_paired_epoch(jt.clean_train, jt.noisy_wav_train,
                                                         epoch)):
            key, k = jax.random.split(key)
            k_inj, _k_dc, k_w, k_s, _k_ds = jax.random.split(k, 5)
            _k_type, k_off = jax.random.split(k_inj)
            B, T = wb.wav.shape
            t_frames = int(conv_out_lengths(torch.tensor([T]), layers)[0])
            fmask = convert_padding_mask(torch.from_numpy(wb.wav_mask), t_frames, layers).numpy()
            shape = (B, t_frames, TINY_ENC.embed_dim)
            draws[(epoch, step)] = StepDraws(
                bank_offsets=torch.from_numpy(np.array(
                    jax.random.randint(k_off, (B,), 0, bank_len))),
                weak=jax_normal(k_w, shape),
                strong=jax_strong_draws(k_s, shape, fmask, jcfg.augment))
    return draws


def test_run_fused_multi_noise_suite_matches_jax(tmp_path, monkeypatch):
    """One cell (babble at 10 dB) by two mechanisms: the startup skips the
    base noisy domain and each cell rebuilds its own."""
    corpus = make_corpus(str(tmp_path), clips_per_spk=4)
    noise_root = _make_noise_root(tmp_path)
    # one epoch past warmup: DACP, ECDA and the consistency term all run
    kw = dict(batch_size=8, epochs=1, warmup_epochs=0, ecda_start_epoch=0,
              weight_ramp_epochs=2, validation_interval=1, hidden_dim=8, dropout_rate=0.0)
    jcfg = jax_dad_preset("emodb", OVERRIDES, results_base_dir=str(tmp_path / "jax"), **kw)
    cfg = dad_preset("emodb", OVERRIDES, results_base_dir=str(tmp_path / "port"), **kw)
    params = tiny_enc_params()
    cells = ablation.parse_injection_cells("babble@10")

    # one wav and one extraction bucket of 8000 samples (the clips are
    # 0.25-0.45 s), as tests/test_torch_fused_trainer.py
    class JaxTrainerAt8000(JaxFusedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, wav_buckets=BUCKETS, **k)

    monkeypatch.setattr(jax_fused_trainer, "FusedCrossDomainTrainer", JaxTrainerAt8000)
    monkeypatch.setattr(jax_fused_trainer, "prepare_fused_shared", functools.partial(
        jax_fused_trainer.prepare_fused_shared, extract_buckets=BUCKETS))
    recorder = TrainerRecorder(monkeypatch, JaxFusedTrainer)
    want = jax_ablation.run_fused_multi_noise_suite(
        jcfg, PAIR, corpus, TINY_ENC, params, cells=cells,
        base_fused_cfg=JaxFusedConfig(encoder=TINY_ENC, dad=jcfg, inject_snr_db=10.0),
        noise_root=noise_root, output_path=str(tmp_path / "jax.json"), prefetch_depth=0)
    draws = _one_draw_stream([
        _jax_fused_bank_draws(t, jax_apply_overrides(jcfg, list(PAIR.values())[i]))
        for i, t in enumerate(recorder.trainers)])

    built = []
    real_prepare = fused_trainer.prepare_fused_shared

    def prepare(*a, **k):
        shared = real_prepare(*a, extract_buckets=BUCKETS, **k)
        built.append(shared["noisy_store"])
        return shared

    monkeypatch.setattr(fused_trainer, "prepare_fused_shared", prepare)
    port_enc = port_cfg(TINY_ENC)
    got = ablation.run_fused_multi_noise_suite(
        cfg, PAIR, corpus, port_enc, to_torch(params), cells=cells,
        base_fused_cfg=FusedConfig(encoder=port_enc, dad=cfg, inject_snr_db=10.0),
        noise_root=noise_root, output_path=str(tmp_path / "port.json"), prefetch_depth=0,
        device="cpu", trainer_kw={"step_draws": lambda e, s: draws[(e, s)],
                                  "wav_buckets": BUCKETS})

    assert built == [None]  # skip_noisy: every cell brings its own noisy domain
    assert got == _json(tmp_path / "port.json")
    assert [r["name"] for r in got] == list(PAIR)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and list(g["per_noise"]) == ["babble_10db"]
        for k in ("mean_noisy_wa", "mean_noisy_wf1"):
            np.testing.assert_allclose(g[k], w[k], **METRIC_TOL, err_msg=k)
        _assert_rows_close(list(g["per_noise"].values()), list(w["per_noise"].values()),
                           cfg.results_base_dir, jcfg.results_base_dir)
    assert f"root1{os.sep}babble{os.sep}10db" in got[0]["per_noise"]["babble_10db"]["results_dir"]
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()


# ---------------------------------------------------------------------------
# the command line


def test_cli_ablation_and_sensitivity_write_the_jax_json(stores, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--corpus", "iemocap", "--clean", stores["clean"], "--noisy", stores["noisy"],
            "--epochs", "1", "--warmup-epochs", "0", "--batch-size", "8"]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert main(["ablation", *base, "--experiments", "full_method,no_dacp",
                     "--output", "abl.json", *extra]) == 0
        assert main(["sensitivity", *base, "--knob", "WEIGHT_ECDA", "--values", "0.0,0.5",
                     *extra]) == 0
        outs[name] = (_json(tmp_path / name / "abl.json"),
                      _json(tmp_path / name / "sensitivity_results" /
                            "sensitivity_WEIGHT_ECDA.json"))
        assert os.path.exists(tmp_path / name / "abl.md")
    for got, want in zip(outs["port"], outs["jax"]):
        assert [sorted(r) for r in got] == [sorted(r) for r in want]
        assert [(r["name"], r["overrides"]) for r in got] == \
            [(r["name"], r["overrides"]) for r in want]
        # relative to each run's working directory
        assert [r["results_dir"] for r in got] == [r["results_dir"] for r in want]
        assert not [r for r in got if "error" in r]


@pytest.mark.parametrize("command", ["ablation", "sensitivity"])
def test_cli_exits_1_when_an_experiment_fails(stores, tmp_path, monkeypatch, capsys, command):
    """The sweep goes on past a failed experiment and writes its row, as the
    JAX package does; the port then exits 1 (the JAX CLI exits 0)."""
    monkeypatch.chdir(tmp_path)
    real = CrossDomainTrainer.train

    def train(trainer, *a, **kw):
        if trainer.experiment_name in ("no_dacp", "sens_WEIGHT_ECDA_0.5"):
            raise RuntimeError("injected failure")
        return real(trainer, *a, **kw)

    monkeypatch.setattr(CrossDomainTrainer, "train", train)
    argv = [command, "--corpus", "iemocap", "--clean", stores["clean"], "--noisy",
            stores["noisy"], "--epochs", "1", "--batch-size", "8", "--device", "cpu"]
    if command == "ablation":
        argv += ["--experiments", "full_method,no_dacp", "--output", "abl.json"]
        rows = "abl.json"
    else:
        argv += ["--knob", "WEIGHT_ECDA", "--values", "0.0,0.5"]
        rows = "sensitivity_results/sensitivity_WEIGHT_ECDA.json"
    assert cli.main(argv) == 1
    results = _json(tmp_path / rows)
    assert ["error" in r for r in results] == [False, True]
    assert results[1]["error"] == "injected failure"
    assert "of 2 failed" in capsys.readouterr().err
    if command == "ablation":
        assert "| no_dacp | FAILED |" in (tmp_path / "abl.md").read_text()


def test_cli_ablation_rejects_suite_noise_with_multi_noise(capsys):
    argv = ["ablation", "--corpus", "iemocap", "--clean", "c", "--noisy", "n",
            "--suite", "noise", "--multi-noise", "d1,d2"]
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + (["--device", "cpu"] if main is cli.main else []))
        assert e.value.code == 2
        assert "multi-noise already sweeps" in capsys.readouterr().err


def test_cli_multi_noise_row_with_a_failed_cell_exits_1(capsys):
    rows = [{"name": "m", "per_noise": {"a": {"name": "m_a", "noisy_wa": 1.0},
                                        "b": {"name": "m_b", "error": "x"}}},
            {"name": "n", "per_noise": {}}]
    assert cli._failures_rc(rows, "experiment(s)", "name") == 1
    assert "experiment(s) ['m'] of 2 failed" in capsys.readouterr().err
    assert cli._failures_rc(rows[1:], "experiment(s)", "name") == 0


def test_runner_refuses_a_mesh_and_frees_each_trainer(stores, tmp_path, monkeypatch):
    """A fused experiment hands its mesh to its trainer (which runs on the
    mesh's device); an experiment's trainer is gone once its row is
    returned (its device state with it)."""
    import gc
    import weakref

    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.parallel import (
        Mesh,
    )
    from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.train import (
        fused_trainer,
    )

    cfg = dad_preset("iemocap", **_cfg_kw(tmp_path, stores["clean"], stores["noisy"],
                                          epochs=2))
    seen = {}

    class Trainer:
        def __init__(self, *args, **kw):
            seen.update(kw)

        def train(self):
            return {"best_noisy_weighted_acc": 1.0, "results_dir": str(tmp_path / "none")}

    monkeypatch.setattr(fused_trainer, "FusedCrossDomainTrainer", Trainer)
    mesh = Mesh(dp=2, tp=2, rank=0, device=torch.device("cpu"), dp_group=None, tp_group=None)
    row = runner.run_single_fused_experiment(cfg, "x", {}, "m", None, None, mesh=mesh,
                                             device="cpu")
    assert seen["mesh"] is mesh and row["name"] == "x"
    refs = []
    real = CrossDomainTrainer.train

    def train(trainer, *a, **kw):
        refs.append(weakref.ref(trainer))
        return real(trainer, *a, **kw)

    monkeypatch.setattr(CrossDomainTrainer, "train", train)
    row = runner.run_single_experiment(cfg, "one", {}, device="cpu",
                                       trainer_kw={"resident": True})
    gc.collect()
    assert refs and refs[0]() is None
    assert row["name"] == "one" and "noisy_wa" in row
