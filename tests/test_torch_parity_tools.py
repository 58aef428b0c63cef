"""The port's accuracy-parity protocol (``<port>/tools/``) against the JAX
system's ``tools/``: the synthetic corpora, the reference replica, the
port's side of the protocol against the JAX package's, the pooled
verdict, and run_parity.main's report and refusals.

``tools/run_parity.py`` is only ever run in a subprocess: its import sets
``JAX_PLATFORMS`` and the matmul precision process-wide. The JAX side of
the protocol is called here as its ``run_jax_side`` calls it.

Tolerances: the corpora, the replica (its CPU run) and the pooled verdict
are exact (bytes, bits, 1e-12). The port's side against the JAX package's
at the tiny protocol (dim 8, 64 clips, 3 DAD epochs after a pretrain of up
to 30), fed the JAX pretrain init and the JAX DAD draws with head dropout
off: the four row fields equal, as the trainers' own parity tests hold
their predictions.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu import (
    configs as jax_configs,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.data.store import (
    load_feature_store as jax_load_store,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train.dad_trainer import (
    CrossDomainTrainer as JaxTrainer,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu.train.pretrain import (
    pretrain_fold as jax_pretrain_fold,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.models.convert import (
    flax_pretrain_head_to_torch,
)
from robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu_torch.tools import (
    pool_parity,
    run_parity,
    torch_replica,
)

from torch_parity import jax_pretrain_init, jax_trainer_draws, one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPORA = ("iemocap", "casia", "emodb")
DIM, N_CORPUS, N_TRAIN, EPOCHS = 8, 48, 64, 3


def _jax_replica():
    """tools/torch_replica.py, loaded from its file (it imports the JAX
    package's data plumbing and leaves the process's JAX settings alone)."""
    spec = importlib.util.spec_from_file_location("jax_tools_torch_replica",
                                                  REPO / "tools" / "torch_replica.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_cfg(cfg):
    """The JAX package's copy of one of the port's config dataclasses."""
    return getattr(jax_configs, type(cfg).__name__)(**{
        f.name: jax_cfg(v) if dataclasses.is_dataclass(v) else v
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]
    })


def _stores(root, corpus, n=N_TRAIN):
    """The corpus pair written by the port; (port stores, JAX stores)."""
    port = run_parity.load_parity_stores(str(root), corpus, n, DIM)
    label_map = {k: i for i, k in enumerate(run_parity.CORPUS_META[corpus]["labels"])}
    jax_side = tuple(jax_load_store(os.path.join(str(root), d), label_map)
                     for d in ("clean", "root2-10db"))
    return port, jax_side


def _assert_same(got, want, what):
    """Equal nested results (dicts, lists, numpy arrays, tensors), bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), what
    elif isinstance(want, (np.ndarray, list, tuple)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    else:
        assert got == want, what


# ---------------------------------------------------------------------------
# 1. the synthetic corpora, byte for byte
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tool_corpora(tmp_path_factory):
    """The three corpus pairs written by tools/run_parity.py, in a subprocess."""
    out = tmp_path_factory.mktemp("jax_corpora")
    code = (
        "import sys; sys.path.insert(0, 'tools'); import run_parity as r\n"
        f"for c in {CORPORA!r}:\n"
        f"    r.make_parity_corpus(f'{out}/{{c}}/clean', f'{out}/{{c}}/noisy', "
        f"n={N_CORPUS}, dim={DIM}, corpus=c)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.mark.parametrize("corpus", CORPORA)
def test_corpus_is_byte_identical_to_the_jax_tool(tmp_path, jax_tool_corpora, corpus):
    run_parity.make_parity_corpus(str(tmp_path / "clean"), str(tmp_path / "noisy"),
                                  n=N_CORPUS, dim=DIM, corpus=corpus)
    for domain in ("clean", "noisy"):
        want_dir = jax_tool_corpora / corpus / domain
        names = sorted(os.listdir(want_dir))
        assert names == sorted(os.listdir(tmp_path / domain))
        assert "train.npy" in names and len(names) >= 3
        for name in names:
            assert (tmp_path / domain / name).read_bytes() == (want_dir / name).read_bytes(), \
                f"{corpus} {domain} {name}"


# ---------------------------------------------------------------------------
# 2. the replica on the CPU, bit for bit against tools/torch_replica.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("corpus", CORPORA)
def test_replica_is_bit_equal_to_the_jax_tools_replica(tmp_path, corpus):
    (clean, noisy), (jclean, jnoisy) = _stores(tmp_path, corpus)
    pre_cfg, dad_cfg = run_parity.build_configs(DIM, EPOCHS, 0, str(tmp_path), corpus)
    jpre_cfg, jdad_cfg = jax_cfg(pre_cfg), jax_cfg(dad_cfg)
    ref = _jax_replica()

    want_pre = ref.pretrain_fold_torch(jpre_cfg, jclean, 0)
    got_pre = torch_replica.pretrain_fold_torch(pre_cfg, clean, 0, device="cpu")
    _assert_same(got_pre, want_pre, f"{corpus} pretrain")
    want = ref.dad_train_fold_torch(jdad_cfg, jclean, jnoisy, 0,
                                    pretrain_sd=want_pre["state_dict"])
    got = torch_replica.dad_train_fold_torch(dad_cfg, clean, noisy, 0,
                                             pretrain_sd=got_pre["state_dict"], device="cpu")
    _assert_same(got, want, f"{corpus} dad")
    assert want["best_noisy_weighted_acc"] > 0


# ---------------------------------------------------------------------------
# 3. the port's side against the JAX package's, fed the JAX draws
# ---------------------------------------------------------------------------
# iemocap (DACP + ECDA) and casia (a fixed threshold, no ECDA): the two
# branches; emodb takes iemocap's with other constants, and the JAX side's
# compiles would take the file past its minute
@pytest.mark.parametrize("corpus", ("iemocap", "casia"))
def test_port_side_matches_the_jax_side(tmp_path, corpus):
    (clean, noisy), (jclean, jnoisy) = _stores(tmp_path, corpus)
    pre_cfg, dad_cfg = run_parity.build_configs(DIM, EPOCHS, 0, str(tmp_path / "port"),
                                                corpus)
    dad_cfg = dataclasses.replace(dad_cfg, dropout_rate=0.0)  # the JAX dropout keys
    jpre_cfg, jdad_cfg = jax_cfg(pre_cfg), jax_cfg(dad_cfg)
    jdad_cfg = dataclasses.replace(
        jdad_cfg, results_base_dir=str(tmp_path / "jax" / os.path.basename(
            dad_cfg.results_base_dir)))

    # tools/run_parity.py:172 run_jax_side, keeping the trainer for its draws
    jpre = jax_pretrain_fold(jpre_cfg, jclean, 0)
    jt = JaxTrainer(jdad_cfg, fold=0, clean_store=jclean, noisy_store=jnoisy,
                    pretrain_params=jpre["params"])
    jout = jt.train()
    want = {"pretrain_test_wa": jpre["test"]["weighted_accuracy"] * 100,
            "best_noisy_val_wa": jt.best_noisy_weighted_acc,
            "clean_test": jout["clean_test"], "noisy_test": jout["noisy_test"]}

    draws = jax_trainer_draws(jt, jdad_cfg)
    got = run_parity.run_port_side(
        pre_cfg, dad_cfg, clean, noisy, 0, "cpu",
        init_params=flax_pretrain_head_to_torch(jax_pretrain_init(jpre_cfg, 0)),
        step_draws=lambda e, s: draws[(e, s)])
    assert got["best_noisy_val_wa"] > 0
    _assert_same(got, want, corpus)


# ---------------------------------------------------------------------------
# 4. the pooled verdict over the JAX system's committed reports
# ---------------------------------------------------------------------------
def test_pooling_reproduces_the_committed_jax_verdict():
    per = {}
    for corpus in CORPORA:
        with open(REPO / run_parity.JAX_REPORTS[corpus]) as f:
            report = json.load(f)
        per[corpus] = pool_parity.paired_estimate(report["metrics"]["noisy_UA"],
                                                  ours="jax", theirs="torch")
    got = pool_parity.pool(per)
    with open(REPO / "PARITY_POOLED.json") as f:
        want = json.load(f)
    assert want["metric"] == "noisy_UA"
    for key in ("pooled_delta_pp", "pooled_se_pp", "pooled_t"):
        assert abs(got[key] - want[key]) <= 1e-12, key
    assert got["n_runs"] == want["n_paired_runs"] == 180
    for corpus, row in want["per_corpus"].items():
        assert got["per_corpus"][corpus]["n_seeds"] == row["n_seeds"]
        for key in ("delta_pp", "se_pp"):
            assert abs(got["per_corpus"][corpus][key] - row[key]) <= 1e-12, (corpus, key)


def test_pool_parity_main_gives_both_verdicts(tmp_path):
    """Over two made-up reports: the paired port - replica verdict and the
    port - JAX difference of means, each pooled by inverse variance."""
    rng = np.random.default_rng(0)
    for corpus in ("iemocap", "casia"):
        pv, tv = rng.normal(85, 1.5, 6), rng.normal(85, 1.5, 6)
        metrics = {name: run_parity.metric_row(
            list(pv), list(tv), {"jax_mean": 85.2, "jax_std": 1.4, "jax_per_seed": [0.0] * 60})
            for name in pool_parity.POOLED_METRICS}
        report = {"protocol": {"preset": corpus}, "seed_list": list(range(6)),
                  "metrics": metrics, "seconds_per_seed": {"port": 1.0, "torch": 2.0},
                  "runs": [{"port_device": "cpu", "replica_device": "cpu"}]}
        (tmp_path / f"PARITY_REPORT_{corpus}.json").write_text(json.dumps(report))
    out = tmp_path / "pooled.json"
    rc = pool_parity.main(["--reports", str(tmp_path), "--out", str(out)])
    got = json.loads(out.read_text())
    assert rc == (0 if got["within_tolerance"] else 1)
    assert got["tolerance_pp"] == 0.5 and set(got["metrics"]) == {"noisy_UA", "noisy_WA"}
    paired, vs_jax = (got["metrics"]["noisy_UA"][k] for k in ("port_vs_replica", "port_vs_jax"))
    assert set(paired["per_corpus"]) == set(vs_jax["per_corpus"]) == {"iemocap", "casia"}
    rows = [json.loads((tmp_path / f"PARITY_REPORT_{c}.json").read_text())["metrics"]["noisy_UA"]
            for c in ("iemocap", "casia")]
    w = np.array([1 / r["delta_vs_jax_se_pp"] ** 2 for r in rows])
    want = float((w * np.array([r["delta_vs_jax_pp"] for r in rows])).sum() / w.sum())
    assert abs(vs_jax["pooled_delta_pp"] - want) <= 1e-12
    d = np.array(rows[0]["port_per_seed"]) - np.array(rows[0]["torch_per_seed"])
    assert abs(paired["per_corpus"]["iemocap"]["se_pp"] - d.std(ddof=1) / np.sqrt(6)) <= 1e-12


# ---------------------------------------------------------------------------
# 5. run_parity.main: its report, its refusals, chunks merged
# ---------------------------------------------------------------------------
TINY = ["--corpus", "iemocap", "--epochs", str(EPOCHS), "--n-clips", str(N_CORPUS),
        "--dim", str(DIM), "--device", "cpu", "--replica-device", "cpu"]


@pytest.fixture(scope="module")
def tiny_jax_report(tmp_path_factory):
    """The committed iemocap JAX report relabelled to the tiny protocol (its
    per-seed numbers stand in for a JAX run at that protocol)."""
    with open(REPO / run_parity.JAX_REPORTS["iemocap"]) as f:
        report = json.load(f)
    report["protocol"].update(epochs=EPOCHS, n_clips=N_CORPUS, dim=DIM)
    path = tmp_path_factory.mktemp("jax_report") / "PARITY_REPORT.json"
    path.write_text(json.dumps(report))
    return str(path), report


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory, tiny_jax_report):
    """run_parity.main over seeds 0-1 at the tiny protocol: (rc, report path)."""
    out = tmp_path_factory.mktemp("tiny_run") / "whole.json"
    rc = run_parity.main(TINY + ["--seeds", "2", "--jax-report", tiny_jax_report[0],
                                 "--out", str(out)])
    return rc, out


def test_run_parity_main_writes_the_report(tiny_run, tiny_jax_report):
    _jax_path, jax_report = tiny_jax_report
    rc, out = tiny_run
    report = json.loads(out.read_text())
    assert rc == (0 if report["within_tolerance"] else 1)
    assert report["seed_list"] == [0, 1]
    assert report["protocol"]["preset"] == "iemocap" and report["protocol"]["epochs"] == EPOCHS
    assert set(report["metrics"]) == set(run_parity.METRICS)
    (run,) = report["runs"]
    assert run["seeds"] == [0, 1] and run["port_device"] == run["replica_device"] == "cpu"
    assert len(run["port_seconds"]) == len(run["torch_seconds"]) == 2
    for name, row in report["metrics"].items():
        want_jax = jax_report["metrics"][name]
        assert len(row["port_per_seed"]) == len(row["torch_per_seed"]) == 2
        assert row["port_mean"] == pytest.approx(np.mean(row["port_per_seed"]), abs=1e-12)
        assert row["delta_pp"] == pytest.approx(row["port_mean"] - row["torch_mean"], abs=1e-12)
        assert row["jax_mean"] == want_jax["jax_mean"] and row["jax_std"] == want_jax["jax_std"]
        assert row["jax_n"] == 60
        assert row["delta_vs_jax_pp"] == pytest.approx(row["port_mean"] - row["jax_mean"],
                                                       abs=1e-12)
        se = np.sqrt(row["port_std"] ** 2 / 2 + row["jax_std"] ** 2 / 60)
        assert row["delta_vs_jax_se_pp"] == pytest.approx(se, abs=1e-12)
        assert row["delta_vs_jax_t"] == pytest.approx(row["delta_vs_jax_pp"] / se, abs=1e-9)
    assert report["worst_noisy_delta_vs_jax_pp"] == max(
        abs(report["metrics"][m]["delta_vs_jax_pp"]) for m in run_parity.GATED)


def test_run_parity_refuses_a_protocol_mismatch(tmp_path, tiny_jax_report, capsys):
    out = tmp_path / "r.json"
    # the default --jax-report is the committed one, at 40 epochs
    assert run_parity.main(TINY + ["--seeds", "1", "--out", str(out)]) == 2
    assert "--jax-report protocol mismatch on epochs" in capsys.readouterr().err
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"protocol": {"epochs": EPOCHS, "n_clips": N_CORPUS,
                                              "dim": 16, "preset": "iemocap", "fold": 0},
                                 "seed_list": [0], "metrics": {}, "runs": []}))
    assert run_parity.main(TINY + ["--seeds", "1", "--jax-report", tiny_jax_report[0],
                                   "--merge-from", str(other), "--out", str(out)]) == 2
    assert "--merge-from protocol mismatch on dim: 16 != 8" in capsys.readouterr().err
    assert not out.exists()


def test_chunks_merge_into_the_one_run_report(tmp_path, tiny_run, tiny_jax_report):
    """Seed 1 run after seed 0 (``--seed-start``/``--merge-from``), and the
    two chunks run apart then merged with an empty seed range, give the
    one-run report."""
    jax = ["--jax-report", tiny_jax_report[0]]
    first, second, after, merged = (tmp_path / f"{n}.json"
                                    for n in ("first", "second", "after", "merged"))
    run_parity.main(TINY + jax + ["--seeds", "1", "--out", str(first)])
    assert run_parity.main(TINY + jax + ["--seeds", "1", "--merge-from", str(first),
                                         "--out", str(after)]) == 2  # seed 0 again
    run_parity.main(TINY + jax + ["--seed-start", "1", "--seeds", "2", "--merge-from",
                                  str(first), "--out", str(after)])
    run_parity.main(TINY + jax + ["--seed-start", "1", "--seeds", "2", "--out", str(second)])
    run_parity.main(TINY + jax + ["--seed-start", "2", "--seeds", "2", "--merge-from",
                                  str(first), "--merge-from", str(second), "--out", str(merged)])
    whole = json.loads(tiny_run[1].read_text())
    for path in (after, merged):
        got = json.loads(path.read_text())
        assert got["seed_list"] == whole["seed_list"] == [0, 1]
        assert [r["seeds"] for r in got["runs"]] == [[0], [1]]
        for key in ("protocol", "metrics", "worst_noisy_delta_pp",
                    "worst_noisy_delta_vs_jax_pp", "within_tolerance"):
            assert got[key] == whole[key], (path.name, key)
