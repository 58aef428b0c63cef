"""The harness end to end on the CPU at tiny sizes: the program against the
plain reference (correct), the control and every planted fault against
it (not correct), and the check that no JAX module is loaded."""

import subprocess
import sys

import pytest
import torch

from benchmark.lib import harness
from benchmark.reference import nn as rnn
from benchmark.tests import tiny

SERVE, D2V, DAD = "serve.iemocap-mix", "d2v.pretrain-10s", "dad.iemocap-features"
PORT = harness.PORT_PACKAGE


def run(name, cfg, wl, seed=2**31 + 11, seconds=1.5):
    bench = tiny.bench_with_dad() if name == DAD else None
    return harness.run_cell(name, seed, seconds, False, device="cpu", config=cfg, workload=wl,
                            bench=bench)


def test_fp8_rounds_to_e4m3():
    x = torch.tensor([1.0, 0.3, -448.0, 17.0])
    y = rnn.fp8(x)
    assert y[2] == -448.0 and y[0] == 1.0
    assert 0 < abs(float(y[1]) - 0.3) <= 0.3 / 16
    assert torch.equal(rnn.exact(x), x)


def test_serve_cell_on_cpu_is_correct():
    cfg, wl = tiny.serve_cell()
    r = run(SERVE, cfg, wl)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 30
    assert r["checks"]["prob_gap"]["value"] < 1e-5
    assert set(r["metrics"]) == {"serve_p95_ms", "serve_rps", "setup_s"}
    assert list(r)[-1] == "checks"


def test_d2v_cell_on_cpu_is_correct():
    cfg, wl = tiny.d2v_cell()
    r = run(D2V, cfg, wl)
    assert r["correct"], r["checks"]
    assert r["checks"]["grad_gap"]["value"] < 1e-4
    assert set(r["metrics"]) == {"d2v_tokens_per_s", "setup_s"}


def test_dad_cell_on_cpu_is_correct():
    cfg, wl = tiny.dad_cell()
    r = run(DAD, cfg, wl)
    assert r["correct"], r["checks"]
    assert r["checks"]["val_mismatch"]["value"] == 0.0
    assert set(r["metrics"]) == {"dad_clips_per_s", "setup_s"}


def altered_answers(monkeypatch):
    """Every answer altered where it is produced: the logits shifted."""
    serving = __import__(f"{PORT}.eval.serving", fromlist=["x"])
    orig = serving.EmotionPredictor._wav_eval

    def wav_eval(self, wav, mask):
        out = orig(self, wav, mask).clone()
        out[:, 0] += 1.0
        return out

    monkeypatch.setattr(serving.EmotionPredictor, "_wav_eval", wav_eval)


def half_batch_serve(monkeypatch):
    """Half of each batch's requests left out: they get the first one's
    answer."""
    serving = __import__(f"{PORT}.eval.serving", fromlist=["x"])
    orig = serving.EmotionPredictor._wav_eval

    def wav_eval(self, wav, mask):
        real = int((~mask).any(dim=1).sum())
        h = max(1, (real + 1) // 2)
        out = orig(self, wav[:h], mask[:h])
        return torch.cat([out, out[:1].expand(wav.shape[0] - h, -1)])

    monkeypatch.setattr(serving.EmotionPredictor, "_wav_eval", wav_eval)


@pytest.mark.parametrize("fault", [altered_answers, half_batch_serve])
def test_serve_faults_are_not_correct(monkeypatch, fault):
    cfg, wl = tiny.serve_cell()
    # every request of the tiny window, coalesced into batches of several
    wl["params"].update(sample=120, rate_rps=80.0, max_wait_ms=60.0)
    fault(monkeypatch)
    r = run(SERVE, cfg, wl)
    assert not r["correct"], r["checks"]


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged (with its metrics)."""
    resident = __import__(f"{PORT}.parallel.resident", fromlist=["x"])
    make = resident.make_resident_d2v_step

    def factory(model, tx):
        step = make(model, tx)

        def faulty(state, *a, **k):
            _new, metrics = step(state, *a, **k)
            return state, metrics
        return faulty

    monkeypatch.setattr(resident, "make_resident_d2v_step", factory)


def half_batch_d2v(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    d2v_models = __import__(f"{PORT}.models.d2v_pretrain", fromlist=["x"])
    make = d2v_models.make_d2v_train_step

    def factory(model, tx):
        step = make(model, tx)

        def faulty(state, wav, pad, generator=None, draws=None):
            h = wav.shape[0] // 2
            if draws is not None:
                r = h * model.pcfg.clone_batch
                draws = draws._replace(mask=tuple(u[:r] for u in draws.mask),
                                       din=draws.din[:r], dtok=draws.dtok[:r])
            return step(state, wav[:h], pad[:h], generator, draws)
        return faulty

    monkeypatch.setattr(d2v_models, "make_d2v_train_step", factory)


def unchanged_ema(monkeypatch):
    """A step that leaves the teacher's EMA copies as they were."""
    resident = __import__(f"{PORT}.parallel.resident", fromlist=["x"])
    make = resident.make_resident_d2v_step

    def factory(model, tx):
        step = make(model, tx)

        def faulty(state, *a, **k):
            new, metrics = step(state, *a, **k)
            return new._replace(ema_blocks=state.ema_blocks), metrics
        return faulty

    monkeypatch.setattr(resident, "make_resident_d2v_step", factory)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch_d2v, unchanged_ema])
def test_d2v_faults_are_not_correct(monkeypatch, fault):
    cfg, wl = tiny.d2v_cell()
    fault(monkeypatch)
    r = run(D2V, cfg, wl)
    assert not r["correct"], r["checks"]


def dad_step_fault(monkeypatch, fault):
    """The resident DAD step's factory wrapped: ``fault(step, state, args,
    kwargs)`` gives its result."""
    trainer = __import__(f"{PORT}.train.dad_trainer", fromlist=["x"])
    make = trainer.make_resident_dad_step

    def factory(head, tx, cfg):
        step = make(head, tx, cfg)
        return lambda state, *a, **k: fault(step, state, a, k)

    monkeypatch.setattr(trainer, "make_resident_dad_step", factory)


def unchanged_state_dad(monkeypatch):
    """A step that returns its state unchanged (with its metrics)."""
    def fault(step, state, a, k):
        _new, metrics, tracking = step(state, *a, **k)
        return state, metrics, tracking
    dad_step_fault(monkeypatch, fault)


def unchanged_teacher_dad(monkeypatch):
    """A step that leaves the teacher where it was."""
    def fault(step, state, a, k):
        new, metrics, tracking = step(state, *a, **k)
        return new._replace(ssrl=new.ssrl._replace(teacher=state.ssrl.teacher)), metrics, tracking
    dad_step_fault(monkeypatch, fault)


def half_batch_dad(monkeypatch):
    """Half of each batch left out, the means taken over the rest."""
    def fault(step, state, a, k):
        clean_c, noisy_c, cidx, nidx = a[:4]
        h = cidx.shape[0] // 2
        draws = a[7] if len(a) > 7 else k.get("draws")

        def cut(b):
            d = draws(b) if draws is not None else None
            if d is None:
                return None
            rows = (lambda x: None if x is None else x[:h])
            return d._replace(weak=rows(d.weak), clean_keep=rows(d.clean_keep),
                              strong_keep=rows(d.strong_keep),
                              strong=d.strong._replace(noise=rows(d.strong.noise),
                                                       start=rows(d.strong.start)))
        a = (clean_c, noisy_c, cidx[:h], nidx[:h]) + tuple(a[4:7])
        k = dict(k, draws=cut if draws is not None else None)
        return step(state, *a, **k)
    dad_step_fault(monkeypatch, fault)


def altered_predictions_dad(monkeypatch):
    """Every validation prediction altered where it is produced."""
    trainer = __import__(f"{PORT}.train.dad_trainer", fromlist=["x"])
    make = trainer.make_eval_step

    def factory(head):
        fwd = make(head)

        def faulty(params, feats, mask):
            preds, logits = fwd(params, feats, mask)
            return (preds + 1) % logits.shape[-1], logits
        return faulty

    monkeypatch.setattr(trainer, "make_eval_step", factory)


@pytest.mark.parametrize("fault", [unchanged_state_dad, unchanged_teacher_dad, half_batch_dad,
                                   altered_predictions_dad])
def test_dad_faults_are_not_correct(monkeypatch, fault):
    cfg, wl = tiny.dad_cell()
    fault(monkeypatch)
    r = run(DAD, cfg, wl)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dad_control_fails_a_limit(seed):
    import benchmark.control as control

    cfg, wl = tiny.dad_cell()
    ctx = harness.Context(DAD, {}, wl, cfg, seed, 1.0, False, "cpu", 0.0)
    got = control.control_dad(ctx, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_fails_the_limit(seed):
    import benchmark.control as control

    cfg, wl = tiny.serve_cell()
    ctx = harness.Context(SERVE, {}, wl, cfg, seed, 1.5, False, "cpu", 0.0)
    got = control.control_serve(ctx, torch.device("cpu"))
    assert got["prob_gap"] > wl["limits"]["prob_gap"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_d2v_control_fails_a_limit(seed):
    import benchmark.control as control

    cfg, wl = tiny.d2v_cell()
    ctx = harness.Context(D2V, {}, wl, cfg, seed, 1.0, False, "cpu", 0.0)
    got = control.control_d2v(ctx, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, harness.JAX_PACKAGE + ".models", object())
    assert harness.forbidden_modules() == [harness.JAX_PACKAGE]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == sorted(["jax", harness.JAX_PACKAGE])


def test_a_reader_that_loads_jax_fails_the_run(monkeypatch, tmp_path, capsys):
    """A per-layer reader that imports a module named ``jax`` (a stub) is
    caught after the readers have run: exit 3, no result line."""
    (tmp_path / "jax.py").write_text("")
    readers = tmp_path / "metrics"
    readers.mkdir()
    cfg, wl = tiny.d2v_cell()
    for m in harness.cell_metrics(harness.load_json(harness.ROOT / "BENCHMARK.json"), D2V)[1]:
        (readers / f"{m['name']}.py").write_text("import jax\n\ndef read(ctx):\n    return None\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(harness, "METRICS_DIR", readers)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = harness.main(["--workload", D2V, "--seed", "3", "--seconds", "1", "--trace", "1"],
                          device="cpu", config=cfg, workload=wl)
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 3 and out.out.strip() == ""
    assert "jax" in out.err


def test_harness_and_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.traffic.serve, benchmark.traffic.d2v, benchmark.traffic.dad\n"
            "import benchmark.control\n"
            "from benchmark.lib import harness\n"
            "import importlib; [importlib.import_module(f'{harness.PORT_PACKAGE}.' + m) for m in\n"
            " ('eval.serving', 'models.extract', 'models.convert', 'models.d2v_pretrain',\n"
            "  'parallel.resident', 'train.d2v_pretrain', 'train.dad_trainer')]\n"
            "print(harness.forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", SERVE,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", [SERVE, D2V])
def test_cell_on_the_card(cuda_card, name):
    harness.set_cache_dirs()
    r = harness.run_cell(name, 2**31 + 101, 5.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
