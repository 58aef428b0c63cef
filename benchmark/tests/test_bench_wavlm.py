"""The WavLM serving cell on the CPU at a tiny size: the program against
the plain reference (correct), the float8 control and the two planted
faults against it (not correct), the operation counts, and the cell's
readers against hand-worked spans and traces."""

import copy
import importlib
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import harness, wavlm_ops, wavlm_spans
from benchmark.lib.harness import PORT_PACKAGE, load_reader
from benchmark.lib.trace import TraceData
from benchmark.tests import tiny

CELL = "serve.wavlm-long"
READERS = ("relbias_attn_roofline.wavlm", "relbias_share.wavlm", "mfu.wavlm", "device_idle.wavlm")


def wavlm_cell():
    """(config, workload) of serve.wavlm-long cut for the CPU: 32 wide, 2
    heads, 2 layers, a narrow conv front end, a kernel-16 positional conv,
    0.1-0.5 s clips in 0.25 and 0.5 s buckets, 20 requests a second,
    float32."""
    cfg = copy.deepcopy(tiny.load("configs", "wavlm-large.ser"))
    cfg["encoder"].update(embed_dim=32, num_heads=2, depth=2, conv_feature_layers=tiny.CONV,
                          conv_pos_width=16, conv_pos_groups=4, dtype="float32")
    cfg["head"].update(input_dim=32, hidden_dim=8)
    wl = copy.deepcopy(tiny.load("workloads", CELL))
    wl["params"].update(rate_rps=20.0, buckets_s=[0.25, 0.5], connections=16, sample=6,
                        lengths={"mean_s": 0.25, "sigma": 0.6, "min_s": 0.1, "max_s": 0.5})
    wl["trace"] = {"lead_s": 0.5, "length_s": 0.5}
    return cfg, wl


@pytest.fixture
def tiny_head(monkeypatch):
    """The program's WavLM head preset at the tiny cell's widths."""
    configs = importlib.import_module(f"{PORT_PACKAGE}.configs")
    preset = configs.dad_preset
    monkeypatch.setattr(configs, "dad_preset", lambda *a, **k: preset(
        *a, **{**k, "input_dim": 32, "hidden_dim": 8}))


def run(cfg, wl, seed=2**31 + 19):
    return harness.run_cell(CELL, seed, 1.5, False, device="cpu", config=cfg, workload=wl)


def test_wavlm_cell_on_cpu_is_correct(tiny_head):
    cfg, wl = wavlm_cell()
    r = run(cfg, wl)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 30
    assert r["checks"]["prob_gap"]["value"] < 1e-5
    assert r["checks"]["feat_gap"]["value"] < 1e-5
    assert set(r["metrics"]) == {"serve_p95_ms", "serve_rps", "setup_s"}


@pytest.mark.parametrize("what", ["nobias", "gate1"])
def test_wavlm_faults_are_not_correct(tiny_head, what):
    import benchmark.control_wavlm as control

    cfg, wl = wavlm_cell()
    with control.fault(what):
        r = run(cfg, wl)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2])
def test_wavlm_control_fails_a_limit(seed):
    import benchmark.control_wavlm as control

    cfg, wl = wavlm_cell()
    ctx = harness.Context(CELL, {}, wl, cfg, seed, 1.5, False, "cpu", 0.0)
    got = control.control(ctx, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


def test_front_end_lengths_give_the_frames():
    conv = tiny.load("configs", "wavlm-large.ser")["encoder"]["conv_feature_layers"]
    for frames in (1, 199, 1499):
        lens = wavlm_ops.front_end_lengths(frames, conv)
        n = lens[0] * conv[0][2] + conv[0][1] - conv[0][2]  # a layer-0 input giving lens[0]
        for (_d, k, s), want in zip(conv, lens):
            n = (n - k) // s + 1
            assert n == want
        assert lens[-1] == frames


def test_wavlm_large_flops_at_30_s():
    enc = tiny.load("configs", "wavlm-large.ser")["encoder"]
    f = wavlm_ops.encoder_flops(enc, 1499)
    # worked by hand: 24 layers' weights (25.2 MFLOP a frame each) 0.906
    # TFLOP, QK^T and PV 0.221, the positional conv 0.025, the projection
    # 0.0016, the front end 0.147 (75.5 GFLOP in its second layer alone)
    assert f == pytest.approx(1.3007e12, rel=2e-3)
    assert wavlm_ops.encoder_flops(enc, 0) == 0.0


@pytest.fixture
def rec(monkeypatch):
    prof = importlib.import_module(f"{PORT_PACKAGE}.utils.profiling")
    r = prof.Recorder()
    monkeypatch.setattr(prof, "RECORDER", r)
    return r


def ctx_with(ops, window=(0.0, 10.0)):
    cfg = tiny.load("configs", "wavlm-large.ser")
    return SimpleNamespace(trace_data=TraceData(ops, window), config=cfg, counters={})


def test_readers_on_hand_worked_spans(rec):
    # two batches: encoder spans issued at 1.0 and 5.0, their kernels after
    # (30 s clips give 1499 frames, 16 s clips 799; the second batch holds 8)
    rec.add_span("serving.batch", 0.9, 3.0, batch=1)
    rec.add_span("serving.assemble", 0.92, 0.98, samples=(480000,) * 16)
    rec.add_span("wavlm.encoder", 1.0, 1.2, rows=16, frames=1499)
    rec.add_span("serving.batch", 4.9, 9.0, batch=2)
    rec.add_span("serving.assemble", 4.92, 4.98, samples=(256000,) * 8)
    rec.add_span("wavlm.encoder", 5.0, 5.1, rows=16, frames=799)
    ops = [("kernel", "attn_fwd_relbias_bf16_kernel", 1.5, 1.5005),
           ("kernel", "attn_fwd_relbias_bf16_kernel", 5.5, 5.5001),
           ("kernel", "gemm", 1.5005, 2.5005)]
    ctx = ctx_with(ops)
    b1 = wavlm_ops.relbias_attention_bound_s(16, 16, 1499, 64, 16 * 1499)
    b2 = wavlm_ops.relbias_attention_bound_s(16, 16, 799, 64, 8 * 799)
    want = 100 * (b1 + b2) / (0.0005 + 0.0001)
    assert load_reader("relbias_attn_roofline.wavlm").read(ctx) == pytest.approx(want)
    assert load_reader("relbias_share.wavlm").read(ctx) == pytest.approx(
        100 * 0.0006 / (1.0006))
    enc, head = ctx.config["encoder"], ctx.config["head"]
    flops = (16 * wavlm_ops.clip_flops(enc, head, 1499)
             + 8 * wavlm_ops.clip_flops(enc, head, 799))
    assert load_reader("mfu.wavlm").read(ctx) == pytest.approx(
        100 * flops / (2.1 + 4.1) / 989e12)
    assert load_reader("device_idle.wavlm").read(ctx) == pytest.approx(100 * (1 - 1.0006 / 10))


def test_encoder_span_without_its_own_assembly_is_left_out(rec):
    # a forward off the serving path (after the batch) finds no assembly
    rec.add_span("serving.assemble", 0.92, 0.98, samples=(480000, 256000))
    rec.add_span("wavlm.encoder", 1.0, 1.2, rows=16, frames=1499)
    rec.add_span("wavlm.encoder", 2.0, 2.2, rows=16, frames=1499)
    found = wavlm_spans.encoder_batches(ctx_with([]))
    assert [(s.start, valid) for s, valid in found] == [(1.0, (1499, 799))]


def test_readers_give_none_without_spans_or_trace(rec):
    ctx = ctx_with([("kernel", "gemm", 1.0, 2.0)])
    for name in READERS[:3]:
        assert load_reader(name).read(ctx) is None
    nothing = SimpleNamespace(trace_data=None, config=ctx.config, counters={})
    for name in READERS:
        assert load_reader(name).read(nothing) is None
