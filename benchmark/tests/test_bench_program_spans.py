"""The readers of the program's spans (``metrics/*`` with source
``program_span``, through ``lib/program_spans.py``) against hand-worked
cases: a synthetic device trace, synthetic spans in a recorder of the
port's own type, idle gaps intersected with span unions, the queue wait's
nearest rank, and None without a trace, without the recorder or after
drops."""

import importlib
from types import SimpleNamespace

import pytest

from benchmark.lib.harness import PORT_PACKAGE, load_reader
from benchmark.lib.program_spans import overlap
from benchmark.lib.trace import TraceData

IDLE = ("idle_with_work.serve", "idle_collecting.serve", "idle_in_batch_host.serve",
        "idle_in_update.d2v", "idle_in_loss.d2v")
ALL = IDLE + ("queue_wait_p95.serve",)


@pytest.fixture
def prof():
    return importlib.import_module(f"{PORT_PACKAGE}.utils.profiling")


@pytest.fixture
def rec(prof, monkeypatch):
    """A fresh recorder in the place of the process's own."""
    r = prof.Recorder()
    monkeypatch.setattr(prof, "RECORDER", r)
    return r


def trace():
    """Window (0, 10), busy 1-3 and 5-6: idle 0-1, 3-5 and 6-10 (7 s)."""
    ops = [("kernel", "a", 1.0, 2.0), ("gpu_memcpy", "b", 1.5, 3.0), ("kernel", "c", 5.0, 6.0)]
    return SimpleNamespace(trace_data=TraceData(ops, (0.0, 10.0)))


def test_the_synthetic_trace_has_the_gaps_worked_by_hand():
    assert trace().trace_data.gaps() == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]


@pytest.mark.parametrize("metric, spans, want", [
    # the union 0.5-7 over the gaps: 0.5 + 2 + 1; the span past the
    # window and the other name are left out
    ("idle_with_work.serve", [("serving.request", 0.5, 4.0), ("serving.request", 3.5, 7.0),
                              ("serving.request", 11.0, 12.0), ("serving.batch", 0.0, 10.0)], 35.0),
    # a span reaching in from before the window counts inside it only
    ("idle_collecting.serve", [("serving.collect", -3.0, 2.0), ("serving.collect", 5.2, 5.8)], 10.0),
    # two names: 0.2 in 3-5, and 0.5 + 0 of 4.5-5.5
    ("idle_in_batch_host.serve", [("serving.assemble", 3.2, 3.4), ("serving.results", 4.5, 5.5),
                                  ("serving.queue", 0.0, 10.0)], 7.0),
    ("idle_in_update.d2v", [("d2v_pretrain.update", 6.5, 8.0)], 15.0),
    ("idle_in_loss.d2v", [("d2v_pretrain.loss", 2.0, 6.2), ("d2v_pretrain.update", 0.0, 10.0)], 22.0),
])
def test_idle_inside_spans_hand_cases(rec, metric, spans, want):
    for name, a, b in spans:
        rec.add_span(name, a, b)
    assert load_reader(metric).read(trace()) == pytest.approx(want)


def test_queue_wait_is_the_nearest_rank_p95(rec):
    # 20 requests put at 1.0 .. 2.9, waits 1 .. 20 ms to their batch's start:
    # rank ceil(0.95 x 20) = 19
    for i in range(20):
        t = 1.0 + 0.1 * i
        rec.add_span("serving.batch", t + (i + 1) * 1e-3, t + 0.05, batch=100 + i)
        rec.add_span("serving.queue", t, t + 1e-4, batch=100 + i)
    # put before the window, its batch inside: not counted
    rec.add_span("serving.batch", 0.5, 0.6, batch=7)
    rec.add_span("serving.queue", -1.0, -0.9, batch=7)
    # a request whose batch failed (no batch span): not counted
    rec.add_span("serving.queue", 4.0, 4.1, batch=0)
    assert load_reader("queue_wait_p95.serve").read(trace()) == pytest.approx(19.0)


def test_queue_wait_reads_a_batch_that_starts_after_the_window(rec):
    # put at 9.9, its batch starts at 10.5: a wait of 600 ms
    rec.add_span("serving.queue", 9.9, 9.95, batch=3)
    rec.add_span("serving.batch", 10.5, 10.6, batch=3)
    assert load_reader("queue_wait_p95.serve").read(trace()) == pytest.approx(600.0)


@pytest.mark.parametrize("metric", ALL)
def test_none_without_a_trace_or_spans(rec, metric):
    reader = load_reader(metric)
    assert reader.read(SimpleNamespace(trace_data=None)) is None
    assert reader.read(trace()) is None  # an empty recorder


@pytest.mark.parametrize("metric", ALL)
def test_none_without_the_recorder(prof, monkeypatch, metric):
    # a program that records nothing: its profiling module has no RECORDER
    monkeypatch.delattr(prof, "RECORDER")
    assert load_reader(metric).read(trace()) is None


SPANS = [("serving.request", 0.5, 4.0), ("serving.collect", 0.2, 0.8),
         ("serving.assemble", 3.2, 3.4), ("d2v_pretrain.update", 6.5, 8.0),
         ("d2v_pretrain.loss", 2.0, 6.2), ("serving.batch", 1.01, 1.2),
         ("serving.queue", 1.0, 1.001)]


@pytest.mark.parametrize("metric", ALL)
def test_none_after_drops_inside_the_stretch(prof, monkeypatch, metric):
    rec = prof.Recorder(capacity=len(SPANS))
    monkeypatch.setattr(prof, "RECORDER", rec)
    rec.add_span("old", -5.0, -4.0)  # dropped, but ended before the window
    for name, a, b in SPANS:
        attrs = {"batch": 1} if name in ("serving.batch", "serving.queue") else {}
        rec.add_span(name, a, b, **attrs)
    reader = load_reader(metric)
    assert rec.dropped == 1
    assert reader.read(trace()) is not None
    rec.add_span("late", 9.0, 9.5)  # drops a span that ended inside the window
    assert reader.read(trace()) is None


@pytest.mark.parametrize("a, b, want", [
    ([(0, 1), (2, 3)], [(0.5, 2.5)], 1.0),
    ([(0, 10)], [(1, 2), (3, 4), (9, 12)], 3.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([], [(0, 1)], 0.0),
])
def test_overlap_of_interval_sets(a, b, want):
    assert overlap(a, b) == pytest.approx(want)
    assert overlap(b, a) == pytest.approx(want)


def test_overlapping_and_nested_spans_count_once(rec):
    # 3.2-4.6 and 4.0-4.4 and 4.5-7: one union 3.2-7 over the gaps 3-5
    # and 6-10: 1.8 + 1 of 10 s
    for a, b in ((3.2, 4.6), (4.0, 4.4), (4.5, 7.0)):
        rec.add_span("serving.collect", a, b)
    assert load_reader("idle_collecting.serve").read(trace()) == pytest.approx(28.0)
