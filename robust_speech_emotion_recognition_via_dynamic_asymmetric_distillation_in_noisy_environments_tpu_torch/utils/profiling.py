"""Profiling and throughput instrumentation.

- ``trace(logdir)``: a ``torch.profiler`` trace of the block (the host, and
  the card where there is one), written to ``logdir/trace.json`` for
  chrome://tracing or Perfetto.
- ``StepTimer``: steady-state step time + clips/sec, excluding the first
  steps (warm-up: kernel builds, allocator growth). It synchronises CUDA
  at both ends of a step, so a step's time is the card's too.
- ``device_memory_stats``: per-device memory in use, its peak and the
  device's size, from ``torch.cuda.memory_stats``.
- ``Recorder``: the program's spans, always on. ``RECORDER`` is the
  process's own, and ``span``, ``add_span`` and ``spans`` are its methods.
  Spans are taken on ``time.monotonic``, the clock a device trace can be
  mapped onto, and kept in a bounded ring in memory. Recording only reads
  the host clock: it never synchronises the device or reads a device
  value, so a span around asynchronous work measures the time to issue it
  (and any wait the work itself makes).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self._times.append(time.perf_counter() - self._t0)
        return False

    @property
    def steady_times(self) -> List[float]:
        return self._times[self.skip_first:]

    def mean_step_time(self) -> float:
        ts = self.steady_times
        return sum(ts) / len(ts) if ts else float("nan")

    def clips_per_sec(self, clips_per_step: int) -> float:
        t = self.mean_step_time()
        return clips_per_step / t if t > 0 else float("nan")

    def summary(self, clips_per_step: Optional[int] = None) -> Dict:
        out = {
            "steps": len(self._times),
            "mean_step_s": self.mean_step_time(),
            "first_step_s": self._times[0] if self._times else None,
        }
        if clips_per_step:
            out["clips_per_sec"] = self.clips_per_sec(clips_per_step)
        return out


def device_memory_stats() -> Dict[str, Dict]:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for every
    CUDA device; empty without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


_clock = time.monotonic


class Span(NamedTuple):
    """One recorded interval, ``start``/``end`` on ``time.monotonic``."""

    name: str
    start: float
    end: float
    attrs: Dict[str, Any]  # ints, or a tuple of ints (one a row)


class _OpenSpan:
    """``with recorder.span(name, **attrs):`` — the block as one span."""

    __slots__ = ("_rec", "_name", "_attrs", "_t0")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict[str, Any]):
        self._rec, self._name, self._attrs = rec, name, attrs

    def __enter__(self) -> "_OpenSpan":
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self._rec._append(Span(self._name, self._t0, _clock(), self._attrs))
        return False


class Recorder:
    """Spans of one process, in a ring of ``capacity``: once it is full
    each new span drops the oldest, and ``dropped`` counts them."""

    def __init__(self, capacity: int = 131072):
        self._ring: Deque[Span] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self._lost_until = float("-inf")  # the latest end of a dropped span

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                self._lost_until = max(self._lost_until, self._ring[0].end)
            self._ring.append(span)

    def span(self, name: str, **attrs: Any) -> _OpenSpan:
        """A context manager recording its block as the span ``name``."""
        return _OpenSpan(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Records a span whose ends were taken elsewhere (on
        ``time.monotonic``), such as in two threads."""
        self._append(Span(name, t0, t1, attrs))

    def spans(self, lo: float = float("-inf"), hi: float = float("inf")) -> List[Span]:
        """The kept spans that overlap [lo, hi], in the order recorded."""
        with self._lock:
            kept = list(self._ring)
        return [s for s in kept if s.end >= lo and s.start <= hi]

    def intact_since(self, t: float) -> bool:
        """True when no span that ended at or after ``t`` was dropped."""
        with self._lock:
            return self._lost_until < t


RECORDER = Recorder()
span = RECORDER.span
add_span = RECORDER.add_span
spans = RECORDER.spans
