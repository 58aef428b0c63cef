"""Profiling and throughput instrumentation.

- ``trace(logdir)``: a ``torch.profiler`` trace of the block (the host, and
  the card where there is one), written to ``logdir/trace.json`` for
  chrome://tracing or Perfetto.
- ``StepTimer``: steady-state step time + clips/sec, excluding the first
  steps (warm-up: kernel builds, allocator growth). It synchronises CUDA
  at both ends of a step, so a step's time is the card's too.
- ``device_memory_stats``: per-device memory in use, its peak and the
  device's size, from ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

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
