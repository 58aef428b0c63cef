"""Timing of kernel calls on the card, and the card's clocks beside them.

Four numbers describe one call (``chip_smoke.py`` phase 5 and
``ops/norm_probe.py`` print them):

- ``device_ms``: the card's time for one call without the host's launch cost.
  ``launches`` calls are captured in one CUDA graph and the graph is
  replayed between CUDA events. With ``cold=True`` the calls cycle through
  several input sets (``rotation`` says how many: one rotation moves more
  than ``COLD_BYTES``, four times the H100's 50 MB L2) and every output is
  kept, so no call finds its inputs or its output lines in L2: that is the
  number to hold to the HBM bound. With one set and outputs dropped it is
  the warm number: inputs that fit stay in L2.
- ``call_ms``: CUDA events around ``iters`` calls launched back to back,
  host launch cost included: what a caller that launches eagerly sees.
- ``host_us``: the host clock around ``iters`` calls without a
  synchronisation inside, once the queue is warm: the launch cost alone,
  as long as the device keeps up with fewer than ~1000 queued launches.
- ``ClockSampler``: ``nvidia-smi``'s SM and memory clocks, power draw and
  temperature, sampled every 100 ms in a background process while a
  measurement runs.

Everything but ``rotation`` and ``host_seconds`` needs a CUDA device and
raises without one; nothing here falls back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

L2_BYTES = 50 * 2**20  # H100 SXM
COLD_BYTES = 4 * L2_BYTES


def _need_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} is a device measure and needs a CUDA device")


def rotation(set_bytes: int, min_bytes: int = COLD_BYTES) -> int:
    """Input/output sets one cold rotation needs: at least two, and enough
    that one rotation moves more than ``min_bytes``."""
    return max(2, -(-min_bytes // max(1, set_bytes)))


def device_ms(calls: Sequence[Callable[[], object]], cold: bool, launches: int = 20,
              window_ms: float = 20.0, max_replays: int = 200) -> float:
    """Median device ms of one call, from CUDA-graph replays between events.

    ``calls`` are the same function on different input sets, cycled in
    order; ``cold`` keeps every output alive so that each launch writes
    fresh lines. The graph is replayed until ``window_ms`` of device time
    (at least 5 replays)."""
    _need_cuda("device_ms")
    for fn in calls:  # lazy initialisation and allocator warm-up outside the graph
        fn()
    torch.cuda.synchronize()
    n = -(-max(launches, len(calls)) // len(calls)) * len(calls)
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(n):
            out = calls[i % len(calls)]()
            if cold:
                kept.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call, total = [], 0.0
    while len(per_call) < 5 or (total < window_ms and len(per_call) < max_replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        per_call.append(ms / n)
        total += ms
    del graph, kept
    return statistics.median(per_call)


def call_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of one call from CUDA events around ``iters`` eager calls."""
    _need_cuda("call_ms")
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn: Callable[[], object], iters: int = 200, warmup: int = 5) -> float:
    """Host µs to launch one call: the host clock around ``iters`` calls with
    no synchronisation inside (one before and one after, untimed)."""
    _need_cuda("host_us")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def host_seconds(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean host seconds of one synchronous call (the CPU's own time)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")


class ClockSampler:
    """Samples ``nvidia-smi`` every ``interval_ms`` in one child process
    while the ``with`` block runs; ``summary(t0, t1)`` reads the samples
    taken between two ``time.perf_counter()`` stamps. The child is stopped
    on exit. Samples are empty where ``nvidia-smi`` is missing."""

    def __init__(self, interval_ms: int = 100, gpu: int = 0):
        self.interval_ms, self.gpu = interval_ms, gpu
        self.samples: List[tuple] = []
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None

    def __enter__(self) -> "ClockSampler":
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.interval_ms}",
                 f"--id={self.gpu}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                values = [float(v) for v in line.split(",")]
            except ValueError:
                continue
            if len(values) == len(SMI_FIELDS):
                self.samples.append((time.perf_counter(), *values))

    def __exit__(self, *exc) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._reader.join(timeout=10)

    def summary(self, t0: float = float("-inf"), t1: float = float("inf")) -> Optional[dict]:
        """Min / median / max SM clock (MHz), median memory clock, median and
        max power (W) and max temperature (C) between ``t0`` and ``t1``;
        None if no sample fell there."""
        got = [s[1:] for s in self.samples if t0 <= s[0] <= t1]
        if not got:
            return None
        sm, mem, power, temp = zip(*got)
        return dict(samples=len(got), sm_mhz=[min(sm), statistics.median(sm), max(sm)],
                    mem_mhz=statistics.median(mem),
                    power_w=[statistics.median(power), max(power)], temp_c=max(temp))
