"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
alone (CUPTI; no CPU-op recording, so the host runs as it does untraced),
exported as a Chrome trace and read back as kernel, copy and fill
intervals on the host's ``time.monotonic`` clock.

A marker kernel (``torch.cuda._sleep``) launched right after an idle
device and a host timestamp ties the device clock to the host's, so that
idle gaps can be named by the benchmark's host span that covered them."""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin"


class TraceData:
    """Device intervals inside a traced window, on the host clock."""

    def __init__(self, ops: List[Tuple[str, str, float, float]], window: Tuple[float, float]):
        self.ops = ops  # (category, name, start, end)
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, fragment: Optional[str] = None) -> List[Tuple[str, float, float]]:
        """Kernel intervals, those whose name holds ``fragment`` if given."""
        return [(n, a, b) for c, n, a, b in self.ops
                if c == "kernel" and (fragment is None or fragment in n)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of every device interval, clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(a, w0), min(b, w1)) for _c, _n, a, b in self.ops if b > w0 and a < w1)
        merged: List[Tuple[float, float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window."""
        out, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def top_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        tot: Dict[str, float] = {}
        for _c, n, a, b in self.ops:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n[:160], s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_span(self, spans, k: int = 10, default: str = "host: outside any span") -> List[list]:
        """Idle seconds by the host span covering each gap's middle: the
        longest first, [name, seconds]."""
        tot: Dict[str, float] = {}
        for a, b in self.gaps():
            name = spans.at(0.5 * (a + b), default)
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


class Tracer:
    """One profiler session a process, started and stopped by the thread
    that made it, each time on a quiet device: ``start()`` before the
    window (CUPTI's start-up takes seconds and holds the interpreter),
    ``stop()`` at the end of the traced stretch or of the window;
    ``read(lo, hi)`` then gives the device intervals between ``lo`` and
    ``hi``. The trace file goes to the temporary directory and is deleted
    once read."""

    def __init__(self):
        self._prof = None
        self._marker_host = 0.0
        self._t_stop = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._marker_host = time.monotonic()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._t_stop = time.monotonic()
        self._prof.stop()

    def read(self, lo: float, hi: float = float("inf")) -> TraceData:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        raw = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
               for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marker = min((r for r in raw if r[0] == "kernel" and MARKER in r[1]),
                     key=lambda r: r[2], default=None)
        if marker is None:
            raise RuntimeError("device trace holds no marker kernel: the profiler "
                               "recorded no CUDA activity")
        base = marker[2]
        ops = []
        for r in raw:
            if r is marker:
                continue
            a = self._marker_host + (r[2] - base) * 1e-6
            b = self._marker_host + (r[3] - base) * 1e-6
            hi = min(hi, self._t_stop)
            if b > lo and a < hi:
                ops.append((r[0], r[1], max(a, lo), min(b, hi)))
        ops.sort(key=lambda o: o[2])
        return TraceData(ops, (lo, min(hi, self._t_stop)))
