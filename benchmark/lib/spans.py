"""Host spans recorded from the benchmark's own files, around its calls
into the program's layers, kept in memory for the run."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple


class Spans:
    """(name, start, end) on ``time.monotonic``, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, float, float]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add(name, t0, time.monotonic())

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def at(self, t: float, default: str) -> str:
        """The innermost (latest-starting) span covering ``t``."""
        best: Optional[Tuple[str, float, float]] = None
        with self._lock:
            for item in self.items:
                if item[1] <= t <= item[2] and (best is None or item[1] > best[1]):
                    best = item
        return default if best is None else best[0]

