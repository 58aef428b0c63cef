"""The program's own spans laid over a device trace: the port's span
recorder (``utils/profiling.py``), read in the process the program
recorded into, on the ``time.monotonic`` clock the trace is mapped onto.
A program without the recorder, a run without a trace, or a stretch from
which spans were dropped gives None."""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence, Tuple

from .harness import PORT_PACKAGE
from .trace import TraceData

Intervals = List[Tuple[float, float]]


def window_spans(ctx, names: Sequence[str], hi: Optional[float] = None) -> Optional[list]:
    """The recorder's spans of ``names`` that overlap [the traced window's
    start, ``hi``] (by default the window's end); None without a trace,
    without the recorder, or where a span that ended after the window's
    start was dropped."""
    prof = importlib.import_module(f"{PORT_PACKAGE}.utils.profiling")
    rec, td = getattr(prof, "RECORDER", None), ctx.trace_data
    if rec is None or td is None or td.window_s <= 0 or not rec.intact_since(td.window[0]):
        return None
    return [s for s in rec.spans(td.window[0], td.window[1] if hi is None else hi)
            if s.name in names]


def overlap(a: Intervals, b: Intervals) -> float:
    """Seconds common to two lists of sorted disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(ctx, names: Sequence[str]) -> Optional[float]:
    """The device's idle gaps inside the union of the spans of ``names``,
    in % of the traced window; None where there are no such spans."""
    spans = window_spans(ctx, names)
    if not spans:
        return None
    td = ctx.trace_data
    # the union of the spans, clipped to the window, as the trace merges
    # its own intervals
    inside = TraceData([("", s.name, s.start, s.end) for s in spans], td.window).busy_intervals()
    return 100.0 * overlap(inside, td.gaps()) / td.window_s
