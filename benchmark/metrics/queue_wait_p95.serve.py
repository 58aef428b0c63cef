"""How long a request waited before its batch began, in ms: the
nearest-rank 95th percentile, over the requests put on the queue inside
the traced stretch, of each program ``serving.queue`` span's start (the
handler's put) to the start of the ``serving.batch`` span its ``batch``
names.

Read from the port's span recorder (``benchmark/lib/program_spans.py``);
None where there is nothing to read."""

from benchmark.lib.program_spans import window_spans
from benchmark.lib.stats import percentile


def read(ctx):
    # a batch may start after the window that its request was put in
    kept = window_spans(ctx, ("serving.queue", "serving.batch"), hi=float("inf"))
    if kept is None:
        return None
    lo, hi = ctx.trace_data.window
    starts = {s.attrs["batch"]: s.start for s in kept if s.name == "serving.batch"}
    waits = [starts[s.attrs["batch"]] - s.start for s in kept
             if s.name == "serving.queue" and lo <= s.start <= hi and s.attrs["batch"] in starts]
    return 1e3 * percentile(waits, 95) if waits else None
