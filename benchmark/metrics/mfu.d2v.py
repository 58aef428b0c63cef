"""The d2v update's matmul and conv FLOPs (from its shapes) times the steps
of the window, over the window (less the profiler's stop in a traced run),
as a share of 989 TFLOP/s, in %."""

from benchmark.lib.readers import mfu_pct


def read(ctx):
    c = ctx.counters
    return mfu_pct(c.get("step_flops", 0.0) * c.get("steps", 0), c.get("window_s", 0.0))
