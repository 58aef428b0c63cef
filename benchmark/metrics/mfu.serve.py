"""The encoder and head's matmul and conv FLOPs of every clip at its own
length, over the summed wall time of the predictor's calls, as a share of
989 TFLOP/s, in %."""

from benchmark.lib.readers import mfu_pct


def read(ctx):
    c = ctx.counters
    return mfu_pct(c.get("flops", 0.0), c.get("predict_s", 0.0))
