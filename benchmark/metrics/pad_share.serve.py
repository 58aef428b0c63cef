"""Padded samples over bucket samples of every batch the window ran, in %:
a count from shapes, taken by the benchmark's wrapper of predict_wavs."""

from benchmark.lib.readers import ratio_pct


def read(ctx):
    c = ctx.counters
    return ratio_pct(c.get("pad_samples", 0.0), c.get("bucket_samples", 0.0))
