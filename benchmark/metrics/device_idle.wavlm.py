"""The device's idle share of the traced stretch of WavLM serving, in %."""

from benchmark.lib.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
