"""Requests per micro-batch slot: the port's counters over the window,
requests_served / (batches_run x max_batch), in %."""

from benchmark.lib.readers import ratio_pct


def read(ctx):
    c = ctx.counters
    return ratio_pct(c.get("requests_served", 0), c.get("batches_run", 0) * c.get("max_batch", 0))
