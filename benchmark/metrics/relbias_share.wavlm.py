"""The biased attention kernel's (attn_fwd_relbias) device time over the
device's busy time in the traced stretch, in %.

Read through ``benchmark/lib/wavlm_spans.py``; None where there is nothing
to read."""

from benchmark.lib.wavlm_spans import relbias_share_pct


def read(ctx):
    return relbias_share_pct(ctx)
