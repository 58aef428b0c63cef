"""The biased attention kernel's share of its roofline in the traced
stretch, in %: over the attn_fwd_relbias launches of the trace, the summed
least time of each launch (the larger of its bytes over 3.35 TB/s and its
operations over 989 TFLOP/s; q, k, v, out, mask, gate and table, and
4 x H x N x D x valid keys) over their summed device time. A launch's
shapes are those of the program's ``wavlm.encoder`` span (``rows``,
``frames``) whose issue began last before it ran, its valid keys the
``samples`` of that batch's ``serving.assemble`` span.

Read through ``benchmark/lib/wavlm_spans.py``; None where there is nothing
to read."""

from benchmark.lib.wavlm_spans import relbias_roofline_pct


def read(ctx):
    return relbias_roofline_pct(ctx)
