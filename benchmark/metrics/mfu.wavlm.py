"""WavLM's encoder and head FLOPs of every clip at its own length (matmuls
and convolutions; each row's ``samples`` on the program's
``serving.assemble`` span, through the conv front end) over the wall time
of the ``serving.batch`` spans that hold the ``wavlm.encoder`` spans, for
the batches inside the traced stretch, as a share of 989 TFLOP/s, in %.

Read through ``benchmark/lib/wavlm_spans.py``; None where there is nothing
to read."""

from benchmark.lib.wavlm_spans import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
