"""The attention kernel's share of its roofline in the traced stretch, in
%: over the attn_fwd kernels of the trace, the summed least time of each
launch (the larger of its bytes over 3.35 TB/s and its operations over
989 TFLOP/s, from its batch's shapes and valid keys; the batch is the
predictor call whose host interval holds the launch) over their summed
device time."""

import bisect


def read(ctx):
    td, calls = ctx.trace_data, ctx.counters.get("calls")
    if td is None or not calls:
        return None
    starts = [c[0] for c in calls]
    bound = kernel_s = 0.0
    for _n, a, b in td.kernels("attn_fwd"):
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or a > calls[i][1]:
            continue
        bound += calls[i][2]
        kernel_s += b - a
    return 100.0 * bound / kernel_s if kernel_s else None
