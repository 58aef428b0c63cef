"""The WavLM cell's readers over the program's spans (``utils/profiling.py``:
``wavlm.encoder``, with ``rows`` and ``frames``; ``serving.assemble``,
with each row's ``samples``; ``serving.batch``) and the device trace. A
program without the recorder or without those spans, a run without a
trace, or a stretch from which spans were dropped gives None."""

from __future__ import annotations

import bisect
import importlib
from typing import List, Optional, Tuple

from . import roofline, wavlm_ops
from .harness import PORT_PACKAGE

KERNEL = "attn_fwd_relbias"
# a batch's kernels run after its issue: encoder spans are taken from this
# long before the traced window
LEAD_S = 5.0


def _spans(ctx, name: str, lead: float = 0.0) -> Optional[list]:
    """The recorder's spans of ``name`` overlapping [window start - lead,
    window end], in start order; None where they cannot be read."""
    prof = importlib.import_module(f"{PORT_PACKAGE}.utils.profiling")
    rec, td = getattr(prof, "RECORDER", None), ctx.trace_data
    if rec is None or td is None or td.window_s <= 0:
        return None
    lo, hi = td.window[0] - lead, td.window[1]
    if not rec.intact_since(lo):
        return None
    return sorted((s for s in rec.spans(lo, hi) if s.name == name), key=lambda s: s.start)


def encoder_batches(ctx, lead: float = 0.0) -> Optional[List[Tuple[object, Tuple[int, ...]]]]:
    """(``wavlm.encoder`` span, each row's valid frames) of the batches
    issued from ``lead`` before the traced stretch to its end. A batch's
    rows are the ``samples`` of the ``serving.assemble`` span that ended
    last before its encoder span began (the dispatcher assembles a batch,
    then issues its forward), each through the conv front end; an encoder
    span with no such assembly of its own (a forward off the serving path)
    is left out. None where the spans cannot be read."""
    enc = _spans(ctx, "wavlm.encoder", lead)
    assembled = _spans(ctx, "serving.assemble", lead + 1.0)
    if not enc or not assembled:
        return None
    conv = ctx.config["encoder"]["conv_feature_layers"]
    ends = [s.end for s in assembled]
    out, used = [], set()
    for span in enc:
        i = bisect.bisect_right(ends, span.start) - 1
        if i < 0 or i in used or "samples" not in assembled[i].attrs:
            continue
        used.add(i)
        out.append((span, tuple(roofline.conv_frames(n, conv)
                                for n in assembled[i].attrs["samples"])))
    return out or None


def launches(ctx) -> Optional[List[Tuple[float, float, object, Tuple[int, ...]]]]:
    """(device start, end, encoder span, its rows' valid frames) of each
    biased attention launch in the traced stretch: the batch is the latest
    whose encoder span began before the launch ran. None without spans or
    launches."""
    found = encoder_batches(ctx, LEAD_S)
    kernels = ctx.trace_data.kernels(KERNEL) if ctx.trace_data is not None else []
    if not found or not kernels:
        return None
    starts = [span.start for span, _v in found]
    out = []
    for _n, a, b in kernels:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0:
            out.append((a, b) + found[i])
    return out or None


def relbias_roofline_pct(ctx) -> Optional[float]:
    """Summed least time of the biased launches over their device time."""
    found = launches(ctx)
    if found is None:
        return None
    enc = ctx.config["encoder"]
    heads, dh = enc["num_heads"], enc["embed_dim"] // enc["num_heads"]
    bound = kernel_s = 0.0
    for a, b, span, valid in found:
        at = span.attrs
        bound += wavlm_ops.relbias_attention_bound_s(at["rows"], heads, at["frames"], dh,
                                                     sum(valid))
        kernel_s += b - a
    return 100.0 * bound / kernel_s if kernel_s else None


def relbias_share_pct(ctx) -> Optional[float]:
    """The biased launches' device time over the device's busy time."""
    td = ctx.trace_data
    if td is None or td.busy_s <= 0:
        return None
    k = sum(b - a for _n, a, b in td.kernels(KERNEL))
    return 100.0 * k / td.busy_s if k else None


def mfu_pct(ctx) -> Optional[float]:
    """Each clip's encoder and head FLOPs at its own length (its valid
    frames, ``encoder_batches``) over the wall time of the ``serving.batch``
    spans that hold the encoder spans, for the batches that began and ended
    inside the traced stretch; as a share of 989 TFLOP/s. (The encoder span
    covers the forward's issue only; its batch span runs to the results on
    the host.)"""
    batches, enc = _spans(ctx, "serving.batch"), encoder_batches(ctx)
    if not batches or not enc:
        return None
    lo, hi = ctx.trace_data.window
    cfg_enc, head = ctx.config["encoder"], ctx.config["head"]
    flops = seconds = 0.0
    for b in batches:
        if b.start < lo or b.end > hi:
            continue
        inner = [valid for s, valid in enc if b.start <= s.start and s.end <= b.end]
        if not inner:
            continue
        seconds += b.end - b.start
        flops += sum(wavlm_ops.clip_flops(cfg_enc, head, n) for valid in inner for n in valid)
    if not seconds or not flops:
        return None
    return 100.0 * flops / seconds / roofline.PEAK_BF16
