"""Shared arithmetic of the per-layer metric readers (``metrics/``). A
reader returns None where its run left nothing to read."""

from __future__ import annotations

from typing import Optional

from . import roofline


def device_idle_pct(ctx) -> Optional[float]:
    """100 x (1 - the union of device intervals / the traced window)."""
    td = ctx.trace_data
    if td is None or td.window_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)


def launches_per_step(ctx) -> Optional[float]:
    """Kernels in the traced stretch over the steps it held."""
    td, steps = ctx.trace_data, ctx.counters.get("traced_steps", 0)
    if td is None or not steps:
        return None
    return len(td.kernels()) / steps


def ratio_pct(num: float, den: float) -> Optional[float]:
    return None if not den else 100.0 * num / den


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    return None if not seconds or not flops else 100.0 * flops / seconds / roofline.PEAK_BF16
