"""Readers that several per-layer metrics share.

Each takes the run's context (``benchmark.core.Context``) and returns a
number, or None where the trace holds nothing to read: a share of a
roofline or of a peak is never reported as 0.
"""

from __future__ import annotations

import re


def device_seconds(ctx, patterns) -> float:
    """Device time of the traced window's kernels whose names match."""
    return sum(s for name, s in ctx.kernels.items()
               if any(re.search(p, name) for p in patterns))


def roofline_pct(ctx, patterns, flops: float, nbytes: float):
    """100 x the least time the chip could take (operations at the TF32
    peak or bytes at the memory peak, the larger) over the layer's time."""
    seconds = device_seconds(ctx, patterns)
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    bound = max(flops / ctx.peaks["tf32_flops_per_s"], nbytes / ctx.peaks["bytes_per_s"])
    return 100.0 * bound / seconds


def mfu_pct(ctx, flops: float):
    """100 x the window's model operations over the window at the TF32 peak."""
    if ctx.busy_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * ctx.peaks["tf32_flops_per_s"])


def idle_pct(ctx):
    """Share of the traced window in which no kernel, copy or set ran."""
    if ctx.busy_s <= 0:
        return None
    return 100.0 * (ctx.window_s - ctx.busy_s) / ctx.window_s


def host_ms(ctx):
    """Mean host time of a call into the entry, in ms: the calls a traced
    run makes after its window, each after a synchronize, untraced."""
    if not ctx.host_call_s:
        return None
    return 1e3 * sum(ctx.host_call_s) / len(ctx.host_call_s)
