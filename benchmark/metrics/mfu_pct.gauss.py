"""The whole step's share of the chip's TF32 peak: the model operations of
the traced window's calls, over the window."""

from benchmark.metrics.counts import gaussian_flops
from benchmark.metrics.readers import mfu_pct

MOVES = "chain_draws_per_s"


def read(ctx):
    t = ctx.traffic
    return mfu_pct(ctx, ctx.calls * gaussian_flops(ctx.cfg["dims"], t["chains"], t["draws"],
                                                   t["steps"]))
