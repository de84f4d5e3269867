"""The whole step's share of the chip's TF32 peak: the model operations of
every gradient the traced window's calls evaluated, over the window."""

from benchmark.metrics.counts import bnn_gradient_flops
from benchmark.metrics.readers import mfu_pct

MOVES = "grad_evals_per_s"


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    return mfu_pct(ctx, grads * bnn_gradient_flops(ctx.cfg, ctx.traffic["chains"]))
