"""The whole step's share of the chip's TF32 peak: the counted operations
of every full-batch gradient the traced window's calls evaluated
(``counts_cnn_lstm.py``), over the window."""

from benchmark.metrics.counts_cnn_lstm import gradient_flops
from benchmark.metrics.readers import mfu_pct

MOVES = "grad_evals_per_s"


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    return mfu_pct(ctx, grads * gradient_flops(ctx.cfg, ctx.traffic["chains"]))
