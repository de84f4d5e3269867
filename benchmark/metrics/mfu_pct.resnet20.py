"""The whole step's share of the chip's TF32 peak: the counted operations
of every full-batch gradient the traced window's calls evaluated
(``counts_resnet20.py``), over the window."""

from benchmark.metrics.counts_resnet20 import resnet20_gradient_flops
from benchmark.metrics.readers import mfu_pct

MOVES = "grad_evals_per_s"


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    return mfu_pct(ctx, grads * resnet20_gradient_flops(ctx.cfg, ctx.traffic["chains"]))
