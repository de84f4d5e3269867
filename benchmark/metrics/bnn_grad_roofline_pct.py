"""The BNN gradient's share of its roofline (csrc/bnn_grad.cuh's forward,
backward and per-chain kernels, by name), over every gradient the traced
window's calls evaluated."""

from benchmark.metrics.counts import bnn_gradient_bytes, bnn_gradient_flops
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
PATTERNS = (r"^forward_kernel\b", r"^backward_kernel\b", r"^small_kernel\b")


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    chains = ctx.traffic["chains"]
    return roofline_pct(ctx, PATTERNS, grads * bnn_gradient_flops(ctx.cfg, chains),
                        grads * bnn_gradient_bytes(ctx.cfg, chains))
