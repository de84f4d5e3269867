"""Operations the C entry of kernels/bnn_hmc.py queues (kernels and memsets)
a gradient evaluation: the window's ``bnn_hmc.kernel_launches`` over its
calls x the gradients a call evaluates."""

from benchmark.metrics.program import counters

MOVES = "grad_evals_per_s"


def read(ctx):
    launches = counters(ctx, "bnn_hmc", ["bnn_hmc.kernel_launches"])
    if launches is None:
        return None
    return launches[0] / (ctx.calls * ctx.counts["gradients"])
