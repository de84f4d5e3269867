"""Device idle time of the traced window a queued operation, in us: the
window's seconds without a kernel, copy or set over the window's
``bnn_hmc.kernel_launches``."""

from benchmark.metrics.program import counters

MOVES = "grad_evals_per_s"


def read(ctx):
    launches = counters(ctx, "bnn_hmc", ["bnn_hmc.kernel_launches"])
    if launches is None or launches[0] <= 0 or ctx.busy_s <= 0:
        return None
    return 1e6 * (ctx.window_s - ctx.busy_s) / launches[0]
