"""Share of the BNN backward GEMM's consumer time in its HMC epilogue, in %:
``bnn_backward.epilogue_cycles`` over it plus ``products_cycles`` (SM cycles
that the first thread of each consumer warpgroup counts, csrc/bnn_grad.cuh),
over the traced window's ``bnn_hmc`` calls."""

from benchmark.metrics.program import share_pct

MOVES = "grad_evals_per_s"


def read(ctx):
    return share_pct(ctx, "bnn_hmc", "bnn_backward", "epilogue_cycles",
                     ("products_cycles", "epilogue_cycles"))
