"""Share of dense_grid_kernel's draws spent in its grid barriers, in %:
``dense_grid.barrier_cycles`` over the four phases' cycles (product,
epilogue, barrier, between draws: SM cycles that thread 0 of each block
counts, csrc/gaussian_hmc.cuh), over the traced window's ``gaussian_hmc``
calls."""

from benchmark.metrics.program import share_pct

MOVES = "chain_draws_per_s"


def read(ctx):
    return share_pct(ctx, "gaussian_hmc", "dense_grid", "barrier_cycles",
                     ("product_cycles", "epilogue_cycles", "barrier_cycles",
                      "between_draws_cycles"))
