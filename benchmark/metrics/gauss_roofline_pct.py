"""The Gaussian sampler kernel's share of its roofline (the kernels of
csrc/gaussian_hmc.cuh, by name), over the traced window's calls."""

from benchmark.metrics.counts import gaussian_bytes, gaussian_flops
from benchmark.metrics.readers import roofline_pct

MOVES = "chain_draws_per_s"
PATTERNS = (r"^(dense_grid|chain|mma|diag)_kernel\b",)


def read(ctx):
    t, d = ctx.traffic, ctx.cfg["dims"]
    return roofline_pct(ctx, PATTERNS,
                        ctx.calls * gaussian_flops(d, t["chains"], t["draws"], t["steps"]),
                        ctx.calls * gaussian_bytes(d, t["chains"], t["draws"]))
