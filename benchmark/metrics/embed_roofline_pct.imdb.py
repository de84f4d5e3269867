"""The embedding's share of its roofline: the counted bytes of its gather
and of its gradient (``counts_cnn_lstm.py``) at the memory peak, over the
device time of the embedding's kernels, by name: the gather
(``vectorized_gather_kernel``) and the gradient's sort of the ids (cub's
radix sort, unique-by-key and scans, with an ``arange``) and its segment
sums (``krn_partials_per_segment``, ``krn_partial_segment_offset``,
``compute_num_of_partial_segments``, ``compute_grad_weight``,
``sum_and_scatter``).  The ids are the port's counter
``cnn_lstm.tokens`` and the forwards its ``potential.blocks``."""

from benchmark.metrics.counts_cnn_lstm import embed_bytes
from benchmark.metrics.program import counters
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
NAMES = (r"vectorized_gather_kernel|radixsort|uniquebykey|devicescan|devicecompact|arange|krn_|"
         r"segment|compute_grad_weight|sum_and_scatter")  # in any case
PATTERNS = (f"(?i){NAMES}",)


def read(ctx):
    got = counters(ctx, "run_hmc_chains", ("cnn_lstm.tokens", "potential.blocks"))
    if got is None or min(got) <= 0:
        return None
    return roofline_pct(ctx, PATTERNS, 0, embed_bytes(ctx.cfg, *got))
