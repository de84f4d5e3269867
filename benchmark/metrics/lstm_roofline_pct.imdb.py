"""The recurrence's share of its roofline: its counted operations at the
TF32 peak or its gate pass's counted bytes at the memory peak, the larger
(``counts_cnn_lstm.py``), over the device time of cuDNN's RNN kernels, by name: on the H100
with TF32 off the persistent recurrences ``RNN_blockPersist_fp_LSTM`` and
``RNN_blockPersist_bp_LSTM_FMA``, the gate passes ``GENERIC_elementWise_bp2``
and ``LSTM_elementWise_bp1``, and the float32 GEMMs of the inputs' product
and of the weight gradients (``sm80_xmma_gemm``, ``cutlass_80_simt_sgemm``,
with the head's few, which cannot be told from them by name).  The review-steps are the
port's counters: ``cnn_lstm.steps`` (steps a forward, summed) over
``potential.blocks`` (forwards), times the reviews, ``cnn_lstm.tokens``
over the configuration's ``seq_len``."""

from benchmark.metrics.counts_cnn_lstm import lstm_flops, lstm_gate_bytes
from benchmark.metrics.program import counters
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
NAMES = r"rnn_|lstm|elementwise_fp|elementwise_bp|xmma_gemm|simt_sgemm|splitkreduce"  # any case
PATTERNS = (f"(?i){NAMES}",)


def review_steps(ctx):
    """Recurrence steps of a review enqueued over the window, or None."""
    got = counters(ctx, "run_hmc_chains", ("cnn_lstm.steps", "cnn_lstm.tokens",
                                           "potential.blocks"))
    if got is None or min(got) <= 0:
        return None
    steps, tokens, forwards = got
    return steps * tokens // (forwards * ctx.cfg["seq_len"])


def read(ctx):
    n = review_steps(ctx)
    if n is None:
        return None
    return roofline_pct(ctx, PATTERNS, lstm_flops(ctx.cfg, n), lstm_gate_bytes(ctx.cfg, n))
