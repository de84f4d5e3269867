"""The convolution stage's share of its roofline: the convolution's counted
operations in every full-batch gradient the traced window's calls
evaluated (``counts_cnn_lstm.py``) at the TF32 peak, over the device time
of the kernels of the stage (the span ``cnn_lstm.conv``), by name: cuDNN's
convolution kernels (on the H100 with TF32 off ``implicit_convolve_sgemm``
forward, ``dgrad_engine`` and ``sm80_xmma_wgrad_implicit_gemm`` backward),
its layout transforms (``nchwToNhwc``, ``nhwcToNchw``,
``scalePackedTensor``), and swish's and the max-pool's kernels, each way.
The bias's gradient is a generic sum (``other_kernels_pct.imdb``)."""

from benchmark.metrics.counts_cnn_lstm import conv_flops
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
NAMES = (r"conv|xmma_fprop|xmma_dgrad|xmma_wgrad|dgrad_engine|wgrad|fft|winograd|nchwtonhwc|"
         r"nhwctonchw|scalepackedtensor|silu|max_pool")  # in any case
PATTERNS = (f"(?i){NAMES}",)


def read(ctx):
    reviews = ctx.calls * ctx.counts["gradients"] * ctx.traffic["chains"] * ctx.cfg["n_data"]
    return roofline_pct(ctx, PATTERNS, conv_flops(ctx.cfg, reviews), 0)
