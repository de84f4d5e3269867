"""The convolutions' and the head's share of their roofline: the counted
operations of every full-batch gradient the traced window's calls evaluated
(``counts_resnet20.py``) at the TF32 peak, over the device time of
cuDNN's convolution kernels (forward, data and weight gradients, with their
FFTs, filter flips, layout transforms and split-K reductions) and cuBLAS's
GEMMs, by name.  On the H100 with TF32 off cuDNN picks FFT convolutions
(``fft2d_r2c``/``c2r`` with complex ``sm80_xmma_gemm_cf32``), implicit
GEMMs (``sm80_xmma_fprop``/``dgrad``, ``implicit_convolve_sgemm``),
``wgrad_alg0_engine``, ``dgrad_engine`` and Winograd weight gradients."""

from benchmark.metrics.counts_resnet20 import resnet20_gradient_flops
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
NAMES = (r"conv|gemm|xmma|cudnn|cutlass|winograd|fft|wgrad|dgrad|fprop|flip_filter|nchwtonhwc|"
         r"nhwctonchw|splitkreduce")  # matched in any case
PATTERNS = (f"(?i){NAMES}",)


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    flops = grads * resnet20_gradient_flops(ctx.cfg, ctx.traffic["chains"])
    return roofline_pct(ctx, PATTERNS, flops, 0)
