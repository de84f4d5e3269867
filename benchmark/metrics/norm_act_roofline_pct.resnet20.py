"""The normalisation and activation passes' share of their roofline: the
counted bytes of FRN with TLU, swish and the residual adds of every
full-batch gradient the traced window's calls evaluated
(``counts_resnet20.py``) at the memory peak, over the device time of every
kernel that ``conv_roofline_pct.resnet20`` does not name (the elementwise
and reduction kernels of those passes, and also the biases, the pool, the
loss and the sampler's own few kernels a draw)."""

from pathlib import Path

from benchmark.core import load_module
from benchmark.metrics.counts_resnet20 import resnet20_norm_act_bytes
from benchmark.metrics.readers import roofline_pct

MOVES = "grad_evals_per_s"
_conv = load_module("metrics", "conv_roofline_pct.resnet20", Path(__file__).resolve().parents[1])
PATTERNS = (f"(?i)^(?!.*(?:{_conv.NAMES}))",)


def read(ctx):
    grads = ctx.calls * ctx.counts["gradients"]
    return roofline_pct(ctx, PATTERNS, 0,
                        grads * resnet20_norm_act_bytes(ctx.cfg, ctx.traffic["chains"]))
