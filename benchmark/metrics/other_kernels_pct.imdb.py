"""Share of the traced window's device time in kernels that no layer of the
cell names: the layout copies of the convolution's and the LSTM's inputs
and gradients (``direct_copy_kernel``), autograd's fills and gradient sums,
the bias's and the loss's reductions and softmax, the prior and the
sampler's own kernels, copies and sets: every kernel that
``conv_roofline_pct.imdb``, ``lstm_roofline_pct.imdb`` and
``embed_roofline_pct.imdb`` do not name, over the busy time."""

from pathlib import Path

from benchmark.core import load_module
from benchmark.metrics.readers import device_seconds

MOVES = "grad_evals_per_s"
_here = Path(__file__).resolve().parents[1]
_layers = "|".join(load_module("metrics", name, _here).NAMES for name in (
    "conv_roofline_pct.imdb", "lstm_roofline_pct.imdb", "embed_roofline_pct.imdb"))
PATTERNS = (f"(?i)^(?!.*(?:{_layers}))",)


def read(ctx):
    seconds = device_seconds(ctx, PATTERNS)
    if ctx.busy_s <= 0 or seconds <= 0:
        return None
    return 100.0 * seconds / ctx.busy_s
