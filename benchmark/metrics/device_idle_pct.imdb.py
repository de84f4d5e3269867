"""Share of the traced window in which the device ran no kernel, copy or set."""

from benchmark.metrics.readers import idle_pct as read  # noqa: F401

MOVES = "grad_evals_per_s"
