"""Host time of one call into kernels/bnn_hmc.py with the wait for room in
the launch queue taken out, in ms: the mean over the traced window's
``bnn_hmc`` spans of the span less that call's ``bnn_hmc.launch_ns`` (the
host ns inside the C entry's launch statements)."""

from benchmark.metrics.program import calls, counters

MOVES = "grad_evals_per_s"


def read(ctx):
    spans = calls(ctx, "bnn_hmc")
    launch_ns = counters(ctx, "bnn_hmc", ["bnn_hmc.launch_ns"])
    if spans is None or launch_ns is None:
        return None
    return (sum(s.end_ns - s.start_ns for s in spans) - launch_ns[0]) / len(spans) / 1e6
