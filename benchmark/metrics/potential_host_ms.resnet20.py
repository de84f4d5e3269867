"""Host time of one evaluation of the port's blocked potential, in ms: the
mean over the traced window's ``potential`` spans (``models/bnn.py``; one
a gradient of one chain, its blocks' forwards and backwards queued), when
the window holds one ``run_hmc_chains`` span a call and one ``potential``
span a chain's gradient."""

from benchmark.metrics.program import _recorder, calls

MOVES = "grad_evals_per_s"


def read(ctx):
    if calls(ctx, "run_hmc_chains") is None:
        return None
    spans = [s for s in _recorder().spans() if s.name == "potential"]
    if not spans or len(spans) != ctx.calls * ctx.counts["grad_evals"]:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6
