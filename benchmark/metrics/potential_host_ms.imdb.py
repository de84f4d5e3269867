"""Host time of one evaluation of the port's blocked potential, in ms: the
mean over the traced window's ``potential`` spans (``models/bnn.py``; one
a gradient of one chain, its blocks' forwards and backwards queued), when
the window holds one ``run_hmc_chains`` span a call and one ``potential``
span a chain's gradient.  The reader of ``potential_host_ms.resnet20``."""

from pathlib import Path

from benchmark.core import load_module

MOVES = "grad_evals_per_s"
read = load_module("metrics", "potential_host_ms.resnet20",
                   Path(__file__).resolve().parents[1]).read
