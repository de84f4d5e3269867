"""Calls of the port's general HMC (``entries/hmc_chains.py``) on a
potential whose likelihood the port evaluates in blocks of rows.

As ``hmc_chains``, but the configuration's inputs hand over two modules
of one network: ``port_module``, which goes to the port's
``define_model_log_prob`` with ``block_rows`` from the configuration, and
``module``, the plain reference, with which the float64 check (in blocks
of ``reference_rows``) and any stand-in for the port compute.  So the
check holds the port's network and its sampler to the reference's.
"""

from __future__ import annotations

import types
from pathlib import Path

from benchmark.core import Entry, load_module, resolve

_base = load_module("entries", "hmc_chains", Path(__file__).resolve().parents[1])


class Cell(_base.Cell):
    def __init__(self, cfg, traffic, seed, device, fn):
        Entry.__init__(self, cfg, traffic, seed, device, fn)
        d = self.data
        sizes = dict(num_samples=traffic["draws"], num_steps_per_sample=traffic["steps"],
                     step_size=traffic["step_size"], burn=0)
        if hasattr(fn, "posterior"):  # a stand-in for the port
            self.log_prob = fn.posterior(d["module"], d["x"], d["y"], cfg)
            self.config = types.SimpleNamespace(**sizes)
        else:
            self.log_prob = resolve(self.POTENTIAL)(
                d["port_module"], cfg["model_loss"], d["x"], d["y"],
                tau_list=cfg["prior_precision"], tau_out=cfg["tau_out"], device=d["x"].device,
                block_rows=cfg["block_rows"])[0]
            self.config = resolve(self.CONFIG)(**sizes)
