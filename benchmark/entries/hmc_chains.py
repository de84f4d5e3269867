"""Calls of the port's general HMC, ``hamiltorch_tpu_torch.samplers.hmc.run_hmc_chains``.

Set-up builds the posterior once, as a user does: the configuration's
inputs hand over data (x, y), the chains' start theta (C, D) and a plain
``torch.nn.Module``, which go to the port's ``define_model_log_prob`` with
the configuration's ``model_loss``, ``prior_precision`` (one a leaf, or one
for all) and ``tau_out``.  One call runs ``run_hmc_chains`` from the state
the previous call returned, under its own seed, for the traffic's
``draws`` draws of ``steps`` leapfrog steps at ``step_size``, with an
identity mass, no burn-in and no adaptation.  It evaluates draws x steps
+ 1 gradients of every chain: the start's, then L a draw.

The check runs the plain reference (``reference/hmc_chains.py``) in
float64 from the same start and seed, on the same noise
(``reference/streams.py``), and compares the final parameters, each
chain's acceptance and every draw's energies h0 and h1.  The energies are
what sees the gradient at small steps, where a call's move is nearly all
momentum.
"""

from __future__ import annotations

import types

import torch

from benchmark.core import Entry, finite_or_max, resolve
from benchmark.reference import hmc_chains as ref


class Cell(Entry):
    PORT = "hamiltorch_tpu_torch.samplers.hmc:run_hmc_chains"
    # what the port's entry is driven with
    POTENTIAL = "hamiltorch_tpu_torch.models.bnn:define_model_log_prob"
    CONFIG = "hamiltorch_tpu_torch.samplers.driver:MCMCConfig"

    def __init__(self, cfg, traffic, seed, device, fn):
        super().__init__(cfg, traffic, seed, device, fn)
        d = self.data
        sizes = dict(num_samples=traffic["draws"], num_steps_per_sample=traffic["steps"],
                     step_size=traffic["step_size"], burn=0)
        if hasattr(fn, "posterior"):  # a stand-in for the port
            self.log_prob = fn.posterior(d["module"], d["x"], d["y"], cfg)
            self.config = types.SimpleNamespace(**sizes)
        else:
            self.log_prob = resolve(self.POTENTIAL)(
                d["module"], cfg["model_loss"], d["x"], d["y"], tau_list=cfg["prior_precision"],
                tau_out=cfg["tau_out"], device=d["x"].device)[0]
            self.config = resolve(self.CONFIG)(**sizes)

    def _run(self, rec):
        return self.fn(rec["seed"], self.log_prob, rec["theta"], self.config,
                       self.traffic["chains"])

    def _next(self, out):
        return out.final_state.theta

    def release(self):
        super().release()
        self.log_prob = None

    def counts(self) -> dict:
        c, s, steps = self.traffic["chains"], self.traffic["draws"], self.traffic["steps"]
        return {"grad_evals": c * (s * steps + 1), "gradients": s * steps + 1,
                "chain_draws": c * s}

    def check(self, rec: dict, limits: dict) -> dict:
        """theta_gap: the worst chain's largest parameter gap to the
        reference, over the largest move the reference makes in the call;
        acc_gap: the most accepted draws by which a chain differs;
        energy_gap: the largest gap of any draw's h0 or h1 to the
        reference's, over that energy's size (at least 1 nat).  Where a
        decision's margin is under ``margin`` the reference follows both
        outcomes and each chain is judged against its nearer one."""
        t, d, out = self.traffic, self.data, rec["out"]
        start = rec["theta"]
        post = ref.Posterior(d["module"], d["x"], d["y"], self.cfg, "float64")
        chain, lanes, count, h0, h1 = ref.hmc(rec["seed"], post, start, t["draws"], t["steps"],
                                              t["step_size"], start.dtype,
                                              margin=limits["margin"])
        prog = out.final_state.theta.double()
        gap = torch.nan_to_num((prog[chain] - lanes).abs().amax(dim=1), nan=float("inf"))
        taken = torch.round(out.acc_rate.double() * t["draws"])
        miss = torch.nan_to_num((taken[chain] - count).abs(), nan=float("inf"))
        e_gap = torch.maximum(
            (out.stats.energy_old.double()[chain] - h0).abs() / h0.abs().clamp(min=1.0),
            (out.stats.energy_new.double()[chain] - h1).abs() / h1.abs().clamp(min=1.0))
        e_gap = torch.nan_to_num(e_gap.amax(dim=1), nan=float("inf"))
        best = {}
        for lane, key in enumerate(zip(chain.tolist(), miss.tolist(), gap.tolist(),
                                       e_gap.tolist())):
            c, rest = key[0], key[1:]
            if c not in best or rest < best[c][:3]:
                best[c] = (*rest, lane)
        picked = torch.tensor([best[c][3] for c in range(len(best))], device=chain.device)
        move = float((lanes[picked] - start.double()).abs().max())
        return {
            "theta_gap": finite_or_max(max(b[1] for b in best.values()) / max(move, 1e-30)),
            "acc_gap": finite_or_max(max(b[0] for b in best.values())),
            "energy_gap": finite_or_max(max(b[2] for b in best.values())),
            "branched_lanes": len(chain) - len(best),
            "acceptance": float(count[picked].mean()) / t["draws"],
        }

    @staticmethod
    def stand_in(prec: str):
        """The reference in ``prec``, called as the port's entry is; its
        ``posterior`` stands in for the port's potential."""

        def run(key, log_prob_fn, theta0, config, num_chains):
            chain, theta, count, h0, h1 = ref.hmc(key, log_prob_fn, theta0, config.num_samples,
                                                  config.num_steps_per_sample, config.step_size,
                                                  theta0.dtype)
            stats = types.SimpleNamespace(energy_old=h0.to(theta0.dtype),
                                          energy_new=h1.to(theta0.dtype))
            return types.SimpleNamespace(
                final_state=types.SimpleNamespace(theta=theta.to(theta0.dtype).contiguous()),
                acc_rate=(count / config.num_samples).to(theta0.dtype), stats=stats)

        def posterior(module, x, y, cfg):
            return ref.Posterior(module, x, y, cfg, prec)

        run.posterior = posterior
        return run
