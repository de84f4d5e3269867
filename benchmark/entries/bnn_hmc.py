"""Calls of the port's fused BNN HMC, ``hamiltorch_tpu_torch.kernels.bnn_hmc.bnn_hmc``.

One call runs every chain through ``draws`` HMC draws of ``steps`` leapfrog
steps from the parameters the previous call returned (the first call from
the inputs), under its own seed.  It evaluates draws x steps + 1 gradients
of all chains.  The check runs the plain reference (``reference/bnn.py``)
in float64 from the same start and seed and compares the final parameters
and each chain's acceptance.
"""

from __future__ import annotations

import torch

from benchmark.core import Entry, finite_or_max
from benchmark.reference import bnn as ref


class Cell(Entry):
    PORT = "hamiltorch_tpu_torch.kernels.bnn_hmc:bnn_hmc"

    def _run(self, rec):
        t, d = self.traffic, self.data
        return self.fn(rec["seed"], d["x"], d["y"], *rec["theta"], num_samples=t["draws"],
                       num_steps=t["steps"], step_size=t["step_size"], tau=self.cfg["tau_out"])

    def _next(self, out):
        return tuple(t if t.is_contiguous() else t.contiguous() for t in out[:4])

    def counts(self) -> dict:
        c, s, steps = self.traffic["chains"], self.traffic["draws"], self.traffic["steps"]
        return {"grad_evals": c * s * steps, "gradients": s * steps + 1, "chain_draws": c * s}

    def check(self, rec: dict, limits: dict) -> dict:
        """theta_gap: the worst chain's largest parameter gap to the
        reference, over the largest move the reference makes in the call;
        acc_gap: the most accepted draws by which a chain differs.  Where a
        decision's margin is under ``margin`` the reference follows both
        outcomes and each chain is judged against its nearer one."""
        t, d = self.traffic, self.data
        chain, lanes, count = ref.hmc(rec["seed"], d["x"], d["y"], rec["theta"], t["draws"],
                                      t["steps"], t["step_size"], self.cfg["tau_out"],
                                      margin=limits["margin"])
        prog = ref.join(rec["out"][:4]).double()
        start = ref.join(rec["theta"]).double()
        got = ref.join(lanes)
        gap = torch.nan_to_num((prog[chain] - got).abs().amax(dim=1), nan=float("inf"))
        taken = torch.round(rec["out"][4].double() * t["draws"])
        miss = torch.nan_to_num((taken[chain] - count).abs(), nan=float("inf"))
        best = {}
        for lane, (c, m, g) in enumerate(zip(chain.tolist(), miss.tolist(), gap.tolist())):
            if c not in best or (m, g) < best[c][:2]:
                best[c] = (m, g, lane)
        picked = torch.tensor([best[c][2] for c in range(len(best))], device=chain.device)
        move = float((got[picked] - start).abs().max())
        return {
            "theta_gap": finite_or_max(max(b[1] for b in best.values()) / max(move, 1e-30)),
            "acc_gap": finite_or_max(max(b[0] for b in best.values())),
            "branched_lanes": len(chain) - len(best),
            "acceptance": float(count[picked].mean()) / t["draws"],
        }

    @staticmethod
    def stand_in(prec: str):
        """The reference in ``prec``, called as the port's entry is."""

        def run(seed, x, y, w1, b1, w2, b2, num_samples, num_steps, step_size, tau):
            _, theta, count = ref.hmc(seed, x, y, (w1, b1, w2, b2), num_samples, num_steps,
                                      step_size, tau, prec)
            return (*(t.float().contiguous() for t in theta), (count / num_samples).float())

        return run
