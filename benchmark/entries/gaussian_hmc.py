"""Calls of the port's fused Gaussian HMC, ``hamiltorch_tpu_torch.kernels.gaussian_hmc.gaussian_hmc``.

One call runs every chain through ``draws`` HMC draws of ``steps``
leapfrog steps from the last draw of the previous call (the first call
from the inputs), under its own seed, and returns every draw.  The check
runs the plain reference (``reference/gaussian.py``) in float64 from the
same start and seed and compares every draw of the call and each chain's
acceptance.
"""

from __future__ import annotations

import torch

from benchmark.core import Entry, finite_or_max
from benchmark.reference import gaussian as ref


class Cell(Entry):
    PORT = "hamiltorch_tpu_torch.kernels.gaussian_hmc:gaussian_hmc"

    def _run(self, rec):
        t, d = self.traffic, self.data
        return self.fn(rec["seed"], rec["theta"], d["precision"], t["draws"],
                       num_steps=t["steps"], step_size=t["step_size"], mean=d["mean"])

    def _next(self, out):
        return out[0][:, -1].contiguous()

    def counts(self) -> dict:
        c, s = self.traffic["chains"], self.traffic["draws"]
        return {"chain_draws": c * s, "steps": s * self.traffic["steps"]}

    def check(self, rec: dict, limits: dict) -> dict:
        """draw_gap: the largest gap of any draw to the reference's over the
        largest distance of a reference draw from the mean; wrong_decisions:
        Metropolis decisions of the call (read from its draws: a draw that
        differs from the one before was accepted) that differ from the
        reference's where its margin is at least the tolerance of
        ``reference.gaussian.hmc`` (``margin`` plus ``rounding`` times what
        float32 rounding of the energies is in proportion to); where it is
        less, the reference takes the call's decision.  acc_gap: the most
        accepted draws by which a chain's returned acceptance differs."""
        t, margin = self.traffic, limits["margin"]
        out, acc = rec["out"]
        mean = self.data["mean"]
        prev = torch.cat((rec["theta"][:, None], out[:, :-1]), dim=1)
        taken = torch.any(out != prev, dim=2)
        zero = torch.zeros((), dtype=torch.float64, device=out.device)
        gap, scale, wrong = zero, zero, zero
        count = torch.zeros(out.shape[0], dtype=torch.float64, device=out.device)
        judged = zero
        for n, theta, m, accept, tol in ref.hmc(rec["seed"], rec["theta"], self.data["precision"],
                                                mean, t["draws"], t["steps"], t["step_size"],
                                                margin=margin, rounding=limits["rounding"],
                                                taken=taken):
            gap = torch.maximum(gap, (out[:, n].double() - theta).abs().max())
            scale = torch.maximum(scale, (theta - mean.double()).abs().max())
            wrong = wrong + ((taken[:, n] != (m >= 0)) & (m.abs() >= tol)).sum()
            judged = judged + (m.abs() >= tol).sum()
            count += accept.double()
        miss = float((torch.round(acc.double() * t["draws"]) - count).abs().max())
        return {"draw_gap": finite_or_max(gap / torch.clamp(scale, min=1e-30)),
                "wrong_decisions": int(wrong), "acc_gap": finite_or_max(miss),
                "acceptance": float(count.mean()) / t["draws"],
                "judged_share": float(judged) / (t["draws"] * out.shape[0])}

    @staticmethod
    def stand_in(prec: str):
        """The reference in ``prec``, called as the port's entry is."""

        def run(seed, theta0, precision, num_samples, num_steps, step_size, mean):
            c, d = theta0.shape
            out = torch.empty((c, num_samples, d), dtype=torch.float32, device=theta0.device)
            count = torch.zeros(c, dtype=torch.float32, device=theta0.device)
            for n, theta, _, accept, _ in ref.hmc(seed, theta0, precision, mean, num_samples,
                                                  num_steps, step_size, prec):
                out[:, n] = theta
                count += accept.float()
            return out, count / num_samples

        return run
