"""Inputs of a ``wishart_gaussian`` configuration, made on the device.

The precision is A = X^T X with X standard normal (wishart_dof, dims), a
draw of Wishart(I, wishart_dof) from the configuration's ``wishart_seed``,
so that every run samples the same target, as the paper fixes one A; it is
formed in float64 and symmetrised, then held in float32 as the port takes
it.  The mean is zero; every chain starts at a standard normal drawn from
the run's seed.  One generator on the device.
"""

from __future__ import annotations

import torch


def make(cfg: dict, chains: int, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg["wishart_seed"])
    d = cfg["dims"]
    x = torch.randn((cfg["wishart_dof"], d), generator=gen, dtype=torch.float64, device=device)
    a = x.T @ x
    p = (0.5 * (a + a.T)).float().contiguous()
    gen.manual_seed(seed)
    theta = torch.randn((chains, d), generator=gen, dtype=torch.float32, device=device)
    return {"precision": p, "mean": torch.zeros(d, device=device), "theta": theta}
