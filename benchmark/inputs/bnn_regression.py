"""Inputs of a ``bnn_regression`` configuration, made on the device from the seed.

The recipe of the port's flagship potential (``models/flagship.py``): x is
standard normal (n_data, in_dim), y = tanh(x w_t) with a teacher w_t drawn
N(0, 1 / in_dim), and every chain starts at init_scale times a standard
normal in every parameter.  One generator on the device, a few large draws.
"""

from __future__ import annotations

import math

import torch


def make(cfg: dict, chains: int, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, i_dim, h = cfg["n_data"], cfg["in_dim"], cfg["hidden"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    x = normal(n, i_dim)
    w_t = normal(i_dim) / math.sqrt(i_dim)
    y = torch.tanh(x @ w_t)[:, None].contiguous()
    s = cfg["init_scale"]
    theta = tuple(s * normal(*shape) for shape in ((chains, i_dim, h), (chains, h), (chains, h),
                                                   (chains,)))
    return {"x": x, "y": y, "theta": theta}
