"""Inputs of a ``conv_frn_classifier`` configuration, made on the device from the seed.

The module is ResNet-20-FRN's stem and head at ``channels`` channels: a
3x3 convolution, filter response normalisation with a thresholded linear
unit (Singh and Krishnan, arXiv:1911.09737), swish, a global average pool
and a linear layer over ``classes`` logits.  The images are standard
normal (n_data, channels_in, image_size, image_size) and the labels
uniform over the classes.  Every chain starts at He-normal weights
(standard deviation sqrt(2 / fan_in)), the FRN scales at 1, the TLU
thresholds at ``tlu_start`` and the other parameters at 0, each plus 0.1
times a standard normal.  One generator on the device, a few large draws;
the module's own initial values are not used.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class FilterResponseNorm(nn.Module):
    """y = max(gamma x / sqrt(mean_hw x^2 + eps) + beta, tau), per channel."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        shape = (1, channels, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.tau = nn.Parameter(torch.zeros(shape))
        self.eps = eps

    def forward(self, x):
        nu2 = torch.mean(x * x, dim=(2, 3), keepdim=True)
        return torch.maximum(self.gamma * x * torch.rsqrt(nu2 + self.eps) + self.beta, self.tau)


def classifier(cfg: dict) -> nn.Module:
    return nn.Sequential(
        nn.Conv2d(cfg["channels_in"], cfg["channels"], 3, padding=1),
        FilterResponseNorm(cfg["channels"], cfg["frn_eps"]),
        nn.SiLU(),
        nn.AdaptiveAvgPool2d(1),
        nn.Flatten(),
        nn.Linear(cfg["channels"], cfg["classes"]),
    )


def _start(module: nn.Module, tlu_start: float):
    """(mean, scale) of every parameter's start, flat in ``parameters()`` order."""
    means = {"gamma": 1.0, "tau": tlu_start}
    mean, scale = [], []
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            fan_in = p[0].numel()
            mean.append(torch.zeros(p.numel()))
            scale.append(torch.full((p.numel(),), math.sqrt(2.0 / fan_in)))
        else:
            mean.append(torch.full((p.numel(),), means.get(name.rsplit(".", 1)[-1], 0.0)))
            scale.append(torch.full((p.numel(),), 0.1))
    return torch.cat(mean), torch.cat(scale)


def make(cfg: dict, chains: int, seed: int, device) -> dict:
    module = classifier(cfg)
    mean, scale = (t.to(device) for t in _start(module, cfg["tlu_start"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, c, s = cfg["n_data"], cfg["channels_in"], cfg["image_size"]
    x = torch.randn((n, c, s, s), generator=gen, dtype=torch.float32, device=device)
    y = torch.randint(0, cfg["classes"], (n,), generator=gen, device=device)
    theta = mean + scale * torch.randn((chains, mean.numel()), generator=gen,
                                       dtype=torch.float32, device=device)
    return {"x": x, "y": y, "theta": theta, "module": module}
