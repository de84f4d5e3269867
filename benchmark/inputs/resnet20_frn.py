"""Inputs of a ``resnet20_frn`` configuration, made on the device from the seed.

Two modules of one network, ResNet-20-FRN with swish at the
configuration's sizes: ``port_module``, the port's own
(``models/resnet_frn.py``), which the port's entry runs, and ``module``,
the plain reference (``reference/resnet20_frn.py``), with which the check
and any stand-in for the port compute.  Both take one flat vector of
parameters in the same order.  The images are standard normal
(n_data, channels_in, image_size, image_size) and the labels uniform over
the classes.  Every chain starts at He-normal weights (standard deviation
sqrt(2 / fan_in)), the FRN scales at 1, the TLU thresholds at
``tlu_start`` and the other parameters at 0, these plus 0.1 times a
standard normal (``conv_frn_classifier``'s start).  One generator on the
device, a few large draws.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark.core import load_module, resolve
from benchmark.reference.resnet20_frn import ResNet20FRN

# the start of conv_frn_classifier's chains, by parameter name
_start = load_module("inputs", "conv_frn_classifier", Path(__file__).resolve().parents[1])._start

PORT_MODEL = "hamiltorch_tpu_torch.models.resnet_frn:resnet20_frn_swish"


def _sizes(cfg: dict) -> dict:
    return dict(num_classes=cfg["classes"], frn_eps=cfg["frn_eps"],
                in_channels=cfg["channels_in"], widths=tuple(cfg["widths"]),
                blocks_per_stage=cfg["blocks_per_stage"])


def make(cfg: dict, chains: int, seed: int, device) -> dict:
    port = resolve(PORT_MODEL)(**_sizes(cfg))
    mean, scale = (t.to(device) for t in _start(port, cfg["tlu_start"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, c, s = cfg["n_data"], cfg["channels_in"], cfg["image_size"]
    x = torch.randn((n, c, s, s), generator=gen, dtype=torch.float32, device=device)
    y = torch.randint(0, cfg["classes"], (n,), generator=gen, device=device)
    theta = mean + scale * torch.randn((chains, mean.numel()), generator=gen,
                                       dtype=torch.float32, device=device)
    return {"x": x, "y": y, "theta": theta, "port_module": port,
            "module": ResNet20FRN(**_sizes(cfg))}
