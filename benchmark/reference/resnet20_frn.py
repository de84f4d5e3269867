"""Plain reference of ResNet-20-FRN with swish (arXiv:2104.14421; google-research
``bnn_hmc``'s ``resnet20_frn_swish``), written from its equations.

In NCHW, every convolution with a bias; c(k, s) is a k x k convolution of
stride s with padding (k - 1) / 2:

    frn(x)   = max(gamma x / sqrt(mean_hw(x^2) + eps) + beta, tau), per channel
    swish(x) = x sigmoid(x)
    stem:      x <- swish(frn(c(3, 1)(x)))                             16 channels
    block:     y = frn(c(3, 1)(swish(frn(c(3, s)(x)))))
               x <- swish(x + y), or swish(c(1, s)(x) + y) where s = 2
    stages:    widths 16, 32, 64, three blocks each; s = 2 in the first block
               of stages 2 and 3, 1 elsewhere
    head:      logits = W mean_hw(x) + b

The parameters are registered in the order and the shapes that the
program's module gives them (a convolution's weight (out, in, k, k) then
its bias; an FRN's gamma, beta, tau, each (1, C, 1, 1); a block's first
convolution and FRN, second convolution and FRN, then its shortcut; the
head's weight (classes, 64) and bias), so that one flat vector of
parameters means the same network in both.  Their values here are
placeholders: the posterior sets them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ResNet20FRN(nn.Module):
    def __init__(self, num_classes: int = 10, frn_eps: float = 1e-6, in_channels: int = 3,
                 widths=(16, 32, 64), blocks_per_stage: int = 3):
        super().__init__()
        self.eps = frn_eps
        self.weights = nn.ParameterList()

        def conv(cin, cout, k):
            self.weights.append(nn.Parameter(torch.zeros(cout, cin, k, k)))
            self.weights.append(nn.Parameter(torch.zeros(cout)))

        def frn(c):
            for v in (1.0, 0.0, 0.0):
                self.weights.append(nn.Parameter(torch.full((1, c, 1, 1), v)))

        conv(in_channels, widths[0], 3)
        frn(widths[0])
        cin = widths[0]
        self.blocks = []
        for stage, width in enumerate(widths):
            for block in range(blocks_per_stage):
                stride = 2 if stage > 0 and block == 0 else 1
                conv(cin, width, 3)
                frn(width)
                conv(width, width, 3)
                frn(width)
                if stride != 1:
                    conv(cin, width, 1)
                self.blocks.append(stride != 1)
                cin = width
        self.weights.append(nn.Parameter(torch.zeros(num_classes, cin)))
        self.weights.append(nn.Parameter(torch.zeros(num_classes)))

    def forward(self, x):
        w = iter(self.weights)

        def conv(h, stride):
            k = next(w)
            return F.conv2d(h, k, next(w), stride, (k.shape[-1] - 1) // 2)

        def frn(h):
            gamma, beta, tau = next(w), next(w), next(w)
            nu2 = torch.mean(h * h, dim=(2, 3), keepdim=True)
            return torch.maximum(gamma * h * torch.rsqrt(nu2 + self.eps) + beta, tau)

        def swish(h):
            return h * torch.sigmoid(h)

        x = swish(frn(conv(x, 1)))
        for down in self.blocks:
            y = frn(conv(swish(frn(conv(x, 2 if down else 1))), 1))
            x = swish((conv(x, 2) if down else x) + y)
        return F.linear(torch.mean(x, dim=(2, 3)), next(w), next(w))
