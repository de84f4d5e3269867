"""ResNet-20 with filter response normalisation and swish (ResNet-20-FRN).

The network of Izmailov et al., *What Are Bayesian Neural Network
Posteriors Really Like?* (arXiv:2104.14421), whose full-batch HMC on
CIFAR-10 is a reference posterior of Bayesian deep learning; their code
names it ``resnet20_frn_swish`` (google-research ``bnn_hmc``).  In NCHW,
every convolution with a bias:

* stem: conv 3x3 (in -> 16), FRN, swish;
* three stages of three basic blocks at widths 16, 32 and 64; a block
  computes y = FRN(conv3x3(swish(FRN(conv3x3(x))))) and x <- swish(x + y).
  The first block of stages 2 and 3 has stride 2 in its first convolution,
  and its shortcut is a 1x1 convolution of stride 2 with no normalisation;
* head: the global average pool (8x8 at 32x32 inputs) and a linear layer
  to the logits.

Filter response normalisation with its thresholded linear unit (Singh and
Krishnan, arXiv:1911.09737), per channel:
nu2 = mean over H and W of x^2, z = max(gamma x / sqrt(nu2 + eps) + beta, tau);
on CUDA tensors one hand-written kernel each way (``kernels/frn_tlu.py``),
on the CPU the plain formula.  The 16 convolutions of stride 1 from C to C
channels (``Conv3x3``) run, on CUDA tensors, on hand-written kernels
(``kernels/conv3x3.py``); the stem, the stride-2 convolutions and the 1x1
shortcuts are ``nn.Conv2d``.  Swish is x sigmoid(x) (``nn.SiLU``).  At
32x32 inputs and 10 classes the network has 273,754 parameters.

Departures from ``bnn_hmc``: PyTorch's NCHW layout and ``parameters()``
order define the flat parameter vector, not haiku's (NHWC, HWIO kernels,
alphabetical module order); the parameters start at PyTorch's default
initialisation with FRN's gamma at 1 and beta and tau at 0, where a
sampler's start is the caller's to set.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.conv3x3 import conv3x3
from ..kernels.frn_tlu import frn_tlu


class FilterResponseNorm(nn.Module):
    """FRN with TLU: max(gamma x / sqrt(mean_hw x^2 + eps) + beta, tau), per channel."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        shape = (1, channels, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.tau = nn.Parameter(torch.zeros(shape))
        self.eps = eps

    def forward(self, x):
        return frn_tlu(x, self.gamma, self.beta, self.tau, self.eps)


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(channels, channels, 3, padding=1)``: its parameters, their
    names and its initialisation, computed by ``kernels/conv3x3.py``."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=1)

    def forward(self, x):
        if self.stride != (1, 1) or self.padding != (1, 1) or self.dilation != (1, 1):
            raise ValueError("Conv3x3 is a convolution of stride 1, padding 1 and dilation 1")
        return conv3x3(x, self.weight, self.bias)


class _Block(nn.Module):
    """x <- swish(shortcut(x) + FRN(conv(swish(FRN(conv(x))))))."""

    def __init__(self, cin: int, cout: int, stride: int, eps: float):
        super().__init__()
        self.conv1 = (Conv3x3(cout) if stride == 1 and cin == cout
                      else nn.Conv2d(cin, cout, 3, stride=stride, padding=1))
        self.norm1 = FilterResponseNorm(cout, eps)
        self.conv2 = Conv3x3(cout)
        self.norm2 = FilterResponseNorm(cout, eps)
        self.shortcut = nn.Conv2d(cin, cout, 1, stride=stride) if stride != 1 else None
        self.act = nn.SiLU()

    def forward(self, x):
        y = self.norm2(self.conv2(self.act(self.norm1(self.conv1(x)))))
        return self.act((x if self.shortcut is None else self.shortcut(x)) + y)


def resnet20_frn_swish(num_classes: int = 10, frn_eps: float = 1e-6, in_channels: int = 3,
                       widths=(16, 32, 64), blocks_per_stage: int = 3) -> nn.Sequential:
    """ResNet-20-FRN with swish; the defaults are the published network."""
    layers = [nn.Conv2d(in_channels, widths[0], 3, padding=1),
              FilterResponseNorm(widths[0], frn_eps), nn.SiLU()]
    cin = widths[0]
    for stage, width in enumerate(widths):
        for block in range(blocks_per_stage):
            stride = 2 if stage > 0 and block == 0 else 1
            layers.append(_Block(cin, width, stride, frn_eps))
            cin = width
    layers += [nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(cin, num_classes)]
    return nn.Sequential(*layers)
