"""The work of ResNet-20-FRN's full-batch gradient, counted from the shapes.

Operations and bytes of the algorithm (``reference/resnet20_frn.py``'s
equations), never of one implementation, float32 throughout.  A product is
2 operations a multiply-add.  A gradient is the forward, the backward's
input gradients (but the stem's: the images need none) and its weight
gradients, each 2 operations a multiply-add of the forward's products.
The normalisation and activation passes (FRN with TLU, swish, the residual
add) move, a pass and an element: forward, the inputs read once and the
output written once; backward, the upstream gradient and the saved input
read and the input gradient written, and at a residual fork the two
gradients read and their sum written.
"""

from __future__ import annotations

F32 = 4


def _layers(cfg: dict):
    """(c_in, c_out, k, output side) of every convolution, in the forward's
    order, and the side of each stage's activations."""
    side = cfg["image_size"]
    convs = [(cfg["channels_in"], cfg["widths"][0], 3, side)]
    cin, sides = cfg["widths"][0], []
    for stage, width in enumerate(cfg["widths"]):
        for block in range(cfg["blocks_per_stage"]):
            if stage > 0 and block == 0:
                side //= 2
                convs += [(cin, width, 3, side), (width, width, 3, side), (cin, width, 1, side)]
            else:
                convs += [(cin, width, 3, side), (width, width, 3, side)]
            cin = width
        sides.append(side)
    return convs, sides


def resnet20_params(cfg: dict) -> int:
    """Weights and biases of every convolution, FRN's gamma, beta and tau,
    and the head's weight and bias."""
    convs, _ = _layers(cfg)
    norm = 3 * (cfg["widths"][0] + 2 * cfg["blocks_per_stage"] * sum(cfg["widths"]))
    return (sum(o * (i * k * k + 1) for i, o, k, _ in convs) + norm
            + (cfg["widths"][-1] + 1) * cfg["classes"])


def resnet20_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward: every convolution and the head."""
    convs, _ = _layers(cfg)
    return (sum(o * i * k * k * s * s for i, o, k, s in convs)
            + cfg["widths"][-1] * cfg["classes"])


def resnet20_gradient_flops(cfg: dict, chains: int) -> int:
    """One full-batch gradient of every chain: 6 operations a multiply-add
    of the forward (forward, input gradient, weight gradient), less the
    stem's input gradient."""
    i, o, k, s = _layers(cfg)[0][0]
    stem = o * i * k * k * s * s
    return chains * cfg["n_data"] * (6 * resnet20_macs(cfg) - 2 * stem)


def resnet20_norm_act_bytes(cfg: dict, chains: int) -> int:
    """One full-batch gradient of every chain: FRN with TLU and swish (the
    stem's, and two of each a block) 2 + 3 elements moved an element each,
    the residual add 3 + 3, over every image's activations."""
    _, sides = _layers(cfg)
    width0, side0 = cfg["widths"][0], cfg["image_size"]
    stem = width0 * side0 * side0
    block = sum(w * s * s for w, s in zip(cfg["widths"], sides)) * cfg["blocks_per_stage"]
    frn = swish = stem + 2 * block
    return chains * cfg["n_data"] * F32 * (5 * frn + 5 * swish + 6 * block)
