"""The work the algorithms need, counted from the shapes.

Operations and bytes of the algorithm, never of one implementation: a
product is 2 operations a multiply-add whatever precision split runs it,
each input is read once and each output written once, float32 throughout.
The rooflines and the whole-step shares of the chip's peak are built on
these, and ``benchmark/tests`` checks them at the cells' sizes.
"""

from __future__ import annotations

F32 = 4


def bnn_params(cfg: dict) -> int:
    return cfg["in_dim"] * cfg["hidden"] + 2 * cfg["hidden"] + 1


def bnn_gradient_flops(cfg: dict, chains: int) -> int:
    """One gradient of every chain: the forward x W1 and the backward
    x^T da, 2 N I H operations each (the rest is O(N H) a chain)."""
    return 4 * cfg["n_data"] * cfg["in_dim"] * cfg["hidden"] * chains


def bnn_gradient_bytes(cfg: dict, chains: int) -> int:
    """x and y read, every chain's theta read and its gradient written once."""
    return F32 * (cfg["n_data"] * (cfg["in_dim"] + 1) + 2 * chains * bnn_params(cfg))


def gaussian_flops(dims: int, chains: int, draws: int, steps: int) -> int:
    """One call of HMC on a dense Gaussian: a (C, D) x (D, D) product and
    4 D elementwise operations (kick, drift) a chain and leapfrog step."""
    return chains * draws * steps * (2 * dims * dims + 4 * dims)


def gaussian_bytes(dims: int, chains: int, draws: int) -> int:
    """P and the chains' start read once, every draw written once."""
    return F32 * (dims * dims + chains * dims + chains * draws * dims)
