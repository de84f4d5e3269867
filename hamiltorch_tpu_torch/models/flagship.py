"""Flagship benchmark model: a ~100k-parameter regression BNN.

Counterpart of ``hamiltorch_tpu/models/flagship.py``: a 784 -> 128 -> 1 tanh
MLP (100,609 parameters) with an N(0, I) prior and a Gaussian likelihood of
precision ``tau_out``.  The JAX package draws its synthetic data with
``jax.random``, which PyTorch cannot reproduce, so every factory here takes
optional ``x``, ``y`` and ``theta0`` arrays: given the JAX package's, the
two packages compute the same potential.  Without them the data come from a
``torch.Generator`` seeded with ``seed``, by the same recipe.

Every factory builds its tensors on ``device``: the CUDA card when it is
None (and raises without one), the CPU only when asked for.
"""

from __future__ import annotations

import math

import torch

from ..utils.convert import resolve_device

IN_DIM = 784
HIDDEN = 128
N_DATA = 1024


def flagship_dims(in_dim: int = IN_DIM, hidden: int = HIDDEN) -> int:
    return in_dim * hidden + hidden + hidden + 1


def _data(in_dim, hidden, n_data, dtype, seed, x, y, theta0, device):
    """(x, y, theta0) as given, else drawn as the JAX package draws them."""
    gen = torch.Generator().manual_seed(seed)
    if x is None:
        x = torch.randn(n_data, in_dim, generator=gen, dtype=dtype)
        w_teacher = torch.randn(in_dim, generator=gen, dtype=dtype) / math.sqrt(in_dim)
        if y is None:
            y = torch.tanh(x @ w_teacher)[:, None]
    if y is None:
        raise ValueError("y must be given with x")
    if theta0 is None:
        theta0 = 0.01 * torch.randn(flagship_dims(in_dim, hidden), generator=gen, dtype=dtype)
    device = resolve_device(device)
    x, y, theta0 = (torch.as_tensor(a, dtype=dtype, device=device) for a in (x, y, theta0))
    return x, y.reshape(-1, 1), theta0


def make_flagship_potential(
    in_dim: int = IN_DIM,
    hidden: int = HIDDEN,
    n_data: int = N_DATA,
    tau_out: float = 10.0,
    dtype=torch.float32,
    seed: int = 0,
    x=None,
    y=None,
    theta0=None,
    device=None,
):
    """Returns (log_prob_fn, theta0) for the flagship BNN.

    ``theta0`` is flat, in the layout w1 (row-major, in_dim x hidden), b1,
    w2, b2.
    """
    x, y, theta0 = _data(in_dim, hidden, n_data, dtype, seed, x, y, theta0, device)
    s0, s1 = in_dim * hidden, in_dim * hidden + hidden
    s2 = s1 + hidden

    def apply_fn(theta, xb):
        w1 = theta[:s0].reshape(in_dim, hidden)
        b1 = theta[s0:s1]
        w2 = theta[s1:s2].reshape(hidden, 1)
        b2 = theta[s2:]
        h = torch.tanh(xb @ w1 + b1)
        return h @ w2 + b2

    def log_prob_fn(theta):
        prior = -0.5 * torch.dot(theta, theta)
        out = apply_fn(theta, x)
        ll = -0.5 * tau_out * torch.sum((out - y) ** 2)
        return prior + ll

    return log_prob_fn, theta0


def make_flagship_potential_tree(
    in_dim: int = IN_DIM,
    hidden: int = HIDDEN,
    n_data: int = N_DATA,
    tau_out: float = 10.0,
    dtype=torch.float32,
    seed: int = 0,
    x=None,
    y=None,
    theta0=None,
    device=None,
):
    """Tree flagship potential: parameters stay ``{w1, b1, w2, b2}``.

    Same posterior, data and initial point as ``make_flagship_potential``
    (the init is the flat draw split into leaves).  Shapes follow the JAX
    package: w1 (in, hidden), b1 (hidden,), w2 (hidden, 1), b2 (1,).
    """
    x, y, theta0 = _data(in_dim, hidden, n_data, dtype, seed, x, y, theta0, device)
    s0, s1 = in_dim * hidden, in_dim * hidden + hidden
    s2 = s1 + hidden
    params0 = {
        "w1": theta0[:s0].reshape(in_dim, hidden),
        "b1": theta0[s0:s1],
        "w2": theta0[s1:s2].reshape(hidden, 1),
        "b2": theta0[s2:],
    }

    def log_prob_fn(params):
        prior = -0.5 * sum(torch.sum(v * v) for v in params.values())
        h = torch.tanh(x @ params["w1"] + params["b1"])
        out = h @ params["w2"] + params["b2"]
        ll = -0.5 * tau_out * torch.sum((out - y) ** 2)
        return prior + ll

    return log_prob_fn, params0


def make_tiny_potential(
    in_dim: int = 8, hidden: int = 4, n_data: int = 16, seed: int = 0, x=None,
    device=None,
):
    """Small-shape version for quick checks.

    Returns (loglik_shard_fn, log_prior_fn, x, y, theta0) in the JAX
    package's data-sharded potential contract; y = sum(x, 1) and theta0 = 0
    as there, so given the JAX package's ``x`` the two agree.
    """
    device = resolve_device(device)
    if x is None:
        x = torch.randn(n_data, in_dim, generator=torch.Generator().manual_seed(seed))
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.sum(x, dim=1, keepdim=True)
    d = flagship_dims(in_dim, hidden)
    s0, s1 = in_dim * hidden, in_dim * hidden + hidden
    s2 = s1 + hidden

    def apply_fn(theta, xb):
        w1 = theta[:s0].reshape(in_dim, hidden)
        h = torch.tanh(xb @ w1 + theta[s0:s1])
        return h @ theta[s1:s2].reshape(hidden, 1) + theta[s2:]

    def loglik_shard_fn(theta, x_shard, y_shard):
        out = apply_fn(theta, x_shard)
        return -0.5 * torch.sum((out - y_shard) ** 2)

    def log_prior_fn(theta):
        return -0.5 * torch.dot(theta, theta)

    theta0 = torch.zeros(d, dtype=torch.float32, device=device)
    return loglik_shard_fn, log_prior_fn, x, y, theta0
