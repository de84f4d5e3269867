"""Plain reference of the tanh-MLP regression BNN and its HMC sampler.

The model (the configuration ``bnn_flagship``):

    o = tanh(x W1 + b1) w2 + b2,
    logp = -tau/2 sum (o - y)^2 - 1/2 |theta|^2,

over chains on a leading axis, with the gradient written out by hand.  The
sampler follows the port's fused kernel's definition (per draw: momenta
from Philox stream 0, a half kick, L drift and kick steps, half a kick
pulled back, accept when (h0 - h1) >= log u with u from stream 1), written
from the equations and not taken from the port.

Flat parameters are laid out w1 (row-major, I x H), b1, w2, b2, the layout
the kernels key their random numbers on.  Energies are reduced in float64
in every precision.
"""

from __future__ import annotations

import torch

from .numerics import dtype, matmul
from .philox import log_uniform, pair_normals, seed_key

def dims(i_dim: int, hidden: int) -> int:
    return i_dim * hidden + 2 * hidden + 1


def split(flat: torch.Tensor, i_dim: int, hidden: int) -> tuple:
    """(w1, b1, w2, b2) views of flat (L, D) parameters."""
    s0, s1 = i_dim * hidden, i_dim * hidden + hidden
    return (flat[:, :s0].reshape(-1, i_dim, hidden), flat[:, s0:s1],
            flat[:, s1:s1 + hidden], flat[:, s1 + hidden])


def join(parts) -> torch.Tensor:
    return torch.cat([t.reshape(t.shape[0], -1) for t in parts], dim=1)


def sq_sum(parts) -> torch.Tensor:
    return sum(torch.sum(t.double().reshape(t.shape[0], -1) ** 2, dim=1) for t in parts)


def grads_and_logp(x, y, theta, tau: float, prec: str):
    """Gradient of logp for every chain ((w1, b1, w2, b2) parts) and logp (float64)."""
    w1, b1, w2, b2 = theta
    a = matmul(x, w1, prec) + b1[:, None, :]  # (L, N, H)
    h = torch.tanh(a)
    o = torch.sum(h * w2[:, None, :], dim=-1) + b2[:, None]  # (L, N)
    resid = o - y[:, 0]
    d = -tau * resid
    da = d[..., None] * w2[:, None, :] * (1.0 - h * h)
    grads = (matmul(x.T, da, prec) - w1, torch.sum(da, dim=1) - b1,
             torch.sum(h * d[..., None], dim=1) - w2, torch.sum(d, dim=1) - b2)
    logp = -0.5 * tau * torch.sum(resid.double() ** 2, dim=1) - 0.5 * sq_sum(theta)
    return grads, logp


def _take(tensors, idx):
    return [torch.cat((t, t[idx])) for t in tensors]


def hmc(seed, x, y, theta, draws: int, steps: int, eps: float, tau: float, prec: str = "float64",
        margin: float = 0.0, max_lanes: int = 4):
    """HMC over the chains of ``theta`` ((w1, b1, w2, b2), each (C, ...)).

    A decision whose margin |(h0 - h1) - log u| is below ``margin`` may go
    either way under rounding: there the chain's lane is doubled, one copy
    accepting and one rejecting (at most ``max_lanes`` lanes a chain).
    Returns (chain (L,), final parameters (w1, b1, w2, b2) of each lane,
    accepted draws (L,) float64).
    """
    dt = dtype(prec)
    key = seed_key(seed)
    c, i_dim, hidden = theta[0].shape
    d = dims(i_dim, hidden)
    x, y = x.to(dt), y.to(dt)
    cur = [t.to(dt) for t in theta]
    chain = torch.arange(c, device=x.device)
    grad, logp = grads_and_logp(x, y, cur, tau, prec)
    grad = list(grad)
    count = torch.zeros(c, dtype=torch.float64, device=x.device)
    for n in range(draws):
        z = pair_normals(key, n, chain, d, 0).to(dt)
        h0 = -logp + 0.5 * torch.sum(z.double() ** 2, dim=1)
        p = [pi + (0.5 * eps) * gi for pi, gi in zip(split(z, i_dim, hidden), grad)]
        th = [ti + eps * pi for ti, pi in zip(cur, p)]
        for s in range(1, steps + 1):
            g_new, logp_new = grads_and_logp(x, y, th, tau, prec)
            kick = eps if s < steps else 0.5 * eps
            p = [pi + kick * gi for pi, gi in zip(p, g_new)]
            if s < steps:
                th = [ti + eps * pi for ti, pi in zip(th, p)]
        h1 = -logp_new + 0.5 * sq_sum(p)
        m = (h0 - h1) - log_uniform(key, n, chain)
        accept = m >= 0
        if margin > 0:
            lanes = torch.bincount(chain, minlength=c)[chain]
            idx = torch.nonzero((m.abs() < margin) & (lanes < max_lanes)).flatten()
            if idx.numel():
                k = len(cur)
                flat = _take([*cur, *grad, *th, *g_new, logp, logp_new, count, chain], idx)
                cur, grad, th = flat[:k], flat[k:2 * k], flat[2 * k:3 * k]
                g_new, (logp, logp_new, count, chain) = flat[3 * k:4 * k], flat[4 * k:]
                accept = torch.cat((accept, ~accept[idx]))

        def pick(a, b):
            return torch.where(accept.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

        cur = [pick(a, b) for a, b in zip(th, cur)]
        grad = [pick(a, b) for a, b in zip(g_new, grad)]
        logp = torch.where(accept, logp_new, logp)
        count = count + accept.double()
    return chain, tuple(cur), count

