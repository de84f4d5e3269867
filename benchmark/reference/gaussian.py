"""Plain reference of HMC on a Gaussian target N(mean, P^-1), identity mass.

Per draw, as the port's ``gaussian_hmc`` defines it: momenta from Philox
stream 0 (four normals a counter), a half kick, L drift and kick steps,
half a kick pulled back, and the Metropolis test (h0 - h1) >= log u with u
from stream 1, where h = 1/2 |p|^2 + 1/2 (theta - mean) P (theta - mean)
is reduced in float64.  The gradient -(theta - mean) P is one (C, D) x
(D, D) product a step.
"""

from __future__ import annotations

import torch

from .numerics import dtype, matmul
from .philox import log_uniform, quad_normals, seed_key

NOISE_BLOCK = 1 << 22  # normals drawn at once


F32_ROUND = 2.0**-24  # float32's unit roundoff


def _energy(delta, g, p):
    return 0.5 * torch.sum(p.double() ** 2 - delta.double() * g.double(), dim=1)


def _size(delta, abs_p):
    """|delta|^T |P| |delta| (C,), float64: what float32 rounding of the
    potential 1/2 delta^T P delta is in proportion to."""
    a = delta.double().abs()
    return torch.sum(a * (a @ abs_p), dim=1)


def hmc(seed, theta0, precision, mean, draws: int, steps: int, eps: float, prec: str = "float64",
        margin: float = 0.0, rounding: float = 0.0, taken=None):
    """Yield (draw, theta after it (C, D), margin (C,) float64, accepted (C,)
    bool, tolerance (C,) float64) per draw.

    A decision is within rounding where its margin |(h0 - h1) - log u| is
    below the tolerance ``margin + rounding * u32 * (s0 + s1)``, with u32
    float32's unit roundoff and s = |delta|^T |P| |delta| at the draw's
    start and proposal: float32 arithmetic of the energies errs in
    proportion to s, which an ill-conditioned P makes large far along its
    broad directions.  There the decisions ``taken`` (C, draws) bool, those
    another sampler took on the same chains, are followed.
    """
    dt = dtype(prec)
    key = seed_key(seed)
    c, d = theta0.shape
    chain = torch.arange(c, device=theta0.device)
    P, mu = precision.to(dt), mean.to(dt)
    abs_p = precision.double().abs()

    def grad(th):
        return -matmul(th - mu, P, prec)

    theta = theta0.to(dt)
    g_cur = grad(theta)
    s_cur = _size(theta - mu, abs_p)
    block = max(1, NOISE_BLOCK // (c * d))
    for n in range(draws):
        if n % block == 0:  # the noise of the next ``block`` draws at once
            ns = torch.arange(n, min(n + block, draws), device=theta0.device)
            momenta, log_u = quad_normals(key, ns, chain, d), log_uniform(key, ns, chain)
        p = momenta[n % block].to(dt)
        h0 = _energy(theta - mu, g_cur, p)
        p = p + (0.5 * eps) * g_cur
        th = theta
        for s in range(1, steps + 1):
            th = th + eps * p
            g = grad(th)
            p = p + (eps if s < steps else 0.5 * eps) * g
        h1 = _energy(th - mu, g, p)
        m = (h0 - h1) - log_u[n % block]
        s_new = _size(th - mu, abs_p)
        tol = margin + rounding * F32_ROUND * (s_cur + s_new)
        accept = m >= 0
        if taken is not None:
            accept = torch.where(m.abs() < tol, taken[:, n], accept)
        theta = torch.where(accept[:, None], th, theta)
        g_cur = torch.where(accept[:, None], g, g_cur)
        s_cur = torch.where(accept, s_new, s_cur)
        yield n, theta, m, accept, tol
