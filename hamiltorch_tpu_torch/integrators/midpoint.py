"""Implicit midpoint integrator for non-separable (Riemannian) Hamiltonians.

Counterpart of ``hamiltorch_tpu/integrators/midpoint.py``, the JAX
package's extension past the reference's integrators (Brofos & Lederman,
arXiv:2102.07139):

    z_bar  = z_n + (eps/2) * J grad H(z_bar),      z = (theta, p)
    z_next = 2 * z_bar - z_n

symplectic and symmetric for any Hamiltonian, with ONE fixed point per step
over the joint phase-space point.  It shares ``_fixed_point`` (per-lane
masks, NaN exit, iteration and residual diagnostics) with the generalized
leapfrog.
"""

from __future__ import annotations

import torch

from ..ops.metrics import RMHamiltonian, RMOptions
from .implicit import _fixed_point, _lanes


def implicit_midpoint_step(
    rm: RMHamiltonian,
    opts: RMOptions,
    theta: torch.Tensor,
    p: torch.Tensor,
    step_size: torch.Tensor,
    jitter_u,
):
    """One implicit-midpoint step of every chain.  Returns
    ``(theta', p', fp_iters, fp_residual)``."""
    eps = _lanes(step_size, theta)
    d = theta.shape[-1]
    z0 = torch.cat([theta, p], dim=-1)

    def update(z):
        th_b, p_b = z[..., :d], z[..., d:]
        dtheta = rm.grad_p(th_b, p_b, jitter_u)  # dH/dp = theta-dot
        dp = -rm.grad_theta(th_b, p_b, jitter_u)  # -dH/dtheta = p-dot
        return z0 + 0.5 * eps * torch.cat([dtheta, dp], dim=-1)

    z_bar, it, res = _fixed_point(
        update, z0, opts.fixed_point_threshold, opts.fixed_point_max_iterations
    )
    z_new = 2.0 * z_bar - z0
    return z_new[..., :d], z_new[..., d:], it, res


def implicit_midpoint(
    rm: RMHamiltonian,
    opts: RMOptions,
    theta: torch.Tensor,
    p: torch.Tensor,
    step_size: torch.Tensor,
    num_steps: int,
    jitter_u,
):
    """``num_steps`` implicit-midpoint steps.  Returns ``(theta, p,
    fp_iters, fp_residual)``, the diagnostics maxed over the steps."""
    its, ress = [], []
    for _ in range(num_steps):
        theta, p, it, res = implicit_midpoint_step(rm, opts, theta, p, step_size, jitter_u)
        its.append(it)
        ress.append(res)
    return theta, p, torch.stack(its).amax(0), torch.stack(ress).amax(0)
