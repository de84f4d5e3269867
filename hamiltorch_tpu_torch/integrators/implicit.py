"""Generalized (implicit) leapfrog for non-separable Hamiltonians.

Counterpart of ``hamiltorch_tpu/integrators/implicit.py`` (the reference's
implicit-RMHMC leapfrog, reference: hamiltorch/samplers.py:305-387):

* implicit momentum half-step p* = p0 - eps/2 * dH/dtheta(theta, p*), by
  fixed-point iteration;
* implicit position step
  theta* = theta0 + eps/2 * (dH/dp(theta0, p) + dH/dp(theta*, p));
* explicit final momentum half-step.

Every function here takes a batch of chains on the leading axis and the
``torch.func.vmap``-ed operations of ``ops.metrics.batched``.  The JAX
package runs one chain's ``lax.while_loop`` under ``vmap``: the loop runs
until every lane's condition clears, and a lane that has cleared keeps its
value.  ``_fixed_point`` does the same with a host loop: a mask and an
iteration count per lane, one sync per iteration, and a NaN difference
mapped to -inf so that its lane stops and the divergence reaches the driver.
"""

from __future__ import annotations

import torch

from ..ops.metrics import RMHamiltonian, RMOptions


def _lanes(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain (C,) tensor shaped to broadcast against ``like``."""
    return t.reshape(t.shape + (1,) * (like.ndim - t.ndim))


def _fixed_point(update_fn, x0: torch.Tensor, threshold: float, max_iters: int):
    """Iterate x <- update_fn(x) per lane (leading axis) until the lane's
    max (x_new - x)^2 is at most ``threshold`` or it has run ``max_iters``
    iterations.  Returns ``(x, iters (C,) int32, residual (C,))``."""
    num = x0.shape[0]
    iters = torch.zeros(num, dtype=torch.int32, device=x0.device)
    diff = torch.full((num,), torch.inf, dtype=x0.dtype, device=x0.device)
    x = x0
    active = (iters < max_iters) & (diff > threshold)
    while bool(active.any()):
        x_new = update_fn(x)
        d = torch.amax((x_new - x) ** 2, dim=tuple(range(1, x.ndim)))
        d = torch.where(torch.isnan(d), torch.full_like(d, -torch.inf), d)
        x = torch.where(_lanes(active, x), x_new, x)
        diff = torch.where(active, d, diff)
        iters = torch.where(active, iters + 1, iters)
        active = (iters < max_iters) & (diff > threshold)
    return x, iters, diff


def implicit_leapfrog_step(
    rm: RMHamiltonian,
    opts: RMOptions,
    theta: torch.Tensor,
    p: torch.Tensor,
    step_size: torch.Tensor,
    jitter_u,
):
    """One generalized-leapfrog step of every chain.

    Returns ``(theta', p', fp_iters, fp_residual)``: the larger of the two
    fixed points' iteration counts and final squared successive differences,
    per chain.
    """
    eps = _lanes(step_size, theta)
    thr = opts.fixed_point_threshold
    iters = opts.fixed_point_max_iterations

    p_half, it_p, res_p = _fixed_point(
        lambda p_cur: p - 0.5 * eps * rm.grad_theta(theta, p_cur, jitter_u),
        p, thr, iters,
    )
    v_old = rm.grad_p(theta, p_half, jitter_u)
    theta_new, it_t, res_t = _fixed_point(
        lambda th_cur: theta + 0.5 * eps * (v_old + rm.grad_p(th_cur, p_half, jitter_u)),
        theta, thr, iters,
    )
    p_new = p_half - 0.5 * eps * rm.grad_theta(theta_new, p_half, jitter_u)
    return theta_new, p_new, torch.maximum(it_p, it_t), torch.maximum(res_p, res_t)


def implicit_leapfrog(
    rm: RMHamiltonian,
    opts: RMOptions,
    theta: torch.Tensor,
    p: torch.Tensor,
    step_size: torch.Tensor,
    num_steps: int,
    jitter_u,
):
    """``num_steps`` generalized-leapfrog steps.  Returns ``(theta, p,
    fp_iters, fp_residual)``, the diagnostics maxed over the steps."""
    its, ress = [], []
    for _ in range(num_steps):
        theta, p, it, res = implicit_leapfrog_step(rm, opts, theta, p, step_size, jitter_u)
        its.append(it)
        ress.append(res)
    return theta, p, torch.stack(its).amax(0), torch.stack(ress).amax(0)
