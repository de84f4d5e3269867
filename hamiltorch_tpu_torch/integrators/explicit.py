"""Explicit RMHMC on the doubled phase space (Cobb et al. 2019).

Counterpart of ``hamiltorch_tpu/integrators/explicit.py`` (reference:
hamiltorch/samplers.py:389-462).  The state is (theta, theta~, p, p~); each
step applies the phi_HA and phi_HB half-maps, the phi_HC binding rotation
with c = cos(2 omega eps), s = sin(2 omega eps), then phi_HB and phi_HA
again.  As in the JAX package the rotation is applied simultaneously (the
exact rotation the reference's author wrote out; its shipped code rotates
sequentially, samplers.py:441-450).  Every chain of the batch at once, with
the ``vmap``-ed operations of ``ops.metrics.batched``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.metrics import RMHamiltonian, RMOptions
from .implicit import _lanes


class DoubledState(NamedTuple):
    theta: torch.Tensor
    theta_copy: torch.Tensor
    p: torch.Tensor
    p_copy: torch.Tensor


def explicit_leapfrog(
    rm: RMHamiltonian,
    opts: RMOptions,
    theta: torch.Tensor,
    p: torch.Tensor,
    step_size: torch.Tensor,
    num_steps: int,
    jitter_u,
) -> DoubledState:
    """Integrate the binding-term Hamiltonian; both copies start equal."""
    eps = _lanes(step_size, theta)
    angle = 2.0 * opts.explicit_binding_const * eps
    c, s = torch.cos(angle), torch.sin(angle)
    th, thc, mom, momc = theta, theta, p, p
    for _ in range(num_steps):
        # phi_HA: H(theta, p~) moves (p, theta~)
        mom = mom - 0.5 * eps * rm.grad_theta(th, momc, jitter_u)
        thc = thc + 0.5 * eps * rm.grad_p(th, momc, jitter_u)
        # phi_HB: H(theta~, p) moves (theta, p~)
        th = th + 0.5 * eps * rm.grad_p(thc, mom, jitter_u)
        momc = momc - 0.5 * eps * rm.grad_theta(thc, mom, jitter_u)
        # phi_HC: simultaneous rotation mixing the two copies
        th_add, th_sub = th + thc, th - thc
        mom_add, mom_sub = mom + momc, mom - momc
        th, mom, thc, momc = (
            0.5 * (th_add + c * th_sub + s * mom_sub),
            0.5 * (mom_add - s * th_sub + c * mom_sub),
            0.5 * (th_add - c * th_sub - s * mom_sub),
            0.5 * (mom_add + s * th_sub - c * mom_sub),
        )
        # phi_HB again
        th = th + 0.5 * eps * rm.grad_p(thc, mom, jitter_u)
        momc = momc - 0.5 * eps * rm.grad_theta(thc, mom, jitter_u)
        # phi_HA again
        mom = mom - 0.5 * eps * rm.grad_theta(th, momc, jitter_u)
        thc = thc + 0.5 * eps * rm.grad_p(th, momc, jitter_u)
    return DoubledState(th, thc, mom, momc)
