"""Velocity-Verlet (leapfrog) integrator.

Counterpart of ``hamiltorch_tpu/integrators/leapfrog.py``: a half kick, L
drift+kick steps, and half a kick pulled back at the end.  The gradient at
the start point is carried in, so a trajectory costs exactly L
``value_and_grad`` evaluations, and only the endpoint is kept.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.pytree import tree_map


class PhasePoint(NamedTuple):
    """Endpoint of a trajectory with its cached potential evaluation."""

    theta: torch.Tensor
    momentum: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


def leapfrog(
    value_and_grad_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    mass,
    start: PhasePoint,
    step_size,
    num_steps: int,
) -> PhasePoint:
    """Integrate Hamilton's equations for ``num_steps`` leapfrog steps.

    ``start`` carries ``logp``/``grad`` at ``start.theta``; the result
    carries them at the endpoint.  ``theta`` and the momentum may be flat
    tensors or parameter trees.
    """
    eps = step_size
    p = tree_map(lambda p, g: p + 0.5 * eps * g, start.momentum, start.grad)
    theta, logp, grad = start.theta, start.logp, start.grad
    for _ in range(num_steps):
        theta = tree_map(lambda t, v: t + eps * v, theta, mass.velocity(p))
        logp, grad = value_and_grad_fn(theta)
        p = tree_map(lambda p, g: p + eps * g, p, grad)
    # the loop applies a full kick at the endpoint; pull half of it back
    p = tree_map(lambda p, g: p - 0.5 * eps * g, p, grad)
    return PhasePoint(theta=theta, momentum=p, logp=logp, grad=grad)
