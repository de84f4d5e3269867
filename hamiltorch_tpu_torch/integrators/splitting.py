"""Symmetric-split (minibatch Hamiltonian splitting) integrators.

Counterpart of ``hamiltorch_tpu/integrators/splitting.py`` (the splitting
branches of the reference's leapfrog, reference: hamiltorch/samplers.py:465-603;
Cobb & Jalaian 2021):

* SPLITTING       -- symmetric sweep m = 0..M-1 then reversed, drift
                     eps/(2(M-1)) between kicks;
* SPLITTING_RAND  -- one random term order per trajectory, per-term
                     kick / drift(eps/M) / kick;
* SPLITTING_KMID  -- all half-kicks, one full drift, all half-kicks reversed.

Every chain of the batch at once.  The term index is a host int:
``grad_term(theta, m)`` gives every chain's gradient of term ``m``.  Under
SPLITTING_RAND the chains' orders differ, so each position's kick groups the
chains by their term and evaluates each group's gradient once (one gradient
per chain and kick, as in the unbatched sampler); the orders come to the
host once per trajectory.

As in the JAX package, every mass operator drifts: the reference skips the
drift under a block ``inv_mass`` in its splitting branches
(samplers.py:514-515), a fault not reproduced.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..enums import Integrator
from ..utils.pytree import tree_leaves, tree_map

SINGLE_TERM = (
    "For symmetric splitting log_prob_func must be list of functions greater than length 1"
)


def _scaled(scale: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``scale`` (C,) times ``leaf`` (C, ...), lane by lane."""
    return scale.reshape(scale.shape + (1,) * (leaf.ndim - 1)) * leaf


def _kick(mom, g, scale):
    return tree_map(lambda ml, gl: ml + _scaled(scale, gl), mom, g)


def _drift(th, v, scale):
    return tree_map(lambda tl, vl: tl + _scaled(scale, vl), th, v)


def _grad_by_term(grad_term, theta, terms: list):
    """Every chain's gradient of its own term ``terms[c]``: one evaluation
    per distinct term, on that term's chains."""
    if len(set(terms)) == 1:
        return grad_term(theta, terms[0])
    device = tree_leaves(theta)[0].device
    out = None
    for m in sorted(set(terms)):
        idx = torch.tensor([c for c, t in enumerate(terms) if t == m], device=device)
        g = grad_term(tree_map(lambda leaf: leaf[idx], theta), m)
        if out is None:
            out = tree_map(lambda leaf, gl: gl.new_empty(leaf.shape), theta, g)
        tree_map(lambda buf, gl: buf.index_copy_(0, idx, gl), out, g)
    return out


def splitting_leapfrog(
    grad_term: Callable,
    num_terms: int,
    velocity: Callable,
    theta,
    p,
    step_size: torch.Tensor,
    num_steps: int,
    integrator: Integrator,
    perm: Optional[torch.Tensor] = None,
):
    """Integrate every chain with per-term gradients ``grad_term(theta, m)``.

    ``theta`` / ``p`` are (C, D) or trees of (C, ...) leaves, ``velocity``
    the batched M^-1 p, ``step_size`` (C,), ``perm`` (C, M) each chain's
    SPLITTING_RAND term order (None: 0..M-1).
    """
    eps = step_size
    th, mom = theta, p
    if integrator == Integrator.SPLITTING:
        if num_terms == 1:
            raise RuntimeError(SINGLE_TERM)
        k_div = 2 * (num_terms - 1)
        drift = eps / k_div
        no_drift = torch.zeros_like(eps)
        for _ in range(num_steps):
            for m in range(num_terms):
                mom = _kick(mom, grad_term(th, m), 0.5 * eps)
                th = _drift(th, velocity(mom), drift if m < num_terms - 1 else no_drift)
            for m in reversed(range(num_terms)):
                mom = _kick(mom, grad_term(th, m), 0.5 * eps)
                th = _drift(th, velocity(mom), drift if m > 0 else no_drift)
    elif integrator == Integrator.SPLITTING_RAND:
        num_chains = eps.shape[0]
        orders = (perm.tolist() if perm is not None
                  else [list(range(num_terms))] * num_chains)
        for _ in range(num_steps):
            for i in range(num_terms):
                terms = [order[i] for order in orders]
                mom = _kick(mom, _grad_by_term(grad_term, th, terms), 0.5 * eps)
                th = _drift(th, velocity(mom), eps / num_terms)
                mom = _kick(mom, _grad_by_term(grad_term, th, terms), 0.5 * eps)
    elif integrator == Integrator.SPLITTING_KMID:
        if num_terms == 1:
            raise RuntimeError(SINGLE_TERM)
        for _ in range(num_steps):
            for m in range(num_terms):
                mom = _kick(mom, grad_term(th, m), 0.5 * eps)
            th = _drift(th, velocity(mom), eps)
            for m in reversed(range(num_terms)):
                mom = _kick(mom, grad_term(th, m), 0.5 * eps)
    else:
        raise NotImplementedError(f"Not a splitting integrator: {integrator}")
    return th, mom
