"""Split HMC: the driver over symmetric-splitting trajectories.

Counterpart of ``hamiltorch_tpu/samplers/splitting.py`` (the splitting path
of the reference's ``sample``: the Hamiltonian sums all M terms, reference:
hamiltorch/samplers.py:787-796, and the leapfrog dispatches to a splitting
branch, samplers.py:465-603).

A term function is ``term_fn(theta, m)``, or ``term_fn(theta, m, data)``
with ``data`` (e.g. stacked (M, B, ...) minibatch tensors, on the chain's
device) passed along; ``m`` is a host int.  Each term's gradient is
``torch.func.grad`` of it, ``vmap``-ed over the chain axis, unless
``pass_grad`` gives the per-term gradients.  The Metropolis energies use the
terms' exact sum, added in order m = 0..M-1 (``stacked_total_logp``), so
that the sampler and its checkpointed and offloaded runners agree bit for
bit.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..enums import Integrator
from ..integrators.splitting import splitting_leapfrog
from ..ops.mass import make_diag_mass_tree, make_mass
from ..utils.convert import place_start
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from .driver import ChainState, MCMCConfig, MCMCResult, run_mcmc
from .hmc import _as_like, _first_chain

ADAPT_MASS_REFUSED = (
    "adapt_mass is not supported for splitting integrators — pass a "
    "fixed inv_mass, or estimate one with run_hmc(adapt_mass=True) first."
)
PASS_GRAD_LIST = (
    "For splitting, pass_grad must be a list of per-term gradient "
    "callables matching log_prob_funcs."
)


def terms_from_list(log_prob_funcs: Sequence[Callable]) -> Callable:
    """A Python list of per-subset closures (the reference's splitting
    contract, samplers.py:466-467) as one ``term_fn(theta, m)``."""
    fns = list(log_prob_funcs)

    def term_fn(theta, m):
        return fns[m](theta)

    return term_fn


def grads_from_list(grad_fns: Sequence[Callable]) -> Callable:
    """Per-term gradient closures as one ``grad_fn(theta, m)``."""
    return terms_from_list(grad_fns)


def _bind(fn, data):
    return fn if data is None or fn is None else (lambda theta, m: fn(theta, m, data))


def stacked_total_logp(term_fn, num_terms: int, data):
    """``theta -> sum of the terms``, added in order m = 0..M-1 from a zero
    of theta's dtype; one chain (``vmap`` it over chains).  The sampler and
    the checkpointed runner share it: a resumed chain's first Metropolis test
    must use the cached log-prob of the straight run."""
    fn = _bind(term_fn, data)

    def total_logp(theta):
        leaf = tree_leaves(theta)[0]
        lp = torch.zeros((), dtype=leaf.dtype, device=leaf.device)
        for m in range(num_terms):
            lp = lp + fn(theta, m)
        return lp

    return total_logp


def _run_split_batched(key, theta0, term_fn, num_terms, config, integrator, mass, data,
                       pass_grad=None, init_state=None, init_da=None, start_iter=0,
                       _noise=None) -> MCMCResult:
    """Split HMC over the chains on the leading axis of ``theta0`` (every
    leaf of a tree); ``init_state`` / ``init_da`` / ``start_iter`` continue
    an earlier chunk exactly, as in the JAX package's ``_run_split_jit``."""
    if config.adapt_mass:
        raise ValueError(ADAPT_MASS_REFUSED)
    fn = _bind(term_fn, data)
    user_grad = _bind(pass_grad, data)
    # user per-term gradients replace autograd for the kicks (the reference
    # refuses pass_grad for splitting, samplers.py:468-469; the JAX package
    # extends it); the Metropolis energies still use the exact terms
    grads = [
        torch.func.vmap(
            (lambda t, m=m: user_grad(t, m)) if user_grad is not None
            else torch.func.grad(lambda t, m=m: fn(t, m)))
        for m in range(num_terms)
    ]

    def grad_term(theta, m):
        return grads[m](theta)

    total_logp = torch.func.vmap(stacked_total_logp(term_fn, num_terms, data))
    sample, kinetic, velocity = (torch.func.vmap(f) for f in
                                 (mass.sample, mass.kinetic, mass.velocity))
    steps = config.num_steps_per_sample

    def transition(z, state: ChainState, step_size, perm=None):
        p = sample(z)
        h0 = -state.logp + kinetic(p)
        theta, p_new = splitting_leapfrog(grad_term, num_terms, velocity, state.theta, p,
                                          step_size, steps, integrator, perm=perm)
        logp1 = total_logp(theta)
        h1 = -logp1 + kinetic(p_new)
        return ChainState(theta, logp1, tree_map(torch.zeros_like, theta)), h0, h1

    if init_state is None:
        init_state = ChainState(theta0, total_logp(theta0), tree_map(torch.zeros_like, theta0))
    # one term order per trajectory (the reference draws it once per
    # leapfrog call, samplers.py:550)
    extra = ("perm", num_terms) if integrator == Integrator.SPLITTING_RAND else None
    return run_mcmc(key, init_state, transition, config, init_da=init_da,
                    start_iter=start_iter, extra_noise=extra, _noise=_noise)


def _split_mass(theta0, template, inv_mass):
    """The diagonal tree mass of a tree state, else the flat state's operator."""
    if template is not None:
        return make_diag_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]), template,
                                   "split HMC")
    return make_mass(_as_like(inv_mass, theta0), theta0.shape[-1])


def _prepare_one(theta0, inv_mass):
    """(theta0 with a chain axis of 1, mass) of a single-chain split entry."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, 1, stacked=False)
        return stacked, _split_mass(None, template, inv_mass)
    return theta0[None], _split_mass(theta0, None, inv_mass)


def run_split_hmc_stacked(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config: MCMCConfig,
    integrator: Integrator = Integrator.SPLITTING,
    inv_mass=None,
    data=None,
    pass_grad=None,
    _noise=None,
) -> MCMCResult:
    """Split HMC (one chain) over a term function.

    ``term_fn(theta, m)`` when ``data is None``, else ``term_fn(theta, m,
    data)``; ``pass_grad`` (same signature, returning the per-term gradient)
    replaces autograd for the kicks.  ``theta0`` may be a parameter tree with
    a tree-taking ``term_fn``; diagonal metrics only then (``inv_mass`` None,
    a flat (D,) diagonal or a per-leaf tree of diagonals).  ``key`` is an
    integer seed.  ``_noise = (z (S, D), log_u (S,)[, perm (S, M)])``
    replaces the drawn noise (a test hook; ``perm`` under SPLITTING_RAND).
    """
    stacked, mass = _prepare_one(theta0, inv_mass)
    if _noise is not None:
        _noise = tuple(t[:, None] for t in _noise)
    return _first_chain(_run_split_batched(key, stacked, term_fn, num_terms, config,
                                           integrator, mass, data, pass_grad=pass_grad,
                                           _noise=_noise))


def run_split_hmc_chains(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config: MCMCConfig,
    num_chains: int,
    integrator: Integrator = Integrator.SPLITTING,
    inv_mass=None,
    data=None,
    pass_grad=None,
    _noise=None,
) -> MCMCResult:
    """Independent split-HMC chains batched on a leading axis.

    Term contract as :func:`run_split_hmc_stacked`; the data is shared by
    the chains, so the chain axis batches every per-term product.
    ``theta0`` may be (D,) (copied), (num_chains, D), or a parameter tree,
    single-state (copied) or (C, ...)-stacked.  ``_noise = (z (S, C, D),
    log_u (S, C)[, perm (S, C, M)])`` replaces the drawn noise (a test hook).
    """
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, theta0 = stack_param_tree(theta0, num_chains)
    else:
        template = None
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
    mass = _split_mass(theta0, template, inv_mass)
    return _run_split_batched(key, theta0, term_fn, num_terms, config, integrator, mass,
                              data, pass_grad=pass_grad, _noise=_noise)


def run_split_hmc(
    key: int,
    log_prob_funcs: List[Callable],
    theta0,
    config: MCMCConfig,
    integrator: Integrator = Integrator.SPLITTING,
    inv_mass=None,
    pass_grad=None,
    _noise=None,
) -> MCMCResult:
    """Split HMC over a list of per-subset log-prob closures.

    ``pass_grad``: optional list of per-term gradient callables, one per
    log-prob term (the JAX package's extension past the reference's
    refusal).
    """
    grad_fn = None
    if pass_grad is not None:
        if not isinstance(pass_grad, (list, tuple)) or len(pass_grad) != len(log_prob_funcs):
            raise RuntimeError(PASS_GRAD_LIST)
        grad_fn = grads_from_list(pass_grad)
    return run_split_hmc_stacked(key, terms_from_list(log_prob_funcs), len(log_prob_funcs),
                                 theta0, config, integrator=integrator, inv_mass=inv_mass,
                                 pass_grad=grad_fn, _noise=_noise)
