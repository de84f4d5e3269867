"""Riemannian-manifold HMC (implicit, explicit, midpoint and S3 integrators).

Counterpart of ``hamiltorch_tpu/samplers/rmhmc.py`` (the RMHMC paths of the
reference's ``sample``: momentum from N(0, G(theta)), reference:
hamiltorch/samplers.py:183-184; the non-separable Hamiltonian,
samplers.py:677-736; the explicit scheme's energy bookkeeping,
samplers.py:822, 977, 989, which is H_old against H_new of the plain
Riemannian Hamiltonian).

The metric's operations act on one chain and are ``torch.func.vmap``-ed over
the chain axis (``ops.metrics.batched``); the integrators run every chain
at once, with per-lane fixed points (``integrators/implicit.py``).  The
driver draws each chain's momentum normal and, with ``jitter``, one uniform
vector per transition, held along the trajectory (``utils/rng.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..enums import Integrator, Metric
from ..integrators.explicit import explicit_leapfrog
from ..integrators.implicit import implicit_leapfrog
from ..integrators.midpoint import implicit_midpoint
from ..ops.metrics import RMOptions, batched, make_rm_hamiltonian
from ..ops.potential import make_flat_potential, resolve_potential
from ..utils.convert import place_start
from ..utils.pytree import (
    is_param_tree,
    ravel_pytree_fn,
    stack_param_tree,
    tree_leaves,
    unravel_last_axis_fn,
)
from .driver import ChainState, MCMCConfig, MCMCResult, run_mcmc
from .hmc import _first_chain

ADAPT_MASS_REFUSED = (
    "adapt_mass is not supported for RMHMC: its metric G(theta) is "
    "position-dependent, there is no fixed mass matrix to estimate."
)


def rmhmc_transition(rm, opts: RMOptions, integrator: Integrator, num_steps: int):
    """Every chain's RMHMC proposal: momentum chol(G) z -> the integrator ->
    energies.  ``rm`` holds the batched operations (``ops.metrics.batched``);
    ``jitter_u`` (C, D) is the transition's jitter uniform, or None."""

    def transition(z, state: ChainState, step_size, jitter_u=None):
        p = rm.sample_momentum(z, state.theta, jitter_u)
        h0 = rm.ham(state.theta, p, jitter_u)
        aux = None
        if integrator == Integrator.EXPLICIT:
            end = explicit_leapfrog(rm, opts, state.theta, p, step_size, num_steps, jitter_u)
            theta1, p1 = end.theta, end.p
        else:  # IMPLICIT and S3 run the generalized leapfrog, MIDPOINT its own
            integrate = implicit_midpoint if integrator == Integrator.MIDPOINT else implicit_leapfrog
            theta1, p1, fp_iters, fp_residual = integrate(
                rm, opts, state.theta, p, step_size, num_steps, jitter_u)
            aux = {"fp_iters": fp_iters, "fp_residual": fp_residual}
        h1, logp1 = rm.ham_and_logp(theta1, p1, jitter_u)
        proposal = ChainState(theta1, logp1, torch.zeros_like(theta1))
        return (proposal, h0, h1) if aux is None else (proposal, h0, h1, aux)

    return transition


def _run_rmhmc_batched(key, theta0, log_prob_fn, config, integrator, opts, ham_func,
                       custom_metric=None, init_state=None, init_da=None, start_iter=0,
                       _noise=None) -> MCMCResult:
    """RMHMC over the chains on the leading axis of ``theta0`` (C, D);
    ``init_state`` / ``init_da`` / ``start_iter`` continue an earlier chunk
    exactly, as in the JAX package's ``_run_rmhmc_jit``."""
    if config.adapt_mass:
        raise ValueError(ADAPT_MASS_REFUSED)
    rm = make_rm_hamiltonian(log_prob_fn, opts, ham_func=ham_func,
                             semi_separable=integrator == Integrator.S3,
                             custom_metric=custom_metric)
    use_jitter = opts.jitter is not None
    transition = rmhmc_transition(batched(rm, use_jitter), opts, integrator,
                                  config.num_steps_per_sample)
    if init_state is None:
        init_state = ChainState(theta0, torch.func.vmap(log_prob_fn)(theta0),
                                torch.zeros_like(theta0))
    return run_mcmc(key, init_state, transition, config, init_da=init_da,
                    start_iter=start_iter,
                    extra_noise=("uniform", theta0.shape[-1]) if use_jitter else None,
                    _noise=_noise)


def resolve_rmhmc_options(kwargs: dict):
    """(integrator, opts, ham_func, custom_metric) from a kwargs dict, the
    keyword surface of ``run_rmhmc`` shared by the offloaded and
    checkpointed runners.  Raises TypeError on unknown keys and
    NotImplementedError on a non-RMHMC integrator."""
    kw = dict(kwargs)
    integrator = kw.pop("integrator", Integrator.IMPLICIT)
    ham_func = kw.pop("ham_func", None)
    custom_metric = kw.pop("custom_metric", None)
    softabs = kw.pop("softabs_const", None)
    opts = RMOptions(
        metric=kw.pop("metric", Metric.HESSIAN),
        jitter=kw.pop("jitter", None),
        softabs_const=softabs if softabs is not None else 1e6,
        explicit_binding_const=kw.pop("explicit_binding_const", 100.0),
        fixed_point_threshold=kw.pop("fixed_point_threshold", 1e-5),
        fixed_point_max_iterations=kw.pop("fixed_point_max_iterations", 1000),
    )
    if kw:
        raise TypeError(f"unknown RMHMC options: {sorted(kw)}")
    if integrator not in (Integrator.IMPLICIT, Integrator.EXPLICIT,
                          Integrator.S3, Integrator.MIDPOINT):
        raise NotImplementedError(f"RMHMC integrator {integrator}")
    return integrator, opts, ham_func, custom_metric


def _with_chain_axis(noise):
    """A single chain's ``_noise`` (leading draws axis) with a chain axis of 1."""
    return None if noise is None else tuple(t[:, None] for t in noise)


def run_rmhmc(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: MCMCConfig,
    integrator: Integrator = Integrator.IMPLICIT,
    metric: Metric = Metric.HESSIAN,
    jitter: Optional[float] = None,
    softabs_const: Optional[float] = None,
    explicit_binding_const: float = 100.0,
    fixed_point_threshold: float = 1e-5,
    fixed_point_max_iterations: int = 1000,
    ham_func: Optional[Callable] = None,
    custom_metric: Optional[Callable] = None,
    _noise=None,
) -> MCMCResult:
    """Sample one RMHMC chain.

    ``custom_metric``: an analytic ``theta -> (D, D)`` SPD metric G(theta)
    in place of the Hessian / softabs pipeline.  ``theta0`` may be a
    parameter tree: the metric is a dense (D, D) object, so the state is
    ravelled once at the boundary and the samples unravelled back to
    (N, ...) leaves; ``log_prob_fn`` takes the tree, ``ham_func`` and
    ``custom_metric`` the flat theta.  ``key`` is an integer seed.
    ``_noise = (z (S, D), log_u (S,)[, jitter_u (S, D)])`` replaces the
    drawn noise (a test hook; ``jitter_u`` with ``jitter``).
    """
    kwargs = dict(integrator=integrator, metric=metric, jitter=jitter,
                  softabs_const=softabs_const, explicit_binding_const=explicit_binding_const,
                  fixed_point_threshold=fixed_point_threshold,
                  fixed_point_max_iterations=fixed_point_max_iterations,
                  ham_func=ham_func, custom_metric=custom_metric)
    if is_param_tree(theta0):
        return _run_rmhmc_tree(run_rmhmc, key, log_prob_fn, theta0, config,
                               dict(kwargs, _noise=_noise))
    theta0 = place_start(theta0)
    integrator, opts, ham_func, custom_metric = resolve_rmhmc_options(kwargs)
    lp = resolve_potential(log_prob_fn)
    return _first_chain(_run_rmhmc_batched(key, theta0[None], lp, config, integrator, opts,
                                           ham_func, custom_metric,
                                           _noise=_with_chain_axis(_noise)))


def _run_rmhmc_tree(runner, key, log_prob_fn, theta0, config, kwargs,
                    num_chains=None, theta0_is_stacked=None) -> MCMCResult:
    """Run a flat RMHMC entry on a parameter-tree state: ravel once at the
    boundary (the potential unravels its flat argument) and unravel the
    (.., N, D) trace back to (.., N, ...) leaves."""
    theta0 = place_start(theta0)
    if num_chains is None:
        template = theta0
        flat0 = ravel_pytree_fn(template)[0]
        runner_kwargs = {}
    else:
        template, stacked = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        # per-chain flat rows in leaf order
        flat0 = torch.cat([leaf.reshape(num_chains, -1) for leaf in tree_leaves(stacked)],
                          dim=-1)
        runner_kwargs = {"num_chains": num_chains}
    lp_flat = make_flat_potential(log_prob_fn, template)
    result = runner(key, lp_flat, flat0, config, **runner_kwargs, **kwargs)
    unravel = unravel_last_axis_fn(template)
    return result._replace(
        samples=unravel(result.samples),
        final_state=result.final_state._replace(
            theta=unravel(result.final_state.theta),
            grad=unravel(result.final_state.grad),
        ),
    )


def run_rmhmc_chains(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: MCMCConfig,
    num_chains: int,
    integrator: Integrator = Integrator.IMPLICIT,
    metric: Metric = Metric.HESSIAN,
    jitter: Optional[float] = None,
    softabs_const: Optional[float] = None,
    explicit_binding_const: float = 100.0,
    fixed_point_threshold: float = 1e-5,
    fixed_point_max_iterations: int = 1000,
    ham_func: Optional[Callable] = None,
    custom_metric: Optional[Callable] = None,
    theta0_is_stacked: Optional[bool] = None,
    _noise=None,
) -> MCMCResult:
    """Independent RMHMC chains batched on a leading axis.

    ``theta0``: (D,) copied to every chain, (num_chains, D), or a parameter
    tree (single state or (C, ...)-stacked leaves, ravelled once at the
    boundary; ``theta0_is_stacked`` overrides the detection).  A fixed point
    runs until every chain's has converged or stopped, a converged chain
    keeping its value, as the JAX package's vmapped while loops do.  Results
    carry the chain axis first.  ``_noise = (z (S, C, D), log_u (S, C)[,
    jitter_u (S, C, D)])`` replaces the drawn noise (a test hook).
    """
    kwargs = dict(integrator=integrator, metric=metric, jitter=jitter,
                  softabs_const=softabs_const, explicit_binding_const=explicit_binding_const,
                  fixed_point_threshold=fixed_point_threshold,
                  fixed_point_max_iterations=fixed_point_max_iterations,
                  ham_func=ham_func, custom_metric=custom_metric)
    if is_param_tree(theta0):
        return _run_rmhmc_tree(run_rmhmc_chains, key, log_prob_fn, theta0, config,
                               dict(kwargs, _noise=_noise), num_chains=num_chains,
                               theta0_is_stacked=theta0_is_stacked)
    theta0 = place_start(theta0)
    if theta0.ndim == 1:
        theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
    integrator, opts, ham_func, custom_metric = resolve_rmhmc_options(kwargs)
    lp = resolve_potential(log_prob_fn)
    return _run_rmhmc_batched(key, theta0, lp, config, integrator, opts, ham_func,
                              custom_metric, _noise=_noise)
