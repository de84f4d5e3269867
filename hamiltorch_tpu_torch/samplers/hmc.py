"""Euclidean HMC (and the step-size-adapting "HMC_NUTS" mode).

Counterpart of ``hamiltorch_tpu/samplers/hmc.py``: the driver loop with the
leapfrog integrator and a mass operator.  One chain's transition is written
as in the JAX package and ``torch.func.vmap``-ed over the chain axis; the
noise is drawn outside the ``vmap``, one generator per chain and draw.

With windowed mass warmup (``adapt_mass`` and ``burn > 0``) every chain
adapts its own metric, as the JAX package's vmapped chains do: the metric
is a per-chain argument of the vmapped transition, which builds the draw's
mass operator from it.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..integrators.leapfrog import PhasePoint, leapfrog
from ..ops.mass import (
    DENSE_TREE_WARMUP,
    DenseMass,
    DiagMass,
    MassOperator,
    TreeMass,
    diag_tree_mass_view,
    make_mass,
    make_mass_tree,
)
from ..ops.potential import resolve_potential, value_and_grad
from ..utils import profiling
from ..utils.convert import place_start
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from .driver import ChainState, MCMCConfig, MCMCResult, TransitionFn, run_mcmc
from .offload import host_offload_loop
from .warmup import init_metric_seed, schedule_flags, validate_adapt_mass


def hmc_transition(value_and_grad_fn, mass: MassOperator, num_steps: int) -> TransitionFn:
    """One chain's HMC proposal: momentum from ``z`` -> leapfrog -> energies."""

    def transition(z, state: ChainState, step_size):
        p = mass.sample(z)
        h0 = -state.logp + mass.kinetic(p)
        end = leapfrog(
            value_and_grad_fn,
            mass,
            PhasePoint(state.theta, p, state.logp, state.grad),
            step_size,
            num_steps,
        )
        h1 = -end.logp + mass.kinetic(end.momentum)
        return ChainState(end.theta, end.logp, end.grad), h0, h1

    return transition


def init_chain_state(log_prob_fn, theta0) -> ChainState:
    """One chain's state with its potential evaluation at ``theta0``."""
    logp, grad = value_and_grad(log_prob_fn)(theta0)
    return ChainState(theta=theta0, logp=logp, grad=grad)


def _as_like(value, like: torch.Tensor):
    """``value`` (array, tensor, or tree or list of them) on ``like``'s
    device and dtype."""
    if value is None:
        return None
    if is_param_tree(value) or isinstance(value, (list, tuple)):
        return tree_map(lambda v: _as_like(v, like), value)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _reject_tree_adapt_mass(config) -> None:
    """Dense windowed warmup accumulates flat (D, D) moments and runs a
    dense metric: flat states only.  Diagonal warmup takes tree states (the
    Welford moments see one flat view per draw)."""
    if config.adapt_mass == "dense":
        raise ValueError(DENSE_TREE_WARMUP)


def _run_hmc_batched(key, theta0, log_prob_fn, config, mass, init_state=None, init_da=None,
                     start_iter=0, init_warm=None, collect_flags=None, end_flags=None,
                     _noise=None) -> MCMCResult:
    """HMC over chains on the leading axis of every leaf of ``theta0``.

    ``init_state``, ``init_da``, ``start_iter``, ``init_warm`` and the
    schedule's flags continue an earlier chunk exactly, as in the JAX
    package's ``_run_hmc_jit``.
    """
    vg = value_and_grad(log_prob_fn)
    if init_state is None:
        init_state = torch.func.vmap(lambda t: init_chain_state(log_prob_fn, t))(theta0)
    steps = config.num_steps_per_sample
    if not (config.adapt_mass and config.burn > 0):
        transition = torch.func.vmap(hmc_transition(vg, mass, steps))
        return run_mcmc(key, init_state, transition, config, init_da=init_da,
                        start_iter=start_iter, _noise=_noise)

    dense = config.adapt_mass == "dense"
    leaves = tree_leaves(theta0)
    num_chains, dtype, device = leaves[0].shape[0], leaves[0].dtype, leaves[0].device
    template = mass.template if isinstance(mass, TreeMass) else None
    if init_warm is None:
        seed_mass = mass.inner if template is not None else mass
        dim = sum(leaf[0].numel() for leaf in leaves)
        wf0, metric0 = init_metric_seed(seed_mass, dim, dtype, dense, device, (num_chains,))
        init_warm = (wf0, metric0, torch.zeros(num_chains, dtype=torch.int32, device=device))

    def one_chain(z, state, step_size, metric):
        if dense:
            cur = DenseMass(inv_mass=metric[0], chol_mass=metric[1])
        elif template is not None:
            cur = diag_tree_mass_view(metric, template)
        else:
            cur = DiagMass(inv_diag=metric)
        return hmc_transition(vg, cur, steps)(z, state, step_size)

    batched = torch.func.vmap(one_chain)

    def make_transition(metric):
        return lambda z, state, step_size: batched(z, state, step_size, metric)

    return run_mcmc(key, init_state, None, config, init_da=init_da, start_iter=start_iter,
                    make_transition=make_transition, init_warm=init_warm,
                    collect_flags=collect_flags, end_flags=end_flags, _noise=_noise)


def _mass_for(theta0, template, inv_mass, config):
    """The validated mass operator of a flat ``theta0`` or a tree ``template``."""
    if template is not None:
        _reject_tree_adapt_mass(config)
        mass = make_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]), template)
        validate_adapt_mass(config.adapt_mass, mass.inner)
    else:
        mass = make_mass(_as_like(inv_mass, theta0), theta0.shape[-1])
        validate_adapt_mass(config.adapt_mass, mass)
    return mass


def run_hmc(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: MCMCConfig,
    inv_mass=None,
    pass_grad=None,
    _noise=None,
) -> MCMCResult:
    """Sample a single HMC chain.

    ``theta0`` is a flat (D,) tensor or a parameter tree (dicts, lists and
    tuples of tensors); with a tree the state and the ``samples`` keep its
    structure, with a leading draws axis on each leaf.  ``inv_mass`` may
    then be a matching tree of per-leaf diagonals.  ``config.adapt_mass``
    with ``burn > 0`` runs Stan's windowed mass warmup (diagonal on trees,
    diagonal or dense on flat states); ``final_warm`` then holds its carry.
    ``key`` is an integer seed.  ``_noise = (z (S, D), log_u (S,))``
    replaces the drawn noise (a test hook).
    """
    lp, stacked, mass = _one_chain(log_prob_fn, theta0, config, inv_mass, pass_grad)
    if _noise is not None:
        _noise = (_noise[0][:, None], _noise[1][:, None])
    return _first_chain(_run_hmc_batched(key, stacked, lp, config, mass, _noise=_noise))


def _one_chain(log_prob_fn, theta0, config, inv_mass, pass_grad):
    """(potential, theta0 with a chain axis of 1, mass) of a single-chain entry."""
    lp = resolve_potential(log_prob_fn, pass_grad)
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, 1, stacked=False)
    else:
        template, stacked = None, theta0[None]
    return lp, stacked, _mass_for(theta0, template, inv_mass, config)


def _first_chain(res: MCMCResult) -> MCMCResult:
    """``res`` of a one-chain batch without its chain axis."""

    def first(t):
        return t[0]

    return MCMCResult(
        samples=tree_map(first, res.samples),
        stats=type(res.stats)(*(s[0] for s in res.stats)),
        final_step_size=res.final_step_size[0],
        acc_rate=res.acc_rate[0],
        final_state=ChainState(*(tree_map(first, f) for f in res.final_state)),
        final_da=type(res.final_da)(
            **{k: v[0] for k, v in vars(res.final_da).items()}
        ),
        final_warm=tree_map(first, res.final_warm),
    )


def run_hmc_host_offload(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: MCMCConfig,
    inv_mass=None,
    pass_grad=None,
    chunk_size: int = 256,
) -> MCMCResult:
    """HMC whose trace streams to host memory chunk by chunk.

    The reference's ``store_on_GPU=False`` moves each sample to the CPU per
    draw (reference: hamiltorch/samplers.py:956-959,1008-1012).  Here the
    chain runs ``chunk_size`` draws at a time and each chunk's trace moves
    to the host (``samplers/offload.py``), so the card holds O(chunk) draws.
    Each chunk continues the last one's state, adaptation and, with
    ``adapt_mass``, its windowed-warmup carry with its slice of the global
    schedule; the draws' noise is keyed on the global draw index.  So the
    trace is ``run_hmc``'s, bit for bit, at any chunking.

    Returns an MCMCResult whose ``samples`` and ``stats`` are CPU tensors.
    """
    lp, stacked, mass = _one_chain(log_prob_fn, theta0, config, inv_mass, pass_grad)
    dtype = tree_leaves(stacked)[0].dtype
    windowed = bool(config.adapt_mass) and config.burn > 0

    def run_chunk(cfg, n_done, carry):
        state, da, warm = carry
        cf = ef = None
        if windowed:
            # each chunk takes its slice of the global warmup schedule
            cf, ef = schedule_flags(config.burn, n_done, cfg.num_samples)
        res = _run_hmc_batched(key, stacked, lp, cfg, mass, init_state=state, init_da=da,
                               start_iter=n_done, init_warm=warm, collect_flags=cf,
                               end_flags=ef)
        return _first_chain(res), (res.final_state, res.final_da, res.final_warm)

    return host_offload_loop(run_chunk, config, (None, None, None), dtype, chunk_size)


def run_hmc_chains(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: MCMCConfig,
    num_chains: int,
    inv_mass=None,
    pass_grad=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
) -> MCMCResult:
    """Independent chains batched on a leading axis.

    ``theta0`` may be (D,) (copied to every chain) or (num_chains, D), or a
    parameter tree, single-chain (copied) or with a leading ``num_chains``
    axis on every leaf; ``theta0_is_stacked`` overrides the detection.
    Results carry the chain axis first: ``samples`` is (C, N, D) or a tree
    of (C, N, ...) leaves, stats and ``acc_rate`` are per chain.  ``key`` is
    an integer seed; chain ``c`` draws from its own stream.  With
    ``config.adapt_mass`` each chain runs its own windowed warmup (per-chain
    Welford moments and metric).  ``_noise = (z (S, C, D), log_u (S, C))``
    replaces the drawn noise (a test hook).  The recorder
    (``utils/profiling.py``) holds a span ``run_hmc_chains`` a call.
    """
    with profiling.annotate("run_hmc_chains"):
        lp = resolve_potential(log_prob_fn, pass_grad)
        theta0 = place_start(theta0)
        if is_param_tree(theta0):
            template, theta0 = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        else:
            template = None
            if theta0.ndim == 1:
                theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
        mass = _mass_for(theta0, template, inv_mass, config)
        return _run_hmc_batched(key, theta0, lp, config, mass, _noise=_noise)
