"""Chunked host offload of sample traces (``store_on_GPU=False``).

Counterpart of ``hamiltorch_tpu/samplers/offload.py::host_offload_loop``.
The reference moves every sample to the CPU as it is drawn (reference:
hamiltorch/samplers.py:956-959,1008-1012).  Here the sampler runs in chunks
and each chunk's trace moves to the host (``.cpu()``) before the next chunk
runs, so the card holds O(chunk) draws, never the whole (draws x D) trace.
Each draw's noise is keyed on (seed, chain, global draw index), so the
chunked stream is the unchunked one.

``run_nuts_host_offload``, ``run_rmhmc_host_offload`` and
``run_split_hmc_host_offload`` are here; ``samplers/hmc.py`` holds HMC's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.pytree import tree_leaves, tree_map
from .driver import MCMCResult, MCMCStats


def host_offload_loop(
    run_chunk: Callable,
    config,
    carry,
    dtype,
    chunk_size: int = 256,
) -> MCMCResult:
    """Generic chunked offload driver.

    ``run_chunk(cfg, n_done, carry) -> (MCMCResult, new_carry)`` runs one
    chunk of ``cfg.num_samples`` draws continuing from ``carry`` at global
    draw offset ``n_done``.  Each chunk's samples and stats move to the
    host before the next chunk runs; the returned ``samples`` and ``stats``
    are CPU tensors (the final state and adaptation stay on the device).
    """
    thin = max(getattr(config, "thin", 1), 1)
    chunk_size = max(thin, (chunk_size // thin) * thin)
    host_samples, host_stats, chunk_accs = [], [], []
    n_done = 0
    result = None
    while n_done < config.num_samples:
        this_chunk = min(chunk_size, config.num_samples - n_done)
        cfg = dataclasses.replace(config, num_samples=this_chunk)
        result, carry = run_chunk(cfg, n_done, carry)
        host_samples.append(tree_map(lambda t: t.cpu(), result.samples))
        host_stats.append(MCMCStats(*(s.cpu() for s in result.stats)))
        chunk_accs.append((float(result.acc_rate), this_chunk))
        n_done += this_chunk

    samples = tree_map(lambda *xs: torch.cat(xs), *host_samples)
    stats = MCMCStats(*(torch.cat(parts) for parts in zip(*host_stats)))
    # transition-weighted mean of the chunks' rates (with thin > 1 the
    # stacked stats hold only each window's last transition)
    acc_rate = sum(a * n for a, n in chunk_accs) / max(config.num_samples, 1)
    return MCMCResult(
        samples=samples,
        stats=stats,
        final_step_size=result.final_step_size,
        acc_rate=torch.tensor(acc_rate, dtype=dtype),
        final_state=result.final_state,
        final_da=result.final_da,
        final_warm=result.final_warm,
    )


def run_nuts_host_offload(
    key: int,
    log_prob_fn,
    theta0,
    config,  # NUTSConfig
    inv_mass=None,
    pass_grad=None,
    chunk_size: int = 256,
) -> MCMCResult:
    """Tree-doubling NUTS whose trace streams to host memory chunk by chunk
    (the reference's ``store_on_GPU=False``, samplers.py:956-959).

    Each chunk continues the last one's state, dual averaging and
    ``(welford, metric, da_t)`` warmup carry, with its slice of the global
    window schedule, and draws its noise keyed on the global draw index: the
    trace is ``run_nuts``'s bit for bit at any chunking.  Returns an
    MCMCResult whose ``samples`` and ``stats`` are CPU tensors.
    """
    from ..ops.potential import resolve_potential
    from .hmc import _first_chain
    from .nuts import _prepare_one, _run_nuts_batched
    from .warmup import schedule_flags

    lp = resolve_potential(log_prob_fn, pass_grad)
    stacked, mass = _prepare_one(theta0, config, inv_mass)
    windowed = bool(config.adapt_mass) and config.burn > 0

    def run_chunk(cfg, n_done, carry):
        state, da, warm = carry
        collect, end = schedule_flags(config.burn if windowed else 0, n_done, cfg.num_samples)
        res, _ = _run_nuts_batched(key, stacked, lp, cfg, mass, init_state=state, init_da=da,
                                   start_iter=n_done, init_warm=warm, collect_flags=collect,
                                   end_flags=end)
        return _first_chain(res), (res.final_state, res.final_da, res.final_warm)

    dtype = tree_leaves(stacked)[0].dtype
    return host_offload_loop(run_chunk, config, (None, None, None), dtype, chunk_size)


def run_rmhmc_host_offload(
    key: int,
    log_prob_fn,
    theta0,
    config,  # MCMCConfig
    chunk_size: int = 64,
    **rmhmc_kwargs,
) -> MCMCResult:
    """RMHMC whose trace streams to host memory chunk by chunk (the
    reference's ``store_on_GPU=False`` for RMHMC, samplers.py:1008-1012).
    ``rmhmc_kwargs`` as ``run_rmhmc`` (integrator, metric, jitter, ...);
    ``theta0`` is flat.  Chunks are smaller than HMC's: an RMHMC draw costs
    far more.  The trace is ``run_rmhmc``'s bit for bit at any chunking."""
    from ..ops.potential import resolve_potential
    from ..utils.convert import place_start
    from .hmc import _first_chain
    from .rmhmc import _run_rmhmc_batched, resolve_rmhmc_options

    stacked = place_start(theta0)[None]
    lp = resolve_potential(log_prob_fn)
    integrator, opts, ham_func, custom_metric = resolve_rmhmc_options(rmhmc_kwargs)

    def run_chunk(cfg, n_done, carry):
        state, da = carry
        res = _run_rmhmc_batched(key, stacked, lp, cfg, integrator, opts, ham_func,
                                 custom_metric, init_state=state, init_da=da,
                                 start_iter=n_done)
        return _first_chain(res), (res.final_state, res.final_da)

    return host_offload_loop(run_chunk, config, (None, None), stacked.dtype, chunk_size)


def run_split_hmc_host_offload(
    key: int,
    term_fn,
    num_terms: int,
    theta0,
    config,  # MCMCConfig
    integrator=None,
    inv_mass=None,
    data=None,
    pass_grad=None,
    chunk_size: int = 256,
) -> MCMCResult:
    """Split HMC whose trace streams to host memory chunk by chunk (the
    reference's ``store_on_GPU=False`` offload inside its splitting
    branches, samplers.py:542-547).  Contract as ``run_split_hmc_stacked``;
    ``theta0`` may be a parameter tree.  The trace is
    ``run_split_hmc_stacked``'s bit for bit at any chunking."""
    from ..enums import Integrator
    from .hmc import _first_chain
    from .splitting import _prepare_one, _run_split_batched

    integrator = Integrator.SPLITTING if integrator is None else integrator
    stacked, mass = _prepare_one(theta0, inv_mass)

    def run_chunk(cfg, n_done, carry):
        state, da = carry
        res = _run_split_batched(key, stacked, term_fn, num_terms, cfg, integrator, mass, data,
                                 pass_grad=pass_grad, init_state=state, init_da=da,
                                 start_iter=n_done)
        return _first_chain(res), (res.final_state, res.final_da)

    dtype = tree_leaves(stacked)[0].dtype
    return host_offload_loop(run_chunk, config, (None, None), dtype, chunk_size)
