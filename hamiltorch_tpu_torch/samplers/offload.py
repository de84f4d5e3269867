"""Chunked host offload of sample traces (``store_on_GPU=False``).

Counterpart of ``hamiltorch_tpu/samplers/offload.py::host_offload_loop``.
The reference moves every sample to the CPU as it is drawn (reference:
hamiltorch/samplers.py:956-959,1008-1012).  Here the sampler runs in chunks
and each chunk's trace moves to the host (``.cpu()``) before the next chunk
runs, so the card holds O(chunk) draws, never the whole (draws x D) trace.
Each draw's noise is keyed on (seed, chain, global draw index), so the
chunked stream is the unchunked one.

The NUTS, RMHMC and splitting offload runners of the JAX module come with
their samplers (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.pytree import tree_map
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
