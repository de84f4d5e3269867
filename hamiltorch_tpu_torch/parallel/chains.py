"""Independent chains over a thread pool.

Counterpart of ``hamiltorch_tpu/parallel/chains.py``, after the reference's
``setup_chain`` / ``multi_chain`` (reference: hamiltorch/util.py:385-404),
which run per-chain closures on a ``ThreadPoolExecutor``.  The threads
overlap where PyTorch's kernels release the interpreter lock; many chains
of one model run faster batched on a leading axis (``run_hmc_chains``).
"""

from __future__ import annotations

import inspect
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch


def setup_chain(sampler: Callable, prior: Callable, kwargs: dict) -> Callable:
    """Bind sampler + prior + kwargs into a ``seed -> samples`` closure
    (reference: hamiltorch/util.py:385-390).

    ``seed`` is an integer; two integer keys derived from it seed the prior
    and the sampler.  ``prior`` may take a key (the port's integer seed) or
    no arguments (the reference's style).
    """
    # dispatch on the signature: catching TypeError would swallow errors
    # raised inside a keyed prior and retry it with no arguments
    try:
        takes_key = len(inspect.signature(prior).parameters) >= 1
    except (TypeError, ValueError):  # builtins and partials without signatures
        takes_key = True

    def chain(seed):
        gen = torch.Generator().manual_seed(int(seed))
        k_init, k_run = torch.randint(0, 2**62, (2,), generator=gen).tolist()
        params_init = prior(k_init) if takes_key else prior()
        return sampler(params_init=params_init, key=k_run, **kwargs)

    return chain


def multi_chain(chain: Callable, num_workers: int, seeds: Sequence, parallel: bool = False):
    """Run ``chain`` over ``seeds`` (reference: hamiltorch/util.py:392-404),
    on ``num_workers`` threads when ``parallel``, else one after another.
    Results come back in the order of ``seeds``; a chain's exception is
    raised here."""
    if not parallel:
        return [chain(s) for s in seeds]
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(chain, seeds))
