"""hamiltorch-compatible façade.

Counterpart of ``hamiltorch_tpu/api.py::sample``, with the same signature
and the same return convention: the initial params followed by the chain
state after each draw ``n > burn``, as one (num_kept, D) tensor;
``debug=2`` returns ``(samples, final_step_size)`` under HMC_NUTS and
``(samples, acc_rate)`` otherwise.  ``key`` is an integer seed; without it
the module-level generator set by ``set_random_seed`` supplies one.

Every branch of the JAX package's: ``Sampler.HMC`` / ``Sampler.HMC_NUTS``
with the leapfrog integrator (windowed mass warmup with ``adapt_mass``) or,
given a list of per-term log-probs, a splitting integrator
(``samplers/splitting.py``); ``Sampler.NUTS`` (tree-doubling NUTS,
``samplers/nuts.py``; it adapts the step size when ``burn > 0``); and
``Sampler.RMHMC`` with the IMPLICIT, EXPLICIT, S3 or MIDPOINT integrator
under the HESSIAN, SOFTABS or JACOBIAN_DIAG metric (``samplers/rmhmc.py``).
Each takes progress lines (``progress_every``) and ``store_on_GPU=False``,
which runs the chain in chunks and moves each chunk's trace to the host:
the samples then come back as a CPU tensor, the same numbers as with
``store_on_GPU=True``.  ``params_init`` that is not a tensor goes to the
card (raises without one); a tensor keeps its device.  The validations and
their messages are the JAX package's: a list of log-probs only with a
splitting integrator, ``pass_grad`` refused for RMHMC (and accepted for
splitting as a per-term list), ``adapt_mass`` refused for both.
"""

from __future__ import annotations

from typing import Optional

import torch

from .enums import Integrator, Metric, Sampler
from .samplers.driver import MCMCConfig, MCMCResult
from .samplers.hmc import run_hmc, run_hmc_host_offload
from .samplers.nuts import NUTSConfig, run_nuts
from .samplers.offload import (
    run_nuts_host_offload,
    run_rmhmc_host_offload,
    run_split_hmc_host_offload,
)
from .samplers.rmhmc import run_rmhmc
from .samplers.splitting import grads_from_list, run_split_hmc, terms_from_list
from .utils.convert import place_start
from .utils.rng import next_key

_SPLITTING = (Integrator.SPLITTING, Integrator.SPLITTING_RAND, Integrator.SPLITTING_KMID)


def _kept_samples(params_init: torch.Tensor, result: MCMCResult, burn: int,
                  thin: int = 1) -> torch.Tensor:
    """[init] + states for draws n > burn (reference: samplers.py:1007).

    With ``thin > 1`` kept row ``b`` holds the state after transition
    ``(b+1)*thin - 1``; keep the rows whose transition index exceeds
    ``burn``.
    """
    thin = max(thin, 1)
    keep_from = max(0, -(-(burn + 2) // thin) - 1)  # burn=-1: keep all
    # a host-offloaded trace stays on the host
    params_init = params_init.to(result.samples.device)
    return torch.cat([params_init[None, :], result.samples[keep_from:]], dim=0)


def sample(
    log_prob_func,
    params_init,
    num_samples: int = 10,
    num_steps_per_sample: int = 10,
    step_size: float = 0.1,
    burn: int = 0,
    jitter: Optional[float] = None,
    inv_mass=None,
    normalizing_const: float = 1.0,  # dead in the reference too
    softabs_const: Optional[float] = None,
    explicit_binding_const: float = 100.0,
    fixed_point_threshold: float = 1e-5,
    fixed_point_max_iterations: int = 1000,
    jitter_max_tries: int = 10,  # accepted for signature parity, unused
    sampler: Sampler = Sampler.HMC,
    integrator: Integrator = Integrator.IMPLICIT,
    metric: Metric = Metric.HESSIAN,
    debug: int = 0,
    desired_accept_rate: float = 0.8,
    store_on_GPU: bool = True,
    pass_grad=None,
    verbose: bool = True,
    key: Optional[int] = None,
    adapt_mass: bool = False,
    thin: int = 1,
    progress_every: int = 0,
):
    """Drop-in equivalent of the reference ``hamiltorch.sample``.

    ``params_init`` is a 1-d tensor; the chain runs on its device.  As in
    the reference, the integrator argument is ignored by plain HMC unless
    it names a splitting scheme.
    """
    params_init = place_start(params_init)
    if params_init.ndim != 1:
        raise RuntimeError("params_init must be a 1d array.")
    if not bool(torch.all(torch.isfinite(params_init))):
        raise RuntimeError("params_init contains non-finite values.")
    if burn >= num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    if thin > 1 and burn > 0 and burn % thin:
        raise RuntimeError("burn must be divisible by thin.")
    if adapt_mass and (sampler == Sampler.RMHMC or integrator in _SPLITTING):
        raise RuntimeError(
            "adapt_mass (windowed mass warmup) is available for Sampler.NUTS "
            "and the plain-HMC samplers (or the native run_hmc/run_nuts/"
            "run_chees APIs)."
        )
    # NUTS ignores adapt_mass without a warmup phase, as in the JAX package
    if adapt_mass and sampler in (Sampler.HMC, Sampler.HMC_NUTS) and burn <= 0:
        raise RuntimeError("adapt_mass requires burn > 0 (the warmup phase).")
    if sampler == Sampler.HMC_NUTS and burn == 0:
        raise RuntimeError("burn must be greater than 0 for NUTS.")
    if sampler not in (Sampler.HMC, Sampler.HMC_NUTS, Sampler.NUTS, Sampler.RMHMC):
        raise NotImplementedError(f"sampler={sampler}, integrator={integrator}")
    is_list = isinstance(log_prob_func, (list, tuple))
    if is_list and not (sampler in (Sampler.HMC, Sampler.HMC_NUTS) and integrator in _SPLITTING):
        raise RuntimeError(
            "A list of log_prob functions requires Sampler.HMC with a "
            "SPLITTING integrator (reference: samplers.py:466-467)."
        )
    if key is None:
        key = next_key()
    if not is_list and isinstance(log_prob_func(params_init), (tuple, list)):
        # the reference differentiates element [0] of a tuple return
        # (collect_gradients, samplers.py:54-58)
        orig = log_prob_func

        def log_prob_func(t):
            return orig(t)[0]

    adapt = sampler == Sampler.HMC_NUTS or (sampler == Sampler.NUTS and burn > 0)
    config = MCMCConfig(
        num_samples=num_samples,
        num_steps_per_sample=num_steps_per_sample,
        step_size=step_size,
        burn=burn,
        adapt_step_size=adapt,
        desired_accept_rate=desired_accept_rate,
        thin=thin,
        progress_every=progress_every,
        adapt_mass=adapt_mass,
    )
    # the reference's store_on_GPU=False moves the trace to the host per
    # draw (samplers.py:956-959, 1008-1012); here per chunk
    if sampler == Sampler.NUTS:
        nuts_config = NUTSConfig(
            num_samples=num_samples,
            step_size=step_size,
            burn=max(burn, 0),
            adapt_step_size=burn > 0,
            desired_accept_rate=desired_accept_rate,
            adapt_mass=adapt_mass,
            progress_every=progress_every,
            thin=thin,
        )
        if store_on_GPU:
            result, _ = run_nuts(key, log_prob_func, params_init, nuts_config,
                                 inv_mass=inv_mass, pass_grad=pass_grad)
        else:
            result = run_nuts_host_offload(key, log_prob_func, params_init, nuts_config,
                                           inv_mass=inv_mass, pass_grad=pass_grad)
    elif sampler == Sampler.RMHMC:
        if pass_grad is not None:
            # reference parity (samplers.py:309-310,389-390): a user-supplied
            # d logp/d theta cannot stand in for the Riemannian Hamiltonian's
            # gradient, which includes metric-derivative terms
            raise RuntimeError("Passing user-determined gradients not implemented for RMHMC")
        rm_kwargs = dict(
            integrator=integrator, metric=metric, jitter=jitter,
            softabs_const=softabs_const, explicit_binding_const=explicit_binding_const,
            fixed_point_threshold=fixed_point_threshold,
            fixed_point_max_iterations=fixed_point_max_iterations,
        )
        if store_on_GPU:
            result = run_rmhmc(key, log_prob_func, params_init, config, **rm_kwargs)
        else:
            result = run_rmhmc_host_offload(key, log_prob_func, params_init, config,
                                            **rm_kwargs)
    elif integrator in _SPLITTING:
        if not is_list:
            raise RuntimeError("For splitting log_prob_func must be list of functions")
        if pass_grad is not None and (not isinstance(pass_grad, (list, tuple))
                                      or len(pass_grad) != len(log_prob_func)):
            # the reference refuses pass_grad for splitting outright
            # (samplers.py:468-469); the JAX package accepts PER-TERM
            # gradients, the only well-defined form
            raise RuntimeError(
                "Passing user-determined gradients for splitting requires a "
                "list of per-term gradient callables (one per log_prob term)."
            )
        if store_on_GPU:
            result = run_split_hmc(key, list(log_prob_func), params_init, config,
                                   integrator=integrator, inv_mass=inv_mass,
                                   pass_grad=None if pass_grad is None else list(pass_grad))
        else:
            result = run_split_hmc_host_offload(
                key, terms_from_list(log_prob_func), len(log_prob_func), params_init, config,
                integrator=integrator, inv_mass=inv_mass,
                pass_grad=None if pass_grad is None else grads_from_list(pass_grad))
    else:
        runner = run_hmc if store_on_GPU else run_hmc_host_offload
        result = runner(key, log_prob_func, params_init, config,
                        inv_mass=inv_mass, pass_grad=pass_grad)

    samples = _kept_samples(params_init, result, burn, thin=thin)
    if debug == 1:
        h0s = result.stats.energy_old.tolist()
        h1s = result.stats.energy_new.tolist()
        accs = result.stats.accepted.tolist()
        for i, (h0, h1, acc) in enumerate(zip(h0s, h1s, accs)):
            print(
                f"Step: {i}, Current Hamiltonian: {h0:.4f}, "
                f"Proposed Hamiltonian: {h1:.4f}, "
                f"{'accepted' if acc else 'rejected'}"
            )
    if verbose:
        print(f"Acceptance Rate {float(result.acc_rate):.2f}")

    if adapt and debug == 2:
        return samples, float(result.final_step_size)
    if debug == 2:
        return samples, float(result.acc_rate)
    return samples
