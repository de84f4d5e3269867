"""Convergence diagnostics: effective sample size, split-R-hat, summaries.

Counterpart of ``hamiltorch_tpu/diagnostics.py``: ESS from FFT
autocovariances with Geyer's initial monotone sequence, split-R-hat, the
rank-normalised R-hat and bulk / tail ESS of Vehtari et al. (2021), the
MCSE of the mean, E-BFMI, summaries, and an export in ArviZ's layout.

Every statistic is computed in float64 and returned as a float64 tensor on
the trace's device: the sums run over draws x chains, where the JAX code
sums in float32.  Medians and quantiles interpolate linearly between order
statistics, as ``jnp.median`` / ``jnp.quantile`` do, and tied values get
their average rank, as in the JAX code.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .utils.pytree import tree_leaves, tree_map, unravel_last_axis_fn


def as_flat_samples(samples, like=None) -> torch.Tensor:
    """A trace as a (C, N, D) or (N, D) matrix.

    Tensors pass through.  A parameter-tree trace (leaves (N, *shape) or
    (C, N, *shape), as the tree-state runners return) flattens each leaf's
    parameter dims and concatenates the leaves in leaf order.  ``like``
    (the theta0 tree, or any tree of that structure) pins how many leading
    axes are chain and draw axes; without it a trace whose leaves all share
    their first two dims is ambiguous and raises.  Floating traces below
    32 bits come back as float32.
    """

    def f32_floor(x):
        x = torch.as_tensor(x)
        if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
            return x.float()
        return x

    if hasattr(samples, "ndim"):
        return f32_floor(samples)
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(samples)]
    if like is not None:
        extra = leaves[0].ndim - torch.as_tensor(tree_leaves(like)[0]).ndim
        if extra not in (1, 2):
            raise ValueError(
                f"trace leaves have {extra} extra leading dims vs the "
                "template; expected 1 (draws) or 2 (chains, draws)"
            )
    else:
        lead2 = leaves[0].shape[:2]
        if all(leaf.ndim >= 2 and leaf.shape[:2] == lead2 for leaf in leaves):
            raise ValueError(
                "ambiguous pytree trace (every leaf shares its first two "
                "dims, so both (N, ...) and (chains, N, ...) readings "
                "fit): pass like=theta0 to pin the chain/draw axes"
            )
        extra = 1
    mats = [leaf.reshape(tuple(leaf.shape[:extra]) + (-1,)) for leaf in leaves]
    return f32_floor(torch.cat(mats, dim=-1))


def _chains(samples, like=None) -> torch.Tensor:
    """(C, N, D) float64 from any accepted trace form."""
    x = as_flat_samples(samples, like=like).double()
    return x[None] if x.ndim == 2 else x


def _autocovariance(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Biased autocovariance along ``dim`` by FFT, lags 0..N-1."""
    n = x.shape[dim]
    xc = x - x.mean(dim=dim, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=dim)  # zero-padded: no circular wrap
    acov = torch.fft.irfft(f * f.conj(), n=2 * n, dim=dim)
    return acov.narrow(dim, 0, n) / n


def effective_sample_size(samples, like=None) -> torch.Tensor:
    """ESS per dimension of a (C, N, D) or (N, D) trace: the multi-chain
    estimator (within-chain autocovariances with the between-chain
    variance) and Geyer's initial positive, monotone sequence."""
    x = _chains(samples, like)
    c, n, d = x.shape
    acov = _autocovariance(x, dim=1)  # (C, N, D)
    w = torch.mean(acov[:, 0, :] * n / (n - 1.0), dim=0)  # mean unbiased within-chain variance
    mean_acov = torch.mean(acov, dim=0)  # (N, D)
    var_plus = w * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(torch.mean(x, dim=1), dim=0, unbiased=True)
    rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]
    # Geyer: sum consecutive pairs; keep while positive, enforce monotone
    n_pairs = n // 2
    pairs = rho[:2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    keep = torch.cumprod((pairs > 0.0).to(torch.int64), dim=0).bool()
    inf = torch.full_like(pairs, math.inf)
    mono = torch.cummin(torch.where(keep, pairs, inf), dim=0).values
    mono = torch.where(keep, torch.minimum(pairs, mono), torch.zeros_like(pairs))
    tau = -1.0 + 2.0 * torch.sum(mono, dim=0)  # pair 0 holds rho_0 + rho_1
    tau = torch.clamp(tau, min=1.0 / math.log10(n + 1.0))
    return (c * n) / tau


def potential_scale_reduction(samples, like=None) -> torch.Tensor:
    """Split-R-hat per dimension of a (C, N, D) or (N, D) trace."""
    x = _chains(samples, like)
    half = x.shape[1] // 2
    split = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)  # (2C, half, D)
    n2 = split.shape[1]
    w = torch.mean(torch.var(split, dim=1, unbiased=True), dim=0)
    b = n2 * torch.var(torch.mean(split, dim=1), dim=0, unbiased=True)
    var_plus = (n2 - 1.0) / n2 * w + b / n2
    return torch.sqrt(var_plus / w)


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column quantile of (S, D), linear between order statistics."""
    xs = torch.sort(flat, dim=0).values
    pos = q * (flat.shape[0] - 1)
    lo, frac = int(math.floor(pos)), pos - math.floor(pos)
    hi = min(lo + 1, flat.shape[0] - 1)
    return xs[lo] + frac * (xs[hi] - xs[lo])


def _rank_normalize(samples: torch.Tensor) -> torch.Tensor:
    """Average ranks (ties share their mean rank), pooled over chains and
    draws per dimension, to normal scores through the inverse normal CDF
    with Blom's offset: z = Phi^-1((r - 3/8) / (S + 1/4))."""
    c, n, d = samples.shape
    cols = samples.reshape(c * n, d).T.contiguous()  # (D, S)
    s = cols.shape[1]
    xs = torch.sort(cols, dim=1).values
    lo = torch.searchsorted(xs, cols, side="left")
    hi = torch.searchsorted(xs, cols, side="right")
    r = 0.5 * (lo + hi + 1.0)  # average rank, 1-based
    z = torch.special.ndtri((r - 0.375) / (s + 0.25))
    return z.T.reshape(c, n, d).to(samples.dtype)


def rank_normalized_rhat(samples, z_bulk=None, like=None) -> torch.Tensor:
    """Rank-normalised split-R-hat (Vehtari et al. 2021) per dimension: the
    larger of the split-R-hat of the rank-normal scores and of the folded
    scores |x - median|.  ``z_bulk``: ``_rank_normalize`` of the trace, if
    already computed."""
    x = _chains(samples, like)
    if z_bulk is None:
        z_bulk = _rank_normalize(x)
    median = _quantile(x.reshape(-1, x.shape[-1]), 0.5)
    z_fold = _rank_normalize(torch.abs(x - median))
    return torch.maximum(potential_scale_reduction(z_bulk), potential_scale_reduction(z_fold))


def bulk_ess(samples, z_bulk=None, like=None) -> torch.Tensor:
    """Rank-normalised ESS: mixing in the bulk of the distribution."""
    x = _chains(samples, like)
    return effective_sample_size(_rank_normalize(x) if z_bulk is None else z_bulk)


def tail_ess(samples, prob: float = 0.05, like=None) -> torch.Tensor:
    """Tail ESS: the smaller ESS of the indicators of the ``prob`` and
    ``1 - prob`` quantiles' exceedance (Vehtari et al. 2021 §4.3)."""
    x = _chains(samples, like)
    flat = x.reshape(-1, x.shape[-1])

    def ess_of_indicator(q):
        return effective_sample_size((x <= _quantile(flat, q)).to(x.dtype))

    return torch.minimum(ess_of_indicator(prob), ess_of_indicator(1.0 - prob))


def mcse_mean(samples, ess=None, like=None) -> torch.Tensor:
    """Monte Carlo standard error of the posterior mean: sd / sqrt(ESS)."""
    x = _chains(samples, like)
    sd = torch.std(x.reshape(-1, x.shape[-1]), dim=0, unbiased=True)
    return sd / torch.sqrt(effective_sample_size(x) if ess is None else ess)


def e_bfmi(energies) -> torch.Tensor:
    """Energy Bayesian fraction of missing information (Betancourt 2016):
    sum (E_n - E_{n-1})^2 / sum (E_n - mean E)^2 over the trailing draw
    axis of ``energies`` (the trajectory-start Hamiltonian with fresh
    momentum, ``MCMCStats.energy_old``), per chain."""
    e = torch.as_tensor(energies).double()
    num = torch.sum(torch.diff(e, dim=-1) ** 2, dim=-1)
    return num / torch.sum((e - e.mean(dim=-1, keepdim=True)) ** 2, dim=-1)


def summary(samples, energies=None, like=None) -> Dict[str, torch.Tensor]:
    """Per-dimension summary: mean, std, ESS (raw, bulk, tail), split-R-hat
    (classic and rank-normalised), MCSE of the mean; with the per-draw
    energies (draw axis last) also per-chain ``e_bfmi``.  ``samples`` may be
    a tree trace (``like=theta0`` pins its chain and draw axes)."""
    x = _chains(samples, like)
    flat = x.reshape(-1, x.shape[-1])
    ess = effective_sample_size(x)
    z_bulk = _rank_normalize(x)
    out = {
        "mean": flat.mean(dim=0),
        "std": flat.std(dim=0, unbiased=False),
        "ess": ess,
        "ess_bulk": bulk_ess(x, z_bulk=z_bulk),
        "ess_tail": tail_ess(x),
        "r_hat": potential_scale_reduction(x),
        "r_hat_rank": rank_normalized_rhat(x, z_bulk=z_bulk),
        "mcse_mean": mcse_mean(x, ess=ess),
    }
    if energies is not None:
        out["e_bfmi"] = e_bfmi(energies)
    return out


def summary_by_leaf(samples, like, energies=None) -> Dict[str, object]:
    """``summary`` with each per-dimension statistic split back into the
    parameter tree ``like`` (leaves of the parameters' shapes)."""
    flat = summary(samples, energies=energies, like=like)
    split = unravel_last_axis_fn(like)
    return {k: (v if k == "e_bfmi" else split(v)) for k, v in flat.items()}


# ---- ArviZ export ----


def _leaf_names(tree, prefix=()):
    """(dotted name, leaf) pairs in leaf order: dict keys, sequence indices
    and named-tuple fields joined by dots, as the JAX export names them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(".".join(prefix) or "theta", tree)]
    return [pair for k, v in items for pair in _leaf_names(v, prefix + (k,))]


def _np(x) -> np.ndarray:
    """``x`` on the host as numpy; a bfloat16 tensor (a ``trace_dtype``
    trace) as its float32 values, exactly: numpy has no bfloat16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _posterior_vars(samples, chains_first: bool) -> Dict[str, np.ndarray]:
    """{var_name: (C, N, *shape) array} from a tensor or tree trace; a
    single-chain trace gains a chain axis of 1."""
    if hasattr(samples, "ndim"):
        arr = _np(samples)
        return {"theta": arr if chains_first else arr[None]}
    return {name: _np(leaf) if chains_first else _np(leaf)[None]
            for name, leaf in _leaf_names(samples)}


def to_inference_dict(result, like=None, info=None) -> Dict[str, Dict]:
    """``{"posterior": ..., "sample_stats": ...}`` in ArviZ's ``from_dict``
    layout (every array (chain, draw, *shape), numpy on the host) from a
    sampler result of a family the port has:

    - ``MCMCResult`` (``run_hmc*``, ``run_rmhmc*``, ``run_split_hmc*``): acceptance rate,
      divergences, the trajectory-start energy (the E-BFMI series) and
      step size;
    - ``(MCMCResult, NUTSInfo)`` (``run_nuts*``, or ``info=``): the same
      from the ``NUTSInfo``, with ``tree_depth`` and ``n_steps`` (leapfrogs)
      besides; a 2-d info is read chains first, as the JAX package reads it
      (so the ensemble's time-major info comes back (draw, chain));
    - ``MCLMCResult`` (``run_mclmc*``): no acceptance series; the per-draw
      energy change and the tuned per-chain step size and trajectory
      length broadcast over draws;
    - ``MAMSResult`` (``run_mams*``): acceptance, divergences, energy
      change and step size;
    - ``ChEESResult`` (``run_chees``): acceptance and divergences from the
      draw-major (N, C) info, transposed; the step size and trajectory
      length, shared by the chains, broadcast to (C, N);
    - ``SGMCMCResult`` / ``CSGMCMCResult`` (``run_sgld*``, ``run_sghmc*``,
      ``run_csgmcmc*``): divergences, step size and gradient-estimate norm,
      and for the cyclical samplers each snapshot's cycle;
    - ``PTResult`` (``run_parallel_tempering``, ``run_pt_chains``): the
      cold chain and its acceptance, chains first for ensembles;
    - ``TIResult`` (``run_ti``): the beta=1 rung as one chain, its
      acceptance and the last pair's swap outcomes;
    - ``SMCResult`` (``run_smc``): the final particles as one chain of N
      draws, with their normalised log-weights;
    - ``StretchResult`` (``run_stretch``): the walkers as chains, the
      ensemble's acceptance fraction and divergence flag broadcast to every
      walker;
    - ``EllipticalResult`` (``run_elliptical*``): shrink counts, the kept
      state's log-likelihood and divergences (no acceptance series);
    - ``BarkerResult`` (``run_barker*``): acceptance, divergences and step
      size.

    An ``SVGDResult`` is refused with a ``TypeError``: its particles are a
    variational approximation with no chain, draw or sampler statistics, and
    the JAX function has no branch for it either.  ``like`` is accepted for
    symmetry with ``summary``: the stats' shapes give the chain and draw
    axes.
    """
    del like

    def cn(x, chains_first):
        arr = _np(x)
        return arr if chains_first else arr[None]

    if hasattr(result, "log_weights"):  # SMCResult (weighted particles)
        return {"posterior": _posterior_vars(result.particles, chains_first=False),
                "sample_stats": {"log_weight": cn(result.log_weights, False)}}
    # run_nuts / run_nuts_chains / run_nuts_ensemble return (result, info)
    if not hasattr(result, "samples") and isinstance(result, tuple) and len(result) == 2:
        result, info = result
    if hasattr(result, "phi_norm_trace"):  # SVGDResult
        raise TypeError(
            "to_inference_dict: an SVGDResult holds SVGD's particles, a "
            "variational approximation with no chains, draws or sampler "
            "statistics; summarise result.particles directly"
        )
    if not hasattr(result, "samples"):
        raise NotImplementedError(
            "to_inference_dict takes the samplers' results (MCMCResult, with a "
            "NUTSInfo for NUTS, MCLMCResult, MAMSResult, ChEESResult, "
            "SGMCMCResult, CSGMCMCResult, PTResult, TIResult, SMCResult, "
            "StretchResult, EllipticalResult, BarkerResult)"
        )
    if hasattr(result, "loglik_draws"):  # TIResult
        acc = _np(result.info.accept_prob)
        # the kept samples are the beta=1 (last) rung's
        return {"posterior": _posterior_vars(result.samples, chains_first=False),
                "sample_stats": {"acceptance_rate": acc[None, :, -1],
                                 "swap_accepted": _np(result.info.swap_accept)[None, :, -1]}}
    if hasattr(result, "replica_samples"):  # PTResult
        acc = _np(result.info.accept_prob)
        ensemble = acc.ndim == 3  # (E, N, K) from run_pt_chains
        post = _posterior_vars(result.samples, chains_first=ensemble)
        n_kept = next(iter(post.values())).shape[1]
        return {"posterior": post, "sample_stats": {
            "acceptance_rate": cn(acc[..., -n_kept:, 0], ensemble)}}
    if hasattr(result, "final_trajectory_length"):  # ChEESResult
        info = result.info
        post = _posterior_vars(result.samples, chains_first=True)
        c, n = next(iter(post.values())).shape[:2]
        # ChEESInfo is draw-major (N, C); the shared scalars broadcast to (C, N)
        return {"posterior": post, "sample_stats": {
            "acceptance_rate": _np(info.accept_prob).T,
            "diverging": _np(info.divergent).T,
            "step_size": np.broadcast_to(_np(info.step_size), (c, n)),
            "trajectory_length": np.broadcast_to(_np(info.trajectory_length), (c, n)),
        }}
    if info is not None:  # NUTS
        chains_first = info.accept_prob.ndim == 2
        return {"posterior": _posterior_vars(result.samples, chains_first), "sample_stats": {
            "acceptance_rate": cn(info.accept_prob, chains_first),
            "diverging": cn(info.divergent, chains_first),
            "energy": cn(info.energy, chains_first),
            "step_size": cn(info.step_size, chains_first),
            "tree_depth": cn(info.tree_depth, chains_first),
            "n_steps": cn(info.num_leapfrogs, chains_first),
        }}
    s = result.stats
    if hasattr(result, "final_u"):  # MCLMCResult
        chains_first = s.energy_change.ndim == 2
        post = _posterior_vars(result.samples, chains_first)
        shape = cn(s.energy_change, chains_first).shape
        return {"posterior": post, "sample_stats": {
            "diverging": cn(s.divergent, chains_first),
            "energy_change": cn(s.energy_change, chains_first),
            "step_size": np.broadcast_to(_np(result.step_size).reshape(-1, 1), shape),
            "trajectory_length": np.broadcast_to(
                _np(result.trajectory_length).reshape(-1, 1), shape),
        }}
    # the JAX package's order of checks: a BarkerResult carries final_da and
    # final_theta too, so it is tested before MAMS
    if hasattr(result, "final_walkers"):  # StretchResult: walkers export as chains
        samples = tree_map(lambda leaf: torch.movedim(torch.as_tensor(leaf), 0, 1),
                           result.samples)
        post = _posterior_vars(samples, True)
        k_walk, n_kept = next(iter(post.values())).shape[:2]
        # the accept fraction is ensemble-wide a kept iteration
        return {"posterior": post, "sample_stats": {
            "acceptance_rate": np.broadcast_to(_np(s.accept_frac)[None, :], (k_walk, n_kept)),
            "diverging": np.broadcast_to(_np(s.divergent)[None, :], (k_walk, n_kept)),
        }}
    if hasattr(result, "final_loglik"):  # EllipticalResult: no acceptance series
        chains_first = s.shrinks.ndim == 2
        return {"posterior": _posterior_vars(result.samples, chains_first), "sample_stats": {
            "diverging": cn(s.divergent, chains_first),
            "n_shrinks": cn(s.shrinks, chains_first),
            "loglik": cn(s.loglik, chains_first),
        }}
    if hasattr(result, "final_welford"):  # BarkerResult: acceptance, no energies
        chains_first = s.accept_prob.ndim == 2
        return {"posterior": _posterior_vars(result.samples, chains_first), "sample_stats": {
            "acceptance_rate": cn(s.accept_prob, chains_first),
            "diverging": cn(s.divergent, chains_first),
            "step_size": cn(s.step_size, chains_first),
        }}
    if hasattr(result, "final_da") and hasattr(result, "final_theta"):  # MAMSResult
        chains_first = s.accept_prob.ndim == 2
        return {"posterior": _posterior_vars(result.samples, chains_first), "sample_stats": {
            "acceptance_rate": cn(s.accept_prob, chains_first),
            "diverging": cn(s.divergent, chains_first),
            "energy_change": cn(s.energy_change, chains_first),
            "step_size": cn(s.step_size, chains_first),
        }}
    if hasattr(result, "final_theta"):  # SGMCMCResult / CSGMCMCResult
        chains_first = s.step_size.ndim == 2
        stats = {
            "diverging": cn(s.divergent, chains_first),
            "step_size": cn(s.step_size, chains_first),
            "grad_norm": cn(s.grad_norm, chains_first),
        }
        if hasattr(result, "cycle"):  # cyclical: each snapshot's cycle
            stats["cycle"] = cn(result.cycle, chains_first)
        return {"posterior": _posterior_vars(result.samples, chains_first),
                "sample_stats": stats}
    if hasattr(result, "final_state"):  # MCMCResult
        chains_first = s.accept_prob.ndim == 2
        return {"posterior": _posterior_vars(result.samples, chains_first), "sample_stats": {
            "acceptance_rate": cn(s.accept_prob, chains_first),
            "diverging": cn(s.divergent, chains_first),
            "energy": cn(s.energy_old, chains_first),
            "step_size": cn(s.step_size, chains_first),
        }}
    raise NotImplementedError(
        f"to_inference_dict: {type(result).__name__} is not a sampler's result"
    )


def to_arviz(result, like=None, info=None):
    """ArviZ ``InferenceData`` (posterior and sample_stats) of a result; see
    :func:`to_inference_dict`.  Needs the optional ``arviz`` package."""
    try:
        import arviz
    except ImportError as e:
        raise ImportError(
            "to_arviz requires the optional dependency arviz "
            "(pip install arviz); to_inference_dict gives the same "
            "layout as plain dicts without it"
        ) from e
    return arviz.from_dict(**to_inference_dict(result, like=like, info=info))
