"""Predictive model comparison: WAIC, PSIS-LOO and compare().

Counterpart of ``hamiltorch_tpu/model_comparison.py`` (no counterpart in
the reference, whose ``predict_model`` offers nothing to choose between
models):

* :func:`waic`: the widely applicable information criterion (Watanabe
  2010; Gelman, Hwang & Vehtari 2014), ``elpd_i = log E_s[p(y_i|th_s)] -
  Var_s[log p(y_i|th_s)]``;
* :func:`psis_loo`: Pareto-smoothed importance-sampling leave-one-out
  cross-validation (Vehtari, Gelman & Gabry 2017, arXiv:1507.02646, with
  the Zhang & Stephens 2009 generalized-Pareto fit); ``pareto_k > 0.7``
  flags the observations the approximation cannot handle;
* :func:`compare`: rank fitted models by elpd with paired standard errors
  of the differences.

Everything consumes one (S, N) pointwise log-likelihood matrix (S draws x
N observations), built by :func:`pointwise_log_lik` (``torch.func.vmap``
over the trace) or, for a BNN, by
:func:`pointwise_log_lik_from_predictions` from ``predict_model``'s
predictions.  Unlike the sampling-time ``log_likelihood``, the regression
branch includes the Gaussian normalisation constant.

The matrix stays on its device: the smoothing, the sorts and the sums run
there too, in float64 (the JAX module reduces WAIC in the matrix's dtype and
smooths in host numpy).  Scalars come back as Python floats and per-point
vectors as float64 tensors on the matrix's device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch

from .utils.pytree import tree_leaves, tree_map

__all__ = [
    "pointwise_log_lik",
    "pointwise_log_lik_from_predictions",
    "waic",
    "psis_loo",
    "compare",
    "WAICResult",
    "LOOResult",
]


class WAICResult(NamedTuple):
    elpd: float  # expected log pointwise predictive density (sum over i)
    p_eff: float  # effective number of parameters (sum of pointwise vars)
    se: float  # standard error of elpd
    pointwise: torch.Tensor  # (N,) per-observation elpd contributions


class LOOResult(NamedTuple):
    elpd: float
    p_eff: float
    se: float
    pointwise: torch.Tensor  # (N,)
    pareto_k: torch.Tensor  # (N,) GPD shape diagnostics (k > 0.7 = unreliable)


# ---------------------------------------------------------------------------
# pointwise log-likelihood matrices


def pointwise_log_lik(
    log_lik_fn: Callable,
    samples,
    data=None,
    block_size: int | None = None,
) -> torch.Tensor:
    """(S, N) pointwise log-likelihood matrix from a posterior trace.

    ``log_lik_fn(theta[, data]) -> (N,)`` is the per-observation log
    likelihood at one parameter value; ``samples`` is a flat (S, D) trace
    or a parameter tree with (S, ...) leaves.  ``block_size`` bounds memory
    for long traces: the vmap runs over blocks of that many draws.
    """
    fn = log_lik_fn if data is None else (lambda t: log_lik_fn(t, data))
    one = torch.func.vmap(fn)
    if block_size is None:
        return one(samples)
    s = tree_leaves(samples)[0].shape[0]
    if s % block_size:
        raise ValueError(
            f"block_size={block_size} must divide the number of draws {s}"
        )
    return torch.cat([
        one(tree_map(lambda leaf: leaf[b : b + block_size], samples))
        for b in range(0, s, block_size)
    ])


def pointwise_log_lik_from_predictions(
    preds, y, model_loss, tau_out: float = 1.0
) -> torch.Tensor:
    """(S, N) matrix from a (S, N, O) prediction stack (``predict_model``'s
    output) and targets ``y``, the likelihood zoo of ``models/bnn.py`` per
    observation.

    Differences from the sampling-time ``log_likelihood``, as in the JAX
    package: ``regression`` includes the Gaussian normalisation constant,
    and ``multi_class_log_softmax_output`` drops the reference's
    ``reduction='mean'`` quirk.
    """
    preds = torch.as_tensor(preds)
    y = torch.as_tensor(y, device=preds.device)
    if model_loss == "binary_class_linear_output":
        z, t = preds, y[None].to(preds.dtype)
        bce = torch.clamp_min(z, 0.0) - z * t + torch.log1p(torch.exp(-torch.abs(z)))
        return -tau_out * torch.sum(bce, dim=-1)
    if model_loss in ("multi_class_linear_output", "multi_class_log_softmax_output"):
        logp = preds
        if model_loss == "multi_class_linear_output":
            logp = torch.log_softmax(preds, dim=-1)
        labels = y.reshape(-1).to(torch.int64)
        index = labels[None, :, None].expand(logp.shape[0], -1, 1)
        return tau_out * torch.gather(logp, -1, index)[..., 0]
    if model_loss == "regression":
        o = preds.shape[-1]
        tau = torch.as_tensor(tau_out, dtype=preds.dtype, device=preds.device)
        const = 0.5 * o * (torch.log(tau) - math.log(2.0 * math.pi))
        return const - 0.5 * tau_out * torch.sum((preds - y[None]) ** 2, dim=-1)
    if callable(model_loss):
        return -torch.sum(model_loss(preds, y[None]), dim=-1)
    raise NotImplementedError(f"Unknown model_loss: {model_loss!r}")


def _as_matrix(loglik) -> torch.Tensor:
    ll = torch.as_tensor(loglik).to(torch.float64)
    if ll.ndim != 2:
        raise ValueError(f"loglik must be (S, N); got {tuple(ll.shape)}")
    return ll


def _se(pw: torch.Tensor) -> float:
    n = pw.shape[0]
    return float(torch.sqrt(n * pw.var(correction=1))) if n > 1 else float("nan")


# ---------------------------------------------------------------------------
# WAIC


def waic(loglik) -> WAICResult:
    """WAIC from an (S, N) pointwise log-likelihood matrix."""
    ll = _as_matrix(loglik)
    s = ll.shape[0]
    lppd = torch.logsumexp(ll, dim=0) - math.log(s)
    p_i = ll.var(dim=0, correction=1)
    pw = lppd - p_i
    return WAICResult(elpd=float(pw.sum()), p_eff=float(p_i.sum()), se=_se(pw), pointwise=pw)


# ---------------------------------------------------------------------------
# PSIS-LOO


def _gpd_fit(z: torch.Tensor):
    """Generalized-Pareto (k, sigma) fit per column of ascending-sorted
    exceedances ``z`` (M, N): Zhang & Stephens (2009) quadrature over the
    profile likelihood, with the weak prior of Vehtari et al.
    (arXiv:1507.02646, appendix): k <- (M k + 5) / (M + 10)."""
    m = z.shape[0]
    grid = 30 + int(math.sqrt(m))
    j = torch.arange(1, grid + 1, dtype=z.dtype, device=z.device)[:, None]  # (grid, 1)
    quart = z[max(int(m / 4.0 + 0.5) - 1, 0), :][None, :]  # (1, N)
    b = (1.0 - torch.sqrt(grid / (j - 0.5))) / (3.0 * quart) + 1.0 / z[-1, :][None, :]
    k_b = -torch.mean(torch.log1p(-b[:, None, :] * z[None, :, :]), dim=1)  # (grid, N)
    ratio = b / k_b
    neg_inf = torch.full_like(ratio, -math.inf)
    l_b = m * (torch.where(ratio > 0, torch.log(ratio), neg_inf) + k_b - 1.0)
    l_b = torch.where(torch.isfinite(l_b), l_b, neg_inf)
    # normalised profile weights w_j = 1 / sum_i exp(l_i - l_j)
    w = 1.0 / torch.sum(torch.exp(l_b[None, :, :] - l_b[:, None, :]), dim=1)
    w = w / torch.sum(w, dim=0, keepdim=True)
    b_hat = torch.sum(w * b, dim=0)  # (N,)
    k_zs = -torch.mean(torch.log1p(-b_hat[None, :] * z), dim=0)
    sigma = torch.where(b_hat != 0.0, k_zs / b_hat, torch.full_like(b_hat, math.nan))
    # Zhang & Stephens' k is the negative of the Pareto shape xi that PSIS
    # thresholds on; flip, then shrink xi toward 0.5 (the weak prior)
    xi = -k_zs
    xi = (m * xi + 5.0) / (m + 10.0)
    return xi, sigma


def _gpd_quantiles(q: torch.Tensor, k: torch.Tensor, sigma: torch.Tensor):
    """GPD inverse CDF at probabilities ``q`` (M,) for per-column (k, sigma)."""
    q = q[:, None]
    k = k[None, :]
    sigma = sigma[None, :]
    small = torch.abs(k) < 1e-8
    out = torch.where(
        small,
        -torch.log1p(-q),
        torch.expm1(-k * torch.log1p(-q)) / torch.where(small, torch.ones_like(k), k),
    )
    return sigma * out


def psis_smooth_weights(loglik, block: int = 1024):
    """(log_weights (S, N) normalised per column, pareto_k (N,)): the
    PSIS-LOO importance weights for an (S, N) log-likelihood matrix.

    Raw LOO log-weights are ``-loglik``; the largest
    M = min(0.2 S, 3 sqrt(S)) per column are replaced by the quantiles of a
    generalized-Pareto fit to their exceedances, then capped at the column
    max.  Columns whose tail is too short (M < 5) or whose fit fails are
    left unsmoothed with ``pareto_k = inf``.
    """
    lw_all = -_as_matrix(loglik)
    s, n = lw_all.shape
    m = int(min(0.2 * s, 3.0 * math.sqrt(s)))
    ks = torch.full((n,), math.inf, dtype=lw_all.dtype, device=lw_all.device)
    lw_all = lw_all - lw_all.max(dim=0, keepdim=True).values
    if m >= 5:
        q = (torch.arange(1, m + 1, dtype=lw_all.dtype, device=lw_all.device) - 0.5) / m
        for c0 in range(0, n, block):  # bound the (grid, M, block) temporary
            lw = lw_all[:, c0 : c0 + block]
            order = torch.argsort(lw, dim=0)
            tail_idx = order[s - m :, :]  # ascending top-M per column
            cutoff = torch.gather(lw, 0, order[s - m - 1 : s - m, :])[0]  # just below the tail
            tail = torch.gather(lw, 0, tail_idx)
            z = torch.exp(tail) - torch.exp(cutoff)[None, :]
            # guard zero or degenerate exceedances (ties at the cutoff)
            ok = z[-1, :] > 1e-12
            z = torch.clamp_min(z, 1e-300)
            k_hat, sigma = _gpd_fit(z)
            ok &= torch.isfinite(k_hat) & torch.isfinite(sigma) & (sigma > 0)
            smoothed = torch.log(torch.clamp_min(
                _gpd_quantiles(q, k_hat, sigma) + torch.exp(cutoff)[None, :], 1e-300))
            smoothed = torch.clamp_max(smoothed, 0.0)  # cap at the column max
            new_tail = torch.where(ok[None, :], smoothed, tail)
            lw_all[:, c0 : c0 + block] = lw.scatter(0, tail_idx, new_tail)
            ks[c0 : c0 + block] = torch.where(ok, k_hat, torch.full_like(k_hat, math.inf))
    # normalise per column
    col_max = lw_all.max(dim=0, keepdim=True).values
    lw_all = lw_all - (col_max + torch.log(torch.exp(lw_all - col_max).sum(dim=0, keepdim=True)))
    return lw_all, ks


def psis_loo(loglik) -> LOOResult:
    """PSIS-LOO from an (S, N) pointwise log-likelihood matrix.

    ``pointwise[i] = log sum_s exp(lw_norm[s, i] + loglik[s, i])``, the
    importance-weighted leave-one-out predictive density.  Check
    ``pareto_k``: above 0.7 the weights for that observation are too
    heavy-tailed for the approximation.
    """
    ll = _as_matrix(loglik)
    s = ll.shape[0]
    lw, ks = psis_smooth_weights(ll)
    a = lw + ll
    a_max = a.max(dim=0, keepdim=True).values
    pw = (a_max + torch.log(torch.exp(a - a_max).sum(dim=0, keepdim=True)))[0]
    lppd = torch.logsumexp(ll, dim=0) - math.log(s)
    return LOOResult(
        elpd=float(pw.sum()),
        p_eff=float(torch.sum(lppd - pw)),
        se=_se(pw),
        pointwise=pw,
        pareto_k=ks,
    )


# ---------------------------------------------------------------------------
# ranking


def compare(results: Dict[str, WAICResult | LOOResult]):
    """Rank fitted models by elpd (best first).

    Returns a list of dicts with ``name``, ``elpd``, ``se``, ``p_eff``,
    ``d_elpd`` (difference to the best model) and ``d_se``, the paired
    standard error ``sqrt(N * var(pw_best - pw_m))``, which accounts for
    the shared data points.
    """
    if not results:
        raise ValueError("compare() needs at least one result")
    lens = {len(r.pointwise) for r in results.values()}
    if len(lens) != 1:
        raise ValueError(
            f"all models must score the same observations; got N in {lens}"
        )
    ranked = sorted(results.items(), key=lambda kv: kv[1].elpd, reverse=True)
    best = ranked[0][1]
    best_pw = torch.as_tensor(best.pointwise, dtype=torch.float64)
    out = []
    for name, r in ranked:
        d = best_pw - torch.as_tensor(r.pointwise, dtype=torch.float64, device=best_pw.device)
        out.append(
            {
                "name": name,
                "elpd": r.elpd,
                "se": r.se,
                "p_eff": r.p_eff,
                "d_elpd": best.elpd - r.elpd,
                "d_se": _se(d) if len(d) > 1 else 0.0,
            }
        )
    return out
