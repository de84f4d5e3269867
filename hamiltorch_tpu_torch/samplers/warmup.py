"""Stan-style windowed warmup: diagonal or dense mass-matrix estimation.

Counterpart of ``hamiltorch_tpu/samplers/warmup.py``.  Schedule (Stan's
defaults): an initial fast interval (step size only), doubling slow windows
that accumulate the posterior's variance (or covariance) with Welford
statistics, and a terminal fast interval.  At every slow-window boundary
the inverse mass becomes the regularised estimate, Welford resets, and dual
averaging restarts recentred on the current step size.

The Welford states may carry leading chain axes: every update works on the
trailing (D,) or (D, D) axes, so the driver updates all chains at once.
The schedule is static, a pair of numpy flag arrays; the driver branches on
them in Python (``windowed_step`` takes the window end as a bool), where
the JAX scan selects with ``where``.

``init_metric_seed`` and ``init_dense_metric`` live in ``samplers/nuts.py``,
as in the JAX package; this module re-exports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


class WelfordState(NamedTuple):
    count: torch.Tensor  # (...,)
    mean: torch.Tensor  # (..., D)
    m2: torch.Tensor  # (..., D)


def welford_init(dim: int, dtype=torch.float32, device=None, batch: tuple = ()) -> WelfordState:
    return WelfordState(
        count=torch.zeros(batch, dtype=dtype, device=device),
        mean=torch.zeros(batch + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(batch + (dim,), dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def _batch_count(state, xs, count):
    n = float(xs.shape[0]) if count is None else count
    return torch.as_tensor(n, dtype=state.count.dtype, device=state.count.device)


def welford_merge_batch(state: WelfordState, xs: torch.Tensor, gsum=None,
                        count=None) -> WelfordState:
    """Chan's parallel merge of a (B, D) batch into the running stats.

    ``gsum``/``count`` generalise the batch moments to a sharded batch:
    ``gsum(x)`` must sum over the batch axis across all shards and
    ``count`` is the global batch size (defaults: local sum / local size).
    """
    if gsum is None:
        gsum = lambda x: torch.sum(x, dim=0)  # noqa: E731
    n_b = _batch_count(state, xs, count)
    mean_b = gsum(xs) / n_b
    m2_b = gsum((xs - mean_b) ** 2)
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * n_b / n_new
    m2 = state.m2 + m2_b + delta**2 * state.count * n_b / n_new
    return WelfordState(n_new, mean, m2)


def welford_variance(state: WelfordState) -> torch.Tensor:
    """Regularised variance: (n/(n+5)) var + 1e-3 (5/(n+5)) (Stan)."""
    n = torch.clamp(state.count, min=2.0)[..., None]
    var = state.m2 / (n - 1.0)
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


class WelfordCovState(NamedTuple):
    """Full-covariance accumulator for dense-metric warmup."""

    count: torch.Tensor  # (...,)
    mean: torch.Tensor  # (..., D)
    m2: torch.Tensor  # (..., D, D) sum of outer-product deviations


def welford_cov_init(dim: int, dtype=torch.float32, device=None,
                     batch: tuple = ()) -> WelfordCovState:
    return WelfordCovState(
        count=torch.zeros(batch, dtype=dtype, device=device),
        mean=torch.zeros(batch + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(batch + (dim, dim), dtype=dtype, device=device),
    )


def welford_cov_update(state: WelfordCovState, x: torch.Tensor) -> WelfordCovState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    return WelfordCovState(count, mean, m2)


def welford_cov_merge_batch(state: WelfordCovState, xs: torch.Tensor, gsum=None,
                            count=None) -> WelfordCovState:
    """Chan's parallel merge of a (B, D) batch into the covariance stats;
    ``gsum``/``count`` as in :func:`welford_merge_batch`."""
    if gsum is None:
        gsum = lambda x: torch.sum(x, dim=0)  # noqa: E731
    n_b = _batch_count(state, xs, count)
    mean_b = gsum(xs) / n_b
    dev = xs - mean_b
    m2_b = gsum(dev[:, :, None] * dev[:, None, :])
    n_new = state.count + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * n_b / n_new
    m2 = state.m2 + m2_b + torch.outer(delta, delta) * state.count * n_b / n_new
    return WelfordCovState(n_new, mean, m2)


def welford_covariance(state: WelfordCovState) -> torch.Tensor:
    """Stan's regularised dense estimate: (n/(n+5)) cov + 1e-3 (5/(n+5)) I;
    the shrinkage toward a small identity keeps the metric SPD through early
    windows with few draws."""
    n = torch.clamp(state.count, min=2.0)[..., None, None]
    cov = state.m2 / (n - 1.0)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    return (n / (n + 5.0)) * cov + (1e-3 * 5.0 / (n + 5.0)) * eye


def windowed_step(wf, metric, da, window_end: bool, dense: bool):
    """The warmup carry at one draw after ``wf`` took its observation (on
    collect draws): at a slow-window end adopt the metric estimate, reset
    the accumulator, and restart dual averaging recentred on log(10 eps).
    Returns (wf, metric, da); every tensor may carry leading chain axes.
    """
    if not window_end:
        return wf, metric, da
    batch, d = tuple(wf.mean.shape[:-1]), wf.mean.shape[-1]
    dtype, device = wf.mean.dtype, wf.mean.device
    if dense:
        # the O(D^3) inverse and Cholesky run only here
        inv_cov = welford_covariance(wf)
        m = torch.linalg.inv(inv_cov)
        chol = torch.linalg.cholesky(0.5 * (m + m.transpose(-1, -2)))
        metric = (inv_cov, chol)
        wf = welford_cov_init(d, dtype, device, batch)
    else:
        metric = welford_variance(wf)
        wf = welford_init(d, dtype, device, batch)
    da = dataclasses.replace(
        da,
        log_eps_bar=torch.zeros_like(da.log_eps_bar),
        h_t=torch.zeros_like(da.h_t),
        mu=torch.log(10.0 * da.step_size),
    )
    return wf, metric, da


def validate_adapt_mass(adapt_mass, mass) -> None:
    """``adapt_mass`` mode against the user's inverse mass."""
    from ..ops.mass import DenseMass, DiagMass, IdentityMass

    if adapt_mass not in (False, True, "diag", "dense"):
        raise ValueError(
            f"adapt_mass={adapt_mass!r}; expected False, True, 'diag' or 'dense'"
        )
    if adapt_mass == "dense":
        if not isinstance(mass, (DenseMass, DiagMass, IdentityMass)):
            raise ValueError(
                "adapt_mass='dense' cannot seed from a block-diagonal "
                "inv_mass — pass a dense or diagonal inv_mass, or none."
            )
    elif adapt_mass and not isinstance(mass, (DiagMass, IdentityMass)):
        raise ValueError(
            "adapt_mass estimates a DIAGONAL inverse mass; combining it with "
            "a dense or block inv_mass is not supported — pass a diagonal "
            "inv_mass (used to seed the adaptation), none, or "
            "adapt_mass='dense'."
        )


def build_schedule(
    burn: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-draw static flags (collect[n], window_end[n]) over burn draws.

    Stan's warmup windows; no windows when burn < init + term + base.
    """
    collect = np.zeros(max(burn, 0), dtype=bool)
    window_end = np.zeros(max(burn, 0), dtype=bool)
    if burn >= init_buffer + term_buffer + base_window:
        pos = init_buffer
        window = base_window
        last_slow = burn - term_buffer
        while pos < last_slow:
            end = pos + window
            if end + 2 * window > last_slow:
                end = last_slow  # the final window absorbs the remainder
            collect[pos:end] = True
            window_end[end - 1] = True
            pos = end
            window *= 2
    return collect, window_end


def schedule_flags(burn: int, start: int, length: int):
    """(collect, window_end) numpy flags for draws [start, start + length)
    of a run whose warmup spans ``burn`` draws: chunked sampling hands each
    chunk its slice of the global schedule."""
    collect_np, end_np = build_schedule(burn)
    tail = max(length + start - max(burn, 0), 0)
    full_c = np.concatenate([collect_np, np.zeros(tail, bool)])
    full_e = np.concatenate([end_np, np.zeros(tail, bool)])
    return full_c[start:start + length], full_e[start:start + length]


def __getattr__(name):
    # init_metric_seed and init_dense_metric live in samplers/nuts.py, where
    # the JAX package keeps them; they are re-exported here for the HMC
    # driver (imported on first use: nuts.py imports this module)
    if name in ("init_metric_seed", "init_dense_metric"):
        from . import nuts

        return getattr(nuts, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
