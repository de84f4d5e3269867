"""The MCMC driver: a loop over draws for a batch of chains.

Counterpart of ``hamiltorch_tpu/samplers/driver.py``.  Per draw: momentum
noise, one transition, the Metropolis test against log U(0, 1), and the
burn/adapt bookkeeping.  As in the JAX package:

* divergences are branchless: a non-finite energy difference is masked out
  of the accept test and counts as alpha = 0 in adaptation;
* the potential evaluation at the current state is carried, so a draw
  costs exactly L gradient evaluations;
* dual averaging adapts while ``n < burn``, freezes to the averaged step
  size at ``n == burn`` and holds afterwards;
* on a rejection the chain stays where it is.

Where the JAX driver is one chain ``vmap``-ed over many, this one runs every
chain at once: the state carries a leading chain axis, and the transition
it is given is already batched (``samplers/hmc.py`` builds it with
``torch.func.vmap``).  The trace goes into a tensor allocated once.

Windowed mass warmup (``samplers/warmup.py``) rides the same loop: each
chain carries its own Welford moments and metric, and the transition is
rebuilt from the metric every draw.  Its schedule is static and shared by
every chain, so the collect and window-end flags are numpy booleans that
the loop branches on in Python: the metric estimate (for a dense metric a
batched inverse and Cholesky) is computed only at window ends, where the
JAX driver selects with ``where`` and ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from ..utils.progress import scan_progress
from ..utils.pytree import tree_leaves, tree_map
from ..utils.rng import draw_aux_noise, draw_noise
from .adaptation import DualAveragingState, da_init, da_update
from .warmup import schedule_flags, welford_cov_update, welford_update, windowed_step


class ChainState(NamedTuple):
    """Current chain position with its cached potential evaluation."""

    theta: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class MCMCStats(NamedTuple):
    """Per-draw diagnostics, (chains, kept draws) each."""

    accept_prob: torch.Tensor  # alpha = min(1, exp(H0 - H1)), 0 on divergence
    accepted: torch.Tensor  # bool MH outcome
    divergent: torch.Tensor  # bool, non-finite energy
    energy_old: torch.Tensor
    energy_new: torch.Tensor
    step_size: torch.Tensor  # step size used for this draw
    # the fixed-point diagnostics of the implicit RMHMC integrators (zero
    # elsewhere, as in the JAX package): the largest iteration count and
    # final squared residual over the trajectory (and the thinning window);
    # a count at fixed_point_max_iterations means a solve did not converge
    fp_iters: torch.Tensor  # int32
    fp_residual: torch.Tensor


class MCMCResult(NamedTuple):
    samples: torch.Tensor  # chain state after each kept draw
    stats: MCMCStats
    final_step_size: torch.Tensor
    acc_rate: torch.Tensor
    final_state: ChainState  # carry for chunked sampling
    final_da: DualAveragingState
    # windowed-warmup carry (Welford state, metric, window-relative DA
    # counter) with adapt_mass; None otherwise
    final_warm: object = None


def validate_common_config(config) -> None:
    """Reject a non-positive draw count or step size at construction."""
    if config.num_samples < 1:
        raise ValueError(f"num_samples={config.num_samples}; must be >= 1")
    if not config.step_size > 0:
        raise ValueError(
            f"step_size={config.step_size}; must be positive (a zero step "
            "size leaves every draw at the initial point)"
        )
    # negative burn is allowed: the reference's notebooks use burn=-1 as
    # "no burn" and the façade keeps that


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Sampling configuration (the JAX package's fields)."""

    num_samples: int
    num_steps_per_sample: int = 10
    step_size: float = 0.1
    burn: int = 0
    adapt_step_size: bool = False  # the reference's "HMC_NUTS" mode
    desired_accept_rate: float = 0.8
    # > 0: a progress line on the host's stdout every N draws
    progress_every: int = 0
    # thin > 1: keep every thin-th draw; num_samples counts ALL transitions
    # and must divide by thin.  Kept stats: bools are any-within-window,
    # accept_prob the window mean, energies and step size the kept draw's.
    thin: int = 1
    # Stan-style windowed mass warmup (samplers/warmup.py) over burn > 0:
    # False, True / "diag" (a diagonal inverse mass) or "dense"; honoured
    # by run_hmc and run_hmc_chains
    adapt_mass: bool | str = False

    def __post_init__(self):
        validate_common_config(self)
        if self.adapt_mass not in (False, True, "diag", "dense"):
            raise ValueError(
                f"adapt_mass={self.adapt_mass!r}; expected False, True, "
                "'diag' or 'dense'"
            )
        if self.thin < 1 or self.num_samples % self.thin:
            raise ValueError("num_samples must be divisible by thin >= 1")


# A transition proposes new states for every chain and returns the two
# Hamiltonians the Metropolis test needs:
# (z (C, D), state, step_size (C,)) -> (proposal, H0 (C,), H1 (C,)).
# It may append a 4th element, a dict of per-chain diagnostics
# ({"fp_iters", "fp_residual"}), which the driver folds into MCMCStats.  A
# run given ``extra_noise`` calls it with a 4th argument, that noise.
# With windowed warmup the caller passes make_transition(metric) -> such a
# transition instead, for the per-chain metric of the current draw.
TransitionFn = Callable[
    [torch.Tensor, ChainState, torch.Tensor],
    Tuple[ChainState, torch.Tensor, torch.Tensor],
]


def _tree_where(pred, a, b):
    def where(x, y):
        return torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)), x, y)

    return tree_map(where, a, b)


def _flat_chains(theta) -> torch.Tensor:
    """(C, D): every chain's state, a tree's leaves concatenated in leaf order."""
    leaves = tree_leaves(theta)
    if len(leaves) == 1 and leaves[0].ndim == 2:
        return leaves[0]
    return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1)


def run_mcmc(
    key: int,
    init_state: ChainState,
    transition: TransitionFn,
    config: MCMCConfig,
    init_da: DualAveragingState | None = None,
    start_iter: int = 0,
    make_transition=None,
    init_warm=None,
    collect_flags=None,
    end_flags=None,
    extra_noise=None,
    _noise=None,
) -> MCMCResult:
    """Run ``config.num_samples`` draws of ``transition`` from ``init_state``.

    Every tensor of ``init_state`` has a leading chain axis.  ``key`` is the
    integer seed of the per-draw streams (``utils/rng.py``).
    ``init_da``/``start_iter`` continue a previous chunk's adaptation and
    random stream exactly.  ``extra_noise = (kind, size)`` asks for more
    noise per draw and chain, passed to the transition as its 4th argument:
    ``("uniform", D)`` a (C, D) uniform (RMHMC's jitter), ``("perm", M)`` a
    (C, M) permutation (SPLITTING_RAND's term order); it comes from the
    chain's own stream keyed on (seed, chain, draw) (``utils/rng.py``).
    ``_noise = (z, log_u[, extra])``, of shapes ``(num_samples, C, D)``,
    ``(num_samples, C)`` and ``(num_samples, C, ...)``, replaces the drawn
    noise (a test hook).

    Windowed mass warmup (``config.adapt_mass`` with ``burn > 0``): the
    caller passes ``make_transition(metric) -> TransitionFn`` (``transition``
    is then ignored), the ``(welford, metric, da_t)`` carry as ``init_warm``
    (each with a leading chain axis), and may pass this run's slice of the
    schedule as numpy ``collect_flags`` / ``end_flags`` (length
    ``num_samples``; by default the draws' slice of the global schedule).
    Dual averaging then counts draws from the last window end (``da_t``)
    and restarts at each, as in the JAX driver.
    """
    leaves = tree_leaves(init_state.theta)
    dtype, device = leaves[0].dtype, leaves[0].device
    num_chains = leaves[0].shape[0]
    dim = sum(leaf[0].numel() for leaf in leaves)
    if init_da is None:
        init_da = da_init(
            torch.full((num_chains,), config.step_size, dtype=dtype, device=device),
            dtype=dtype, device=device,
        )
    da = init_da
    thin = config.thin
    kept = config.num_samples // thin

    windowed = make_transition is not None
    dense = windowed and config.adapt_mass == "dense"
    if windowed:
        if init_warm is None:
            raise ValueError("make_transition requires an init_warm carry seed")
        if collect_flags is None:
            collect_flags, end_flags = schedule_flags(config.burn, start_iter, config.num_samples)
        wf, metric, da_t = init_warm

    samples = tree_map(
        lambda leaf: torch.empty(
            (num_chains, kept) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=device
        ),
        init_state.theta,
    )
    stat_dtype = dict(accepted=torch.bool, divergent=torch.bool, fp_iters=torch.int32)
    stat_buf = {
        name: torch.zeros((num_chains, kept), dtype=stat_dtype.get(name, dtype), device=device)
        for name in MCMCStats._fields
    }
    acc_frac_sum = torch.zeros(num_chains, dtype=dtype, device=device)
    adapt = config.adapt_step_size and config.burn > 0
    # the bar reads the draw index and the host clock, never a device value
    progress = (scan_progress(config.num_samples, config.progress_every)
                if config.progress_every > 0 else None)

    state = init_state
    for k in range(kept):
        div_any = torch.zeros(num_chains, dtype=torch.bool, device=device)
        alpha_sum = torch.zeros(num_chains, dtype=dtype, device=device)
        acc_cnt = torch.zeros(num_chains, dtype=dtype, device=device)
        fp_it = fp_res = None
        for j in range(thin):
            n = start_iter + k * thin + j
            if progress is not None:
                progress(n - start_iter)  # the bar is sized per run, not global
            if _noise is None:
                z, log_u = draw_noise(key, n, num_chains, dim, dtype, device)
                extra = (None if extra_noise is None else
                         draw_aux_noise(key, n, num_chains, *extra_noise, dtype, device))
            else:
                z, log_u = _noise[0][n - start_iter], _noise[1][n - start_iter]
                extra = None if extra_noise is None else _noise[2][n - start_iter]
            step_size = da.step_size
            trans = make_transition(metric) if windowed else transition
            out = trans(z, state, step_size) if extra is None else trans(z, state, step_size, extra)
            proposal, h0, h1 = out[:3]
            if len(out) > 3:
                # maxed over the thinning window
                it, res = out[3]["fp_iters"], out[3]["fp_residual"]
                fp_it = it if fp_it is None else torch.maximum(fp_it, it)
                fp_res = res if fp_res is None else torch.maximum(fp_res, res)
            log_ratio = h0 - h1
            finite = torch.isfinite(log_ratio)
            rho = torch.clamp(
                torch.where(finite, log_ratio, torch.full_like(log_ratio, -torch.inf)),
                max=0.0,
            )
            accept = finite & (rho >= log_u)
            state = ChainState(
                *(_tree_where(accept, a, b) for a, b in zip(proposal, state))
            )
            alpha = torch.where(finite, torch.exp(rho), torch.zeros_like(rho))

            div_any |= ~finite
            alpha_sum += alpha
            acc_cnt += accept.to(dtype)

            if adapt:
                # adapt while n < burn; at n == burn freeze to the averaged
                # step size; afterwards hold.  Windowed warmup counts from
                # the last window end.
                if n < config.burn:
                    da = da_update(
                        da,
                        torch.where(finite, log_ratio, torch.full_like(log_ratio, torch.nan)),
                        da_t if windowed else n,
                        desired_accept_rate=config.desired_accept_rate,
                    )
                elif n == config.burn:
                    da = dataclasses.replace(da, step_size=torch.exp(da.log_eps_bar))

            if windowed:
                collect = bool(collect_flags[n - start_iter])
                window_end = bool(end_flags[n - start_iter])
                if collect:
                    wf = (welford_cov_update if dense else welford_update)(
                        wf, _flat_chains(state.theta))
                wf, metric, da = windowed_step(wf, metric, da, window_end, dense)
                da_t = torch.zeros_like(da_t) if window_end else da_t + 1

        tree_map(lambda buf, t: buf[:, k].copy_(t), samples, state.theta)
        stat_buf["accept_prob"][:, k] = alpha_sum / thin
        stat_buf["accepted"][:, k] = accept
        stat_buf["divergent"][:, k] = div_any
        stat_buf["energy_old"][:, k] = h0
        stat_buf["energy_new"][:, k] = h1
        stat_buf["step_size"][:, k] = step_size
        if fp_it is not None:
            stat_buf["fp_iters"][:, k] = fp_it
            stat_buf["fp_residual"][:, k] = fp_res
        acc_frac_sum += acc_cnt / thin

    if progress is not None:
        progress.end()
    return MCMCResult(
        samples=samples,
        stats=MCMCStats(**stat_buf),
        final_step_size=da.step_size,
        acc_rate=acc_frac_sum / kept,
        final_state=state,
        final_da=da,
        final_warm=(wf, metric, da_t) if windowed else None,
    )
