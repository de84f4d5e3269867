"""Thermodynamic integration / power posteriors: model evidence from a
replica ladder.

Counterpart of ``hamiltorch_tpu/samplers/ti.py``.  A power-posterior run
samples the path ``pi_beta ∝ prior * lik^beta`` on a FIXED ladder 0 =
beta_0 < ... < beta_{K-1} = 1 (Friel & Pettitt 2008), one HMC replica per
rung with adjacent replica exchange, and estimates the model evidence two
ways from the same draws: the stepping stone (Xie et al. 2011, the headline
``log_evidence``) and the variance-corrected trapezoid of Friel, Hurn &
Wyse 2014 (the plain trapezoid beside it as a discretisation diagnostic).
With ``run_smc`` and a Laplace approximation it is one of three evidence
estimators that check each other.

The rung axis is one batch axis: every leapfrog step is one
``torch.func.vmap``-ed value and gradient of ``prior + beta * lik`` over the
rungs, whose auxiliary output is the log-likelihood (swaps and estimators
need no second likelihood pass).  A swap moves only the states and their
log-likelihoods; each draw evaluates the value and gradient again at the
top, at each slot's own beta (one extra evaluation a draw, as in the JAX
package).  Per-rung dual averaging adapts while n < burn; every draw with n
>= burn steps with the averaged step size.

Random numbers: at global draw n one generator keyed on (seed, 0,
``TI_STREAM`` + n) draws the rungs' momenta (a flat (K, D) normal split into
the leaves), Metropolis uniforms and swap uniforms
(``utils.rng.draw_ladder_noise``).  ``_noise`` (a test hook) hands in
``{"z": (S, K, D) or a tree of (S, K, ...) leaves, "u_mh": (S, K),
"u_swap": (S, K)}`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.potential import resolve_potential
from ..utils.convert import place_start
from ..utils.pytree import (
    is_param_tree,
    stack_param_tree,
    tree_leaves,
    tree_map,
    unravel_last_axis_fn,
)
from ..utils.rng import TI_STREAM, draw_ladder_noise
from .adaptation import DualAveragingState, da_update
from .driver import validate_common_config
from .tempering import _r_where, _rbcast, _tmap, swap_partners


@dataclasses.dataclass(frozen=True)
class TIConfig:
    """Configuration of :func:`run_ti`.

    ``num_temps`` rungs at ``beta_k = (k / (K-1)) ** schedule_power``.
    ``burn`` draws are dropped from every estimator and bound the per-rung
    step-size adaptation (on by default).
    """

    num_samples: int
    num_steps_per_sample: int = 10
    step_size: float = 0.1
    num_temps: int = 16
    schedule_power: float = 5.0
    burn: int = 0
    swap: bool = True  # adjacent replica exchange (even/odd alternation)
    adapt_step_size: bool = True
    desired_accept_rate: float = 0.8

    def __post_init__(self):
        validate_common_config(self)
        if self.num_temps < 2:
            raise ValueError("num_temps must be >= 2 (endpoints beta=0, 1)")
        if not self.schedule_power > 0:
            raise ValueError("schedule_power must be positive")
        if not 0.0 < self.desired_accept_rate < 1.0:
            raise ValueError("desired_accept_rate must be in (0, 1)")
        if self.adapt_step_size and self.burn < 1:
            raise ValueError(
                "adapt_step_size needs burn >= 1 (the adaptation window)"
            )


class TIInfo(NamedTuple):
    betas: torch.Tensor  # (K,) ladder
    accept_prob: torch.Tensor  # (N - burn, K) per-rung HMC acceptance
    swap_accept: torch.Tensor  # (N - burn, K-1) adjacent swap outcomes
    step_sizes: torch.Tensor  # (K,) final per-rung step sizes
    rung_mean_loglik: torch.Tensor  # (K,) post-burn E_beta[log lik]
    rung_var_loglik: torch.Tensor  # (K,) post-burn Var_beta[log lik]


class TIResult(NamedTuple):
    log_evidence: torch.Tensor  # stepping-stone estimate (headline)
    log_evidence_ti: torch.Tensor  # variance-corrected trapezoid
    log_evidence_ti_plain: torch.Tensor  # plain trapezoid (diagnostic)
    samples: object  # (N - burn, ...) the beta=1 (posterior) chain
    loglik_draws: torch.Tensor  # (N - burn, K) per-rung log-lik trace
    info: TIInfo


def ti_ladder(num_temps: int, power: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """``beta_k = (k/(K-1))**power``: endpoints exactly 0 and 1."""
    return (torch.arange(num_temps, dtype=dtype, device=device) / (num_temps - 1)) ** power


def init_ti_da(config: TIConfig, k: int, dtype, device) -> DualAveragingState:
    """Per-rung dual averaging at ``config.step_size`` (shared with
    ``run_ti_checkpointed``)."""
    eps0 = torch.full((k,), config.step_size, dtype=dtype, device=device)
    return DualAveragingState(step_size=eps0, log_eps_bar=torch.zeros_like(eps0),
                              h_t=torch.zeros_like(eps0), mu=torch.log(10.0 * eps0))


def _run_ti(key: int, theta0s, log_prior_fn, log_lik_fn, config: TIConfig, data=None,
            init_da=None, start_iter: int = 0, _noise=None, _margins=None):
    """``config.num_samples`` TI draws over the rungs on the leading axis of
    ``theta0s``; returns ``(cold, llik_trace, alphas, swaps, betas,
    step_sizes, final_thetas, final_da)`` (unburned).

    ``init_da`` / ``start_iter`` continue an earlier chunk exactly (the
    global draw index keys the noise and the pairing parity).  ``_margins``
    (a test hook): see ``tempering._run_pt``.
    """
    lik = log_lik_fn if data is None else (lambda t: log_lik_fn(t, data))
    leaves0 = tree_leaves(theta0s)
    k, dtype, device = leaves0[0].shape[0], leaves0[0].dtype, leaves0[0].device
    d = sum(leaf[0].numel() for leaf in leaves0)
    betas = ti_ladder(k, config.schedule_power, dtype, device)
    unflat = unravel_last_axis_fn(tree_map(lambda t: t[0], theta0s))

    def tempered(t, beta):
        ll = lik(t)
        return log_prior_fn(t) + beta * ll, ll

    # one forward and backward a rung lane; the aux carries the log lik
    gv = torch.func.vmap(torch.func.grad_and_value(tempered, has_aux=True), in_dims=(0, 0))

    def vg(th):
        g, (v, ll) = gv(th, betas)
        return v, ll, g

    def kinetic(ps):
        return sum(0.5 * torch.sum((pl * pl).reshape(k, -1), dim=-1) for pl in tree_leaves(ps))

    maps = swap_partners(k, device)
    idx = torch.arange(k, device=device)
    eps0 = torch.full((k,), config.step_size, dtype=dtype, device=device)
    da = init_da if init_da is not None else init_ti_da(config, k, dtype, device)

    num = config.num_samples
    thetas = theta0s
    cold = tree_map(lambda t: torch.empty((num,) + tuple(t.shape[1:]), dtype=t.dtype,
                                          device=device), thetas)
    llik_tr = torch.empty((num, k), dtype=dtype, device=device)
    alphas = torch.empty((num, k), dtype=dtype, device=device)
    swaps = torch.empty((num, k - 1), dtype=torch.bool, device=device)

    for i in range(num):
        n = start_iter + i
        # fresh tempered value and gradient at the slot's OWN beta, which
        # includes any state moved here by the last draw's swap
        vals, lliks, grads = vg(thetas)
        if config.adapt_step_size:
            # every estimator-visible draw (n >= burn) runs at the averaged
            # step; log_eps_bar is frozen after burn, so chunks agree
            eps_k = torch.exp(da.log_eps_bar) if n >= config.burn else da.step_size
        else:
            eps_k = eps0
        if _noise is None:
            z, u_mh, u_swap = draw_ladder_noise(key, n, 0, k, d, TI_STREAM, dtype, device)
            ps = unflat(z)
        else:
            ps = tree_map(lambda t: t[i], _noise["z"])
            u_mh, u_swap = _noise["u_mh"][i], _noise["u_swap"][i]

        # --- one HMC transition per rung (batched, identity mass) ----------
        h0 = -vals + kinetic(ps)
        p = _tmap(lambda pl, gl: pl + 0.5 * _rbcast(eps_k, pl) * gl, ps, grads)
        th, v, ll, g = thetas, vals, lliks, grads
        for _ in range(config.num_steps_per_sample):
            th = _tmap(lambda tl, pl: tl + _rbcast(eps_k, tl) * pl, th, p)
            v, ll, g = vg(th)
            p = _tmap(lambda pl, gl: pl + _rbcast(eps_k, pl) * gl, p, g)
        p = _tmap(lambda pl, gl: pl - 0.5 * _rbcast(eps_k, pl) * gl, p, g)
        h1 = -v + kinetic(p)
        log_ratio = h0 - h1
        finite = torch.isfinite(log_ratio)
        alpha = torch.where(finite, torch.exp(torch.clamp(log_ratio, max=0.0)),
                            torch.zeros_like(log_ratio))
        log_u = torch.log(u_mh)
        accept = finite & (log_u < log_ratio)
        thetas = _r_where(accept, th, thetas)
        lliks = torch.where(accept, ll, lliks)

        if config.adapt_step_size:
            # per-rung dual averaging during burn, frozen to the averaged
            # step at n == burn (the tempering schedule)
            if n < config.burn:
                lar = torch.where(finite, log_ratio, torch.full_like(log_ratio, float("nan")))
                da = da_update(da, lar, n, desired_accept_rate=config.desired_accept_rate)
            elif n == config.burn:
                da = dataclasses.replace(da, step_size=torch.exp(da.log_eps_bar))

        # --- adjacent replica exchange on the likelihood gap ---------------
        if _margins is not None:
            inf = torch.full_like(log_ratio, float("inf"))
            margin = torch.where(finite, (log_u - log_ratio).abs(), inf).min()
        if config.swap:
            partner, pair_lo, attempted = maps[n % 2]
            log_swap = (betas - betas[partner]) * (lliks[partner] - lliks)
            log_u_pair = torch.log(u_swap[pair_lo])
            paired = partner != idx
            do_swap = paired & (log_u_pair < log_swap)
            src = torch.where(do_swap, partner, idx)
            thetas = tree_map(lambda t: t[src], thetas)
            lliks = lliks[src]
            swap_mask = do_swap[:-1] & attempted
            if _margins is not None:
                margin = torch.minimum(margin, torch.where(
                    paired & torch.isfinite(log_swap), (log_u_pair - log_swap).abs(), inf).min())
        else:
            swap_mask = torch.zeros((k - 1,), dtype=torch.bool, device=device)
        if _margins is not None:
            _margins.append(margin)

        tree_map(lambda buf, t: buf[i].copy_(t[-1]), cold, thetas)
        llik_tr[i] = lliks
        alphas[i] = alpha
        swaps[i] = swap_mask

    return cold, llik_tr, alphas, swaps, betas, da.step_size, thetas, da


def evidence_from_loglik_draws(llik, betas):
    """(stepping_stone, corrected_trapezoid, plain_trapezoid) from an (N, K)
    post-burn log-likelihood trace on ladder ``betas``.

    Stepping stone uses rung k's draws to bridge to rung k+1:
    ``sum_k [logsumexp(dbeta_k * ll_k) - log N]``; TI integrates the
    per-rung means by trapezoid with the Friel-Hurn-Wyse variance
    correction ``-(dbeta^2/12)(V_{k+1} - V_k)``.
    """
    llik = torch.as_tensor(llik)
    betas = torch.as_tensor(betas, dtype=llik.dtype, device=llik.device)
    n = llik.shape[0]
    dbeta = torch.diff(betas)
    means = torch.mean(llik, dim=0)
    varis = torch.var(llik, dim=0, correction=0)
    ss = torch.sum(torch.logsumexp(dbeta[None, :] * llik[:, :-1], dim=0) - math.log(n))
    plain = torch.sum(0.5 * dbeta * (means[:-1] + means[1:]))
    corrected = plain - torch.sum(dbeta**2 / 12.0 * (varis[1:] - varis[:-1]))
    return ss, corrected, plain


def run_ti(
    key: int,
    log_prior_fn,
    log_lik_fn,
    theta0,
    config: TIConfig,
    data=None,
    _noise=None,
    _margins=None,
) -> TIResult:
    """Power-posterior evidence estimation; see the module docstring.

    * ``log_prior_fn(theta)``: the log prior density (the beta=0 endpoint;
      it must be proper, or log Z is meaningless);
    * ``log_lik_fn(theta[, data])``: the log likelihood, called with
      ``data`` when it is given;
    * ``theta0``: one initial state, copied to every rung, a flat (D,)
      vector or a parameter tree (leaves may carry a leading ``num_temps``
      axis for per-rung starts).

    Returns a :class:`TIResult`; ``log_evidence`` is the stepping-stone
    estimate, with both trapezoid forms beside it.  ``samples`` is the
    beta=1 rung, a valid posterior chain.  ``key`` is an integer seed; the
    ladder runs on the device of ``theta0`` (the card for a start that is
    not a tensor).  ``_noise`` / ``_margins``: see :func:`_run_ti`.
    """
    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0s = stack_ti_rungs(theta0, config)
    lik = resolve_potential(log_lik_fn, None)
    out = _run_ti(key, theta0s, log_prior_fn, lik, config, data=data, _noise=_noise,
                  _margins=_margins)
    return assemble_ti_result(out, config)


def stack_ti_rungs(theta0, config: TIConfig):
    """One initial state copied to every rung (or per-rung leaves with a
    leading ``num_temps`` axis), on the card for a start that is not a
    tensor; shared with ``run_ti_checkpointed``."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        _, theta0s = stack_param_tree(theta0, config.num_temps)
        return theta0s
    if theta0.ndim == 1:
        return theta0.unsqueeze(0).expand((config.num_temps,) + tuple(theta0.shape)).clone()
    if theta0.shape[0] != config.num_temps:
        raise ValueError(
            f"theta0 provides {theta0.shape[0]} rungs but "
            f"config.num_temps={config.num_temps}"
        )
    return theta0


def assemble_ti_result(out, config: TIConfig, burn=None) -> TIResult:
    """Burn-slice a (possibly chunk-concatenated) TI trajectory and run the
    evidence estimators; shared by both runners."""
    cold, llik_tr, alphas, swaps, betas, eps_f = out[:6]
    burn = max(config.burn if burn is None else burn, 0)
    llik_post = llik_tr[burn:]
    ss, corr, plain = evidence_from_loglik_draws(llik_post, betas)
    return TIResult(
        log_evidence=ss,
        log_evidence_ti=corr,
        log_evidence_ti_plain=plain,
        samples=_tmap(lambda t: t[burn:], cold),
        loglik_draws=llik_post,
        info=TIInfo(
            betas=betas,
            accept_prob=alphas[burn:],
            swap_accept=swaps[burn:],
            step_sizes=eps_f,
            rung_mean_loglik=torch.mean(llik_post, dim=0),
            rung_var_loglik=torch.var(llik_post, dim=0, correction=0),
        ),
    )
