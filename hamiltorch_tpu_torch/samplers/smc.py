"""Tempered Sequential Monte Carlo with HMC mutations (SMC sampler).

Counterpart of ``hamiltorch_tpu/samplers/smc.py``.  A population of
particles moves from the prior to the posterior through the tempered path
``pi_k ∝ prior * lik^beta_k``: at each stage the particles reweight by the
likelihood increment, resample when the weights degenerate, and mutate with
a few jittered-HMC steps at the current temperature.  The running sum of
log-mean incremental weights estimates the model evidence log Z.

Each stage is (reweight -> conditional systematic resampling -> R batched
leapfrog mutations, ``samplers.chees._batched_leapfrog``).  Resampling is
branchless: the systematic indices are always computed and ``torch.where``
on the ESS test picks them or the identity, so a stage reads nothing back
to the host.  The step size adapts across stages by a Robbins-Monro update,
and every particle of a mutation shares one trajectory length.  Without
``adapt_trajectory`` the length comes from the host's jitter and needs no
device read; with it (ChEES-SMC, arXiv:2504.02627) L = ceil(u T / eps),
capped, is computed on the device and read once a mutation (NaN and
overflow map to 1 and the cap, as XLA's int32 conversion does), and T
follows Adam on the ChEES criterion with the population as the ensemble.

Particles are flat (N, D) blocks or trees of (N, ...) leaves.  Random
numbers: stage k's resample uniform, momenta and Metropolis uniforms come
from one generator keyed on (seed, ``SMC_STREAM`` + k), its jitter from a
host generator keyed the same way (``utils.rng.draw_smc_stage_noise``), so
each stage's noise depends on the seed and the stage alone.  ``_noise`` (a
test hook) hands in ``{"z", "jit", "u_mh"}`` with leading (stages,
mcmc_steps) and ``u_res`` (stages,) instead: ``z`` flat (.., N, D) or a tree
of (.., N, ...) leaves; ``jit`` the trajectory lengths as integers without
``adapt_trajectory`` and the uniforms with it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.potential import resolve_potential, value_and_grad
from ..utils.convert import place_start
from ..utils.pytree import tree_leaves, tree_map, unravel_last_axis_fn
from ..utils.rng import (
    SMC_STREAM,
    draw_seed,
    draw_smc_posterior_uniform,
    draw_smc_stage_noise,
)
from .chees import _batched_leapfrog, _leapfrog_count
from .driver import _tree_where
from .nuts import _t_dot


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    num_particles: int
    # tempering stages: beta_k = (k / num_temps)**temp_power, k = 1..num_temps
    num_temps: int = 20
    temp_power: float = 3.0
    mcmc_steps: int = 5  # HMC mutations per stage
    leapfrog_steps: int = 10  # leapfrog steps per mutation
    step_size: float = 0.1
    # resample when ESS / N drops below this fraction (1.0 = every stage,
    # 0.0 = never)
    resample_threshold: float = 0.5
    # Robbins-Monro step-size adaptation across stages toward the
    # jittered-HMC optimum (Hoffman et al. 2021)
    adapt_step_size: bool = True
    desired_accept_rate: float = 0.651
    # ChEES trajectory-length adaptation (ChEES-SMC, arXiv:2504.02627):
    # each mutation runs ceil(u * T / eps) leapfrog steps capped at
    # ``leapfrog_steps``, and T follows Adam on the population's ChEES
    # gradient.  Off: lengths 1 + U{0, .., leapfrog_steps - 1}
    adapt_trajectory: bool = False
    # initial trajectory time T_0; None = step_size * leapfrog_steps / 2
    init_trajectory_length: float | None = None
    adam_lr: float = 0.025

    def __post_init__(self):
        if self.num_particles < 2:
            raise ValueError("num_particles must be >= 2")
        if self.num_temps < 1:
            raise ValueError("num_temps must be >= 1")
        if self.mcmc_steps < 1:
            raise ValueError("mcmc_steps must be >= 1")
        if self.leapfrog_steps < 1:
            raise ValueError("leapfrog_steps must be >= 1")
        if not self.temp_power > 0:
            raise ValueError("temp_power must be positive")
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")
        if not 0.0 <= self.resample_threshold <= 1.0:
            raise ValueError("resample_threshold must be in [0, 1]")
        if not 0.0 < self.desired_accept_rate < 1.0:
            raise ValueError("desired_accept_rate must be in (0, 1)")
        if self.init_trajectory_length is not None and not (
            self.init_trajectory_length > 0
        ):
            raise ValueError("init_trajectory_length must be positive")
        if not self.adam_lr > 0:
            raise ValueError("adam_lr must be positive")


class SMCInfo(NamedTuple):
    betas: torch.Tensor  # (K,) tempering ladder
    ess_fraction: torch.Tensor  # (K,) ESS/N before each resample decision
    resampled: torch.Tensor  # (K,) bool
    accept_prob: torch.Tensor  # (K,) mean mutation acceptance per stage
    step_size: torch.Tensor  # (K,) step size used at each stage
    # (K,) trajectory time T each stage mutated with (at stage entry);
    # constant at T_0 unless config.adapt_trajectory
    trajectory_length: torch.Tensor


class SMCResult(NamedTuple):
    particles: object  # (N, D) or a tree of (N, ...) leaves: the FINAL stage
    log_weights: torch.Tensor  # (N,) normalised log-weights of the particles
    log_evidence: torch.Tensor  # scalar: estimate of log Z = log p(data)
    info: SMCInfo


def _systematic_resample(u, logw, n: int) -> torch.Tensor:
    """Systematic resampling: (N,) int64 indices from log-weights, one
    uniform ``u`` offsetting a stratified comb, by ``searchsorted`` on the
    weight cumsum.  When the cumsum ends below the last position (float
    rounding), ``searchsorted`` returns n: the index is clamped to n - 1,
    as the JAX package's gather clamps it."""
    w = torch.softmax(logw, dim=0)
    positions = (u + torch.arange(n, dtype=logw.dtype, device=logw.device)) / n
    idx = torch.searchsorted(torch.cumsum(w, dim=0), positions)
    return torch.clamp(idx, max=n - 1)


def _resample_margin(u, logw, n: int) -> torch.Tensor:
    """The least distance between a comb position and a cumsum value (how
    far the resample indices are from changing); a test hook's record."""
    cum = torch.cumsum(torch.softmax(logw, dim=0), dim=0)
    positions = (u + torch.arange(n, dtype=logw.dtype, device=logw.device)) / n
    return (cum[:, None] - positions[None, :]).abs().min()


def _run_smc(key: int, particles0, log_prior_fn, log_lik_fn, config: SMCConfig, data=None,
             _noise=None, _margins=None) -> SMCResult:
    """The stage loop.  ``_margins`` (a test hook), when a list, receives
    every decision's least distance from its other outcome: the Metropolis
    tests, the ESS test, the resample comb against the cumsum (in stages
    that resample) and, with ``adapt_trajectory``, u T / eps against the
    integers."""
    lik = log_lik_fn if data is None else (lambda t: log_lik_fn(t, data))
    leaves0 = tree_leaves(particles0)
    n, dtype, device = leaves0[0].shape[0], leaves0[0].dtype, leaves0[0].device
    d = sum(leaf[0].numel() for leaf in leaves0)
    unflat = unravel_last_axis_fn(tree_map(lambda t: t[0], particles0))
    cap = config.leapfrog_steps

    betas = (torch.arange(1, config.num_temps + 1, dtype=dtype, device=device)
             / config.num_temps) ** config.temp_power
    prev_betas = torch.cat([torch.zeros((1,), dtype=dtype, device=device), betas[:-1]])
    lik_vec = torch.func.vmap(lik)
    arange_n = torch.arange(n, device=device)

    def identity(p):
        return p

    def mutate(stage_noise, parts, beta, eps, traj):
        """R jittered-HMC transitions targeting prior * lik^beta; ``traj =
        (log_t, adam_m, adam_v, adam_t)`` rides unchanged unless
        ``config.adapt_trajectory``."""

        def tempered(t):
            return log_prior_fn(t) + beta * lik(t)

        vg = torch.func.vmap(value_and_grad(tempered))
        logps, grads = vg(parts)
        alpha_means = []
        for r in range(config.mcmc_steps):
            log_t, adam_m, adam_v, adam_t = traj
            z, jit, u_mh = stage_noise(r)
            if config.adapt_trajectory:
                traj_t = jit * torch.exp(log_t)
                q = traj_t / eps
                num_steps = _leapfrog_count(float(torch.ceil(q)), cap)  # the sync
                if _margins is not None:
                    _margins.append(torch.where(
                        q >= cap, q - cap, torch.where(q <= 1, 1 - q, (q - torch.round(q)).abs())))
            else:
                num_steps = int(jit)
            ps = z
            h0 = -logps + 0.5 * _t_dot(ps, ps)
            th, p1, logp1, grad1 = _batched_leapfrog(vg, identity, parts, ps, logps, grads, eps,
                                                     num_steps)
            h1 = -logp1 + 0.5 * _t_dot(p1, p1)
            log_ratio = h0 - h1
            finite = torch.isfinite(log_ratio)
            zeros = torch.zeros_like(log_ratio)
            alpha = torch.where(finite, torch.exp(torch.clamp(log_ratio, max=0.0)), zeros)
            log_u = torch.log(u_mh)
            accept = finite & (log_u < log_ratio)
            if _margins is not None:
                _margins.append(torch.where(finite, (log_u - log_ratio).abs(),
                                            torch.full_like(log_ratio, float("inf"))).min())
            parts_out = _tree_where(accept, th, parts)
            logps = torch.where(accept, logp1, logps)
            grads = _tree_where(accept, grad1, grads)

            if config.adapt_trajectory:
                # the ChEES gradient with respect to log T (samplers/chees.py)
                # with the particles as the ensemble and an identity mass
                mu = tree_map(lambda leaf: leaf.sum(dim=0) / n, parts_out)
                diff_new = tree_map(lambda a, m: a - m, th, mu)
                diff_old = tree_map(lambda a, m: a - m, parts, mu)
                per = (_t_dot(diff_new, diff_new) - _t_dot(diff_old, diff_old)) * _t_dot(
                    diff_new, p1)
                w = alpha / torch.clamp(alpha.sum(dim=0), min=1e-6)
                contrib = torch.where(finite, w * per, zeros)
                contrib = torch.where(torch.isfinite(contrib), contrib, zeros)
                grad_log_t = torch.clamp(traj_t * contrib.sum(dim=0), -1e6, 1e6)
                t1 = torch.tensor(adam_t + 1, dtype=dtype, device=device)
                adam_m = 0.9 * adam_m + 0.1 * grad_log_t
                adam_v = 0.999 * adam_v + 0.001 * grad_log_t**2
                m_hat = adam_m / (1.0 - 0.9**t1)
                v_hat = adam_v / (1.0 - 0.999**t1)
                log_t = log_t + config.adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
                # keep trajectories sane: T in [eps, eps * leapfrog_steps]
                log_t = torch.clamp(log_t, torch.log(eps), torch.log(eps * cap))
                traj = (log_t, adam_m, adam_v, adam_t + 1)
            parts = parts_out
            alpha_means.append(alpha.sum(dim=0) / n)
        return parts, torch.stack(alpha_means).sum(dim=0) / config.mcmc_steps, traj

    t0 = (config.init_trajectory_length if config.init_trajectory_length is not None
          else config.step_size * config.leapfrog_steps / 2.0)
    zero = torch.zeros((), dtype=dtype, device=device)
    traj = (torch.log(torch.tensor(t0, dtype=dtype, device=device)), zero, zero, 0)
    parts = particles0
    logw = torch.zeros((n,), dtype=dtype, device=device)
    log_z = zero
    eps = torch.tensor(config.step_size, dtype=dtype, device=device)
    rows = []
    for k in range(config.num_temps):
        # per-stage noise keyed on (seed, stage): no carried generator state
        if _noise is None:
            drawn = draw_smc_stage_noise(key, k, config.mcmc_steps, n, d, dtype, device)
            u_res = drawn["u_res"]

            def stage_noise(r, drawn=drawn):
                jit = drawn["jit"][r]
                if config.adapt_trajectory:
                    jit = torch.tensor(jit, dtype=dtype, device=device)
                else:
                    jit = 1 + int(jit * config.leapfrog_steps)
                return unflat(drawn["z"][r]), jit, drawn["u_mh"][r]
        else:
            u_res = _noise["u_res"][k]

            def stage_noise(r, k=k):
                return (tree_map(lambda t: t[k, r], _noise["z"]), _noise["jit"][k][r],
                        _noise["u_mh"][k][r])

        # --- reweight: incremental likelihood tempering -------------------
        incr = (betas[k] - prev_betas[k]) * lik_vec(parts)
        logw_n = logw - torch.logsumexp(logw, dim=0)
        log_z = log_z + torch.logsumexp(logw_n + incr, dim=0)
        logw = logw_n + incr

        # --- conditional systematic resampling (branchless select) --------
        w = torch.softmax(logw, dim=0)
        ess_frac = 1.0 / (n * torch.sum(w * w))
        do_resample = ess_frac < config.resample_threshold
        idx = torch.where(do_resample, _systematic_resample(u_res, logw, n), arange_n)
        if _margins is not None:
            _margins.append((ess_frac - config.resample_threshold).abs())
            _margins.append(torch.where(do_resample, _resample_margin(u_res, logw, n),
                                        torch.full_like(ess_frac, float("inf"))))
        parts = tree_map(lambda t: t[idx], parts)
        logw = torch.where(do_resample, torch.zeros_like(logw), logw)

        # --- mutate at the current temperature -----------------------------
        t_used = torch.exp(traj[0])  # the T this stage's mutations start at
        parts, acc, traj = mutate(stage_noise, parts, betas[k], eps, traj)
        eps_used = eps
        if config.adapt_step_size:
            # Robbins-Monro toward the jittered-HMC optimal acceptance
            eps = eps * torch.exp(0.5 * torch.clamp(acc - config.desired_accept_rate, -0.5, 0.5))
        rows.append((ess_frac, do_resample, acc, eps_used, t_used))

    ess_f, res, accs, epss, ts = (torch.stack(col) for col in zip(*rows))
    return SMCResult(
        particles=parts,
        log_weights=logw - torch.logsumexp(logw, dim=0),
        log_evidence=log_z,
        info=SMCInfo(betas=betas, ess_fraction=ess_f, resampled=res, accept_prob=accs,
                     step_size=epss, trajectory_length=ts),
    )


def run_smc(
    key: int,
    log_prior_fn,
    log_lik_fn,
    prior_sample_fn,
    config: SMCConfig,
    data=None,
    _noise=None,
    _margins=None,
) -> SMCResult:
    """Tempered SMC from the prior to the posterior.

    * ``log_prior_fn(theta)``: the log prior density (the beta=0 endpoint);
    * ``log_lik_fn(theta[, data])``: the log likelihood, tempered by beta,
      called with ``data`` when it is given;
    * ``prior_sample_fn(key, n)``: n draws from the prior, an (N, D) block
      or a tree of (N, ...) leaves (it sets the particle layout).  It gets an
      integer seed (``draw_seed(key, 2, SMC_STREAM)``); what it returns goes
      to the card when it is not a tensor, and the particles run on its
      device.

    Returns an :class:`SMCResult`: the final population with normalised
    ``log_weights``, the ``log_evidence`` estimate of log p(data) and the
    per-stage diagnostics.  ``key`` is an integer seed.  ``_noise`` /
    ``_margins``: see the module docstring and :func:`_run_smc`.
    """
    particles0 = place_start(prior_sample_fn(draw_seed(key, 2, SMC_STREAM),
                                             config.num_particles))
    if any(tuple(leaf.shape[:1]) != (config.num_particles,) for leaf in tree_leaves(particles0)):
        raise ValueError(
            "prior_sample_fn must return leaves with a leading "
            f"num_particles={config.num_particles} axis"
        )
    lik = resolve_potential(log_lik_fn, None)
    return _run_smc(key, particles0, log_prior_fn, lik, config, data=data, _noise=_noise,
                    _margins=_margins)


def smc_posterior_sample(key: int, result: SMCResult, _noise=None):
    """Equal-weight posterior draws: one systematic resample of the final
    population under its normalised log-weights.  The comb's uniform comes
    from ``utils.rng.draw_smc_posterior_uniform(key)``; ``_noise`` (a test
    hook) hands it in."""
    n = tree_leaves(result.particles)[0].shape[0]
    u = draw_smc_posterior_uniform(key) if _noise is None else _noise
    u = torch.as_tensor(u, dtype=result.log_weights.dtype, device=result.log_weights.device)
    idx = _systematic_resample(u, result.log_weights, n)
    return tree_map(lambda t: t[idx], result.particles)
