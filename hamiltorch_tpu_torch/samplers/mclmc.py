"""Microcanonical Langevin Monte Carlo (MCLMC).

Counterpart of ``hamiltorch_tpu/samplers/mclmc.py`` (Robnik, De Luca,
Silverstein & Seljak 2022, arXiv:2212.08549; tuning: Robnik & Seljak 2023,
arXiv:2303.18221).  The dynamics are ISOKINETIC: the velocity u lives on
the unit sphere S^{d-1}, positions drift as dx/dt = u and the gradient
bends u toward increasing log p,

    du/dt = P(u) grad(log p)(x) / (d - 1),    P(u) = I - u u^T,

so the stationary x-marginal is exp(log p) without a Metropolis test.  A
weak O(eps^2) discretisation bias remains; tuning eps so that the
per-dimension energy-error variance Var[dE]/d sits at
``desired_energy_var`` controls it.  After every step a partial refresh

    u <- (u + nu z) / |u + nu z|,  z ~ N(0, I),  nu = sqrt(expm1(2 eps / L) / d)

decorrelates the velocity with coherence length L, the second tuned scale
(L ~ sqrt(tr Sigma), measured during tuning).

As in the JAX package, one chain's step is written once (velocity updates
in the exact exponential-map form, the trailing gradient riding the carry)
and chains are batched on a leading axis with ``torch.func.vmap``, each
with its own (eps, L).  Non-finite steps are branchless rejections flagged
in ``stats.divergent``; no exception crosses the loop.

Random numbers: the normals of chain ``c`` come from ``utils.rng``'s
stream keyed on (seed, c, index), with the JAX code's index namespaces:
main steps use the global step index, tuning step i uses 2**31 + i, and
the initial velocity 2**32 - 1.  A run split into chunks with
``resume_from`` (or ``init_u``/``start_step``) therefore equals the
straight run bit for bit.  ``_noise`` hands in the normals instead (a test
hook): ``(init, tune, main)`` of shapes ``(C, D)``, ``(T, C, D)`` and
``(S, C, D)`` for ``run_mclmc_chains`` (without the ``C`` axis for
``run_mclmc``); ``init`` is the normal the initial velocity is the unit
vector of, and may be None when the velocity is given.

Every run stays on the device of the caller's tensors: a CPU tensor is the
caller asking for the CPU.

Integrators: ``"mclachlan"`` (default), the minimal-norm scheme
V(b1 e) X(e/2) V((1-2 b1) e) X(e/2) V(b1 e) with b1 = 0.19318..., two fresh
gradients per step; ``"leapfrog"`` V(e/2) X(e) V(e/2), one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..ops.potential import make_flat_potential, resolve_potential, value_and_grad
from ..utils.convert import place_start
from ..utils.pytree import (
    is_param_tree,
    ravel_pytree_fn,
    stack_param_tree,
    tree_map,
    unravel_last_axis_fn,
)
from ..utils.rng import draw_normals

# minimal-norm (McLachlan) velocity coefficient
_B1 = 0.1931833275037836
# utils.rng stream indices of the tuning steps and of the initial velocity
_TUNE_BASE = 2**31
_INIT_INDEX = 2**32 - 1


@dataclasses.dataclass(frozen=True)
class MCLMCConfig:
    """Static configuration for :func:`run_mclmc`.

    ``num_samples`` counts TOTAL post-tuning transitions; with ``thin > 1``
    every thin-th state is kept (``num_samples`` divisible by ``thin``).

    ``tune_steps > 0`` runs a tuning phase first: the step size follows a
    log-space Robbins-Monro update toward ``desired_energy_var`` (the
    per-dimension energy-error variance Var[dE]/d; energy error ~ eps^6
    for the minimal-norm integrator, hence the 1/6 exponent), and, when
    ``trajectory_length`` is None, L = sqrt(tr Sigma_hat) from second-half
    Welford statistics of the tuning trajectory.  ``tune_steps = 0`` runs
    at the given (``step_size``, ``trajectory_length``) unchanged: the
    resume path.
    """

    num_samples: int
    step_size: float = 0.2
    trajectory_length: float | None = None  # L; None = tuned / sqrt(d) seed
    tune_steps: int = 500
    desired_energy_var: float = 5e-4
    integrator: str = "mclachlan"  # "mclachlan" | "leapfrog"
    thin: int = 1

    def __post_init__(self):
        if self.num_samples < 1:
            raise ValueError(f"num_samples={self.num_samples}; must be >= 1")
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")
        if self.trajectory_length is not None and not self.trajectory_length > 0:
            raise ValueError("trajectory_length must be positive")
        if self.tune_steps < 0:
            raise ValueError("tune_steps must be >= 0")
        if not self.desired_energy_var > 0:
            raise ValueError("desired_energy_var must be positive")
        if self.integrator not in ("mclachlan", "leapfrog"):
            raise ValueError(
                f"integrator={self.integrator!r}; must be 'mclachlan' or 'leapfrog'"
            )
        if self.thin < 1:
            raise ValueError("thin must be >= 1")
        if self.num_samples % self.thin:
            raise ValueError(
                f"num_samples={self.num_samples} must be divisible by thin={self.thin}"
            )


class MCLMCStats(NamedTuple):
    """Per-kept-draw diagnostics."""

    energy_change: torch.Tensor  # dE of the kept step (f32)
    divergent: torch.Tensor  # bool: any non-finite (skipped) step in window


class MCLMCResult(NamedTuple):
    samples: torch.Tensor  # (N, D) or tree of (N, ...) leaves; chains first
    stats: MCLMCStats
    step_size: torch.Tensor  # eps the main phase ran at (post-tune)
    trajectory_length: torch.Tensor  # L the main phase ran at
    final_theta: object  # last state (resume)
    final_u: torch.Tensor  # last unit velocity, flat (D,) (resume)
    final_step: torch.Tensor  # global step counter after the run


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v))


def _velocity_update(u, g, coef, dims):
    """Exact isokinetic velocity update (ESH dynamics, arXiv:2212.08549
    eq. 6): rotate u toward the gradient direction by the exponential map,
    returning the kinetic energy change (d-1) * log-factor (float64).

    The norm, the dot and the rotation's scalars are float64 (the JAX code
    computes them in float32), as in ``kernels/bnn_mclmc.py``: for small
    delta, dk ~ (d-1) delta ue is the difference of terms near ln 2 times
    d - 1, and float32 rounding of zeta and the logs alone leaves
    ~(d-1) * 2^-24 in it, 4e-3 at the flagship's d = 1e5, far above the
    true dE at a tuned step.  The vectors stay in u's dtype.
    """
    gd = g.double()
    g_norm = torch.sqrt(torch.sum(gd * gd))
    # zero gradient (a chain at a mode): the rotation is the identity, but
    # g/|g| is 0/0; guard the division
    inv_g = 1.0 / torch.clamp(g_norm, min=1e-30)
    delta = coef * g_norm / (dims - 1)
    # rounding can push the unit-vector dot a hair outside [-1, 1]; and at
    # ue = -1 with zeta -> 0 the log argument touches 0: floor it so dK is
    # large but finite, not NaN (a NaN would cascade through the tuner)
    ue = torch.clamp(torch.sum(u.double() * gd) * inv_g, -1.0, 1.0)
    zeta = torch.exp(-delta)
    ce = (1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) * inv_g
    u_new = g * ce.to(u.dtype) + (2.0 * zeta).to(u.dtype) * u
    d_kinetic = (dims - 1.0) * (
        delta - math.log(2.0)
        + torch.log(torch.clamp(1.0 + ue + (1.0 - ue) * zeta * zeta, min=1e-12))
    )
    return _unit(u_new), d_kinetic


def _make_step(vg, dims, integrator: str):
    """One chain's deterministic step: (x, u, logp, g, eps) -> updated + dE.

    The trailing velocity update of step k happens at the same x as the
    leading one of step k+1, so its gradient rides the carry: 2
    (mclachlan) or 1 (leapfrog) fresh gradients per step.  dE is summed and
    returned in float64: MAMS accumulates it over a trajectory, MCLMC casts
    each step's to float32.
    """

    if integrator == "mclachlan":

        def step(x, u, logp, g, eps):
            u, de = _velocity_update(u, g, _B1 * eps, dims)
            x = x + (0.5 * eps) * u
            _, g1 = vg(x)
            u, dk = _velocity_update(u, g1, (1.0 - 2.0 * _B1) * eps, dims)
            de = de + dk
            x = x + (0.5 * eps) * u
            logp2, g2 = vg(x)
            u, dk = _velocity_update(u, g2, _B1 * eps, dims)
            de = de + dk + (logp - logp2).double()  # potential change
            return x, u, logp2, g2, de

    else:  # leapfrog

        def step(x, u, logp, g, eps):
            u, dk1 = _velocity_update(u, g, 0.5 * eps, dims)
            x = x + eps * u
            logp1, g1 = vg(x)
            u, dk2 = _velocity_update(u, g1, 0.5 * eps, dims)
            return x, u, logp1, g1, dk1 + dk2 + (logp - logp1).double()

    return step


def _refresh(u, z, eps, length, dims):
    """Partial momentum refresh: OU decorrelation with coherence time L."""
    nu = torch.sqrt(torch.expm1(2.0 * eps / length) / dims)
    return _unit(u + nu * z)


def _where(ok, new, old):
    return torch.where(ok.reshape(ok.shape + (1,) * (new.ndim - 1)), new, old)


def _run_chains(key, theta0, eps0, length0, lp, config: MCLMCConfig, init_u=None,
                start_step: int = 0, _noise=None) -> MCLMCResult:
    """MCLMC on every chain of the (C, D) ``theta0``, each with its own
    seed scales ``eps0``, ``length0`` (C,)."""
    c, dims = theta0.shape
    dtype, device = theta0.dtype, theta0.device
    step = torch.func.vmap(_make_step(value_and_grad(lp), dims, config.integrator))
    refresh = torch.func.vmap(lambda u, z, e, l: _refresh(u, z, e, l, dims))
    n_kept = config.num_samples // config.thin

    def normals(index, part, local):
        if _noise is None:
            return draw_normals(key, index, c, dims, dtype, device)
        z = _noise[part]
        return z if local is None else z[local]

    u0 = torch.func.vmap(_unit)(normals(_INIT_INDEX, 0, None)) if init_u is None else init_u
    logp0, g0 = torch.func.vmap(value_and_grad(lp))(theta0)

    def guarded_step(x, u, logp, g, eps):
        xn, un, logpn, gn, de = step(x, u, logp, g, eps)
        de = de.float()
        ok = (torch.isfinite(de) & torch.all(torch.isfinite(xn), dim=1)
              & torch.all(torch.isfinite(un), dim=1))
        return (_where(ok, xn, x), _where(ok, un, u), _where(ok, logpn, logp),
                _where(ok, gn, g), de, ok)

    # ---- tuning phase --------------------------------------------------------
    x, u, logp, g = theta0, u0, logp0, g0
    if config.tune_steps > 0:
        half = config.tune_steps // 2
        target = torch.tensor(config.desired_energy_var, dtype=torch.float32, device=device)
        beta = 0.99  # dE^2 EMA decay (~100-step window)
        log_eps_lo = math.log(config.step_size) - 7.0  # sanity bounds: the
        log_eps_hi = math.log(config.step_size) + 7.0  # seed +- factor ~1100
        log_eps = torch.log(eps0)
        var_e = torch.zeros(c, dtype=torch.float32, device=device)
        ema_t = torch.zeros(c, dtype=torch.float32, device=device)
        cnt = torch.zeros((), dtype=torch.float32, device=device)
        w_mean = torch.zeros((c, dims), dtype=torch.float32, device=device)
        w_m2 = torch.zeros((c, dims), dtype=torch.float32, device=device)
        for i in range(config.tune_steps):
            eps = torch.exp(log_eps)
            x, u, logp, g, de, ok = guarded_step(x, u, logp, g, eps.to(dtype))
            # Robbins-Monro toward the energy-variance target on a LINEAR
            # EMA of dE^2/d (bias-corrected); non-finite steps halve eps
            var_e = torch.where(ok, beta * var_e + (1 - beta) * de * de / dims, var_e)
            ema_t = ema_t + torch.where(ok, 1.0, 0.0)
            corrected = var_e / torch.clamp(1.0 - beta**ema_t, min=1e-6)
            upd = torch.clamp(
                0.03 / 6.0 * (torch.log(target) - torch.log(corrected + 1e-20)), -0.25, 0.25
            )
            log_eps = torch.where(ok, log_eps + upd, log_eps + math.log(0.5))
            log_eps = torch.clamp(log_eps, log_eps_lo, log_eps_hi)
            # second-half Welford of x -> L = sqrt(tr Sigma_hat)
            if i >= half:
                cnt = cnt + 1.0
                x32 = x.to(torch.float32)
                delta = x32 - w_mean
                w_mean = w_mean + delta / torch.clamp(cnt, min=1.0)
                w_m2 = w_m2 + delta * (x32 - w_mean)
            # partial refresh (the seed L only sets nu here)
            u = refresh(u, normals(_TUNE_BASE + i, 1, i), eps, length0)
        eps = torch.exp(log_eps)
        if config.trajectory_length is None:
            var = w_m2 / torch.clamp(cnt, min=1.0)
            length = torch.maximum(torch.sqrt(torch.sum(var, dim=1)), 2.0 * eps)
        else:
            length = length0
    else:
        eps, length = eps0, length0

    # ---- main phase ----------------------------------------------------------
    eps_d = eps.to(dtype)
    samples = torch.empty((c, n_kept, dims), dtype=dtype, device=device)
    energy = torch.empty((c, n_kept), dtype=torch.float32, device=device)
    divergent = torch.empty((c, n_kept), dtype=torch.bool, device=device)
    for b in range(n_kept):
        div = torch.zeros(c, dtype=torch.bool, device=device)
        for j in range(config.thin):
            local = b * config.thin + j
            x, u, logp, g, de, ok = guarded_step(x, u, logp, g, eps_d)
            u = refresh(u, normals(start_step + local, 2, local), eps, length)
            div = div | ~ok
        samples[:, b] = x
        energy[:, b] = de
        divergent[:, b] = div
    final_step = torch.full((c,), start_step + config.num_samples, dtype=torch.int32,
                            device=device)
    return MCLMCResult(
        samples=samples, stats=MCLMCStats(energy_change=energy, divergent=divergent),
        step_size=eps, trajectory_length=length, final_theta=x, final_u=u,
        final_step=final_step,
    )


def _seed_scales(config: MCLMCConfig, dims: int, num_chains: int, device):
    length = config.trajectory_length
    if length is None:
        length = math.sqrt(float(dims))
    return (torch.full((num_chains,), config.step_size, dtype=torch.float32, device=device),
            torch.full((num_chains,), length, dtype=torch.float32, device=device))


def _prep_flat(log_prob_fn, theta0, pass_grad):
    """Boundary ravel: tree states run the flat sampler (the dynamics need
    whole-vector norms anyway); samples unravel on the way out.
    Returns (flat theta0, flat potential, unravel or None)."""
    theta0 = place_start(theta0)
    if not is_param_tree(theta0):
        if theta0.ndim != 1:
            raise ValueError(
                f"theta0 must be 1-d (got shape {tuple(theta0.shape)}); "
                "pass tree states as a tree, not a matrix"
            )
        if theta0.shape[0] < 2:
            raise ValueError(
                "MCLMC needs dimension >= 2 (the isokinetic velocity lives "
                "on S^{d-1}; for 1-d targets use run_hmc)"
            )
        return theta0, resolve_potential(log_prob_fn, pass_grad), None
    if pass_grad is not None:
        raise ValueError(
            "pass_grad expects a flat (D,) state (a user gradient for a "
            "tree state would need a matching ravel); flatten the state "
            "or drop pass_grad"
        )
    flat0, unravel = ravel_pytree_fn(theta0)
    if flat0.shape[0] < 2:
        raise ValueError("MCLMC needs dimension >= 2")
    return flat0, resolve_potential(make_flat_potential(log_prob_fn, theta0)), unravel


def _bind_data(log_prob_fn, data):
    if data is None:
        return log_prob_fn
    return lambda theta: log_prob_fn(theta, data)


def _unravel_result(r: MCLMCResult, unravel) -> MCLMCResult:
    if unravel is None:
        return r
    return r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))


def run_mclmc(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: MCLMCConfig,
    data=None,
    init_u=None,
    start_step: int = 0,
    pass_grad=None,
    _noise=None,
) -> MCLMCResult:
    """Microcanonical Langevin Monte Carlo, one chain; see the module docstring.

    ``theta0`` may be flat (D,) or a parameter tree (samples keep leaf
    shapes with a leading kept-draws axis); ``data=`` calls
    ``log_prob_fn(theta, data)``.  ``key`` is an integer seed.  The chain
    runs on the device of ``theta0``.

    MCLMC is UNADJUSTED: there is no Metropolis test, and a small O(eps^2)
    stationary bias remains, controlled by ``config.desired_energy_var``.

    Chunked runs resume bit-exactly at fixed tuning: run the first chunk
    with ``tune_steps > 0``, then feed ``final_theta`` / ``final_u`` /
    ``final_step`` back with ``tune_steps=0`` and
    ``step_size=float(result.step_size)``,
    ``trajectory_length=float(result.trajectory_length)``.
    """
    theta0f, lp, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    eps0, length0 = _seed_scales(config, theta0f.shape[0], 1, theta0f.device)
    if _noise is not None:
        _noise = tuple(None if z is None else z.unsqueeze(-2) for z in _noise)
    r = _run_chains(key, theta0f[None], eps0, length0, lp, config,
                    init_u=None if init_u is None else torch.as_tensor(
                        init_u, device=theta0f.device)[None],
                    start_step=int(start_step), _noise=_noise)
    r = MCLMCResult(
        samples=r.samples[0], stats=MCLMCStats(*(s[0] for s in r.stats)),
        step_size=r.step_size[0], trajectory_length=r.trajectory_length[0],
        final_theta=r.final_theta[0], final_u=r.final_u[0], final_step=r.final_step[0],
    )
    return _unravel_result(r, unravel)


def _ravel_chains(theta):
    """(C, D) from a tree whose leaves carry a leading chain axis."""
    return torch.func.vmap(lambda t: ravel_pytree_fn(t)[0])(theta)


def run_mclmc_chains(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: MCLMCConfig,
    num_chains: int,
    data=None,
    theta0_is_stacked: bool | None = None,
    resume_from: MCLMCResult | None = None,
    _noise=None,
) -> MCLMCResult:
    """Independent MCLMC chains batched on a leading axis; each chain tunes
    its own (eps, L), and every result carries the chain axis first.

    ``theta0`` may be (D,) (copied to every chain), (num_chains, D), or a
    parameter tree, single-chain (copied) or with a leading ``num_chains``
    axis on every leaf (``theta0_is_stacked`` overrides the detection).
    ``key`` is an integer seed; chain ``c`` draws from its own stream.  The
    chains run on the device of ``theta0``.

    ``resume_from``: a previous ``run_mclmc_chains`` result; continues
    every chain from its ``final_theta``/``final_u``/``final_step`` at its
    OWN tuned (eps, L).  Requires ``config.tune_steps == 0`` and the SAME
    ``key`` as the original call (then the glued trace equals one straight
    run bit for bit); ``theta0`` is ignored.
    """
    lp = _bind_data(log_prob_fn, data)
    if resume_from is not None:
        if config.tune_steps != 0:
            raise ValueError(
                "resume_from continues at the ALREADY-tuned per-chain (eps, L); "
                "set tune_steps=0 (re-tuning would fork the chains from their "
                "carried state)"
            )
        steps = set(torch.as_tensor(resume_from.final_step).reshape(-1).tolist())
        if len(steps) != 1:
            raise ValueError(f"resume_from's chains stopped at different steps {sorted(steps)}")
        prev = resume_from.final_theta
        if is_param_tree(prev):
            _, fn, unravel = _prep_flat(lp, tree_map(lambda leaf: leaf[0], prev), None)
            thetas = _ravel_chains(prev)
        else:
            thetas = torch.as_tensor(prev)
            _, fn, unravel = _prep_flat(lp, thetas[0], None)
        r = _run_chains(key, thetas, resume_from.step_size.to(torch.float32),
                        resume_from.trajectory_length.to(torch.float32), fn, config,
                        init_u=resume_from.final_u, start_step=steps.pop(), _noise=_noise)
        return _unravel_result(r, unravel)

    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        _, fn, unravel = _prep_flat(lp, template, None)
        theta0 = _ravel_chains(stacked)
    else:
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
        _, fn, unravel = _prep_flat(lp, theta0[0], None)
    eps0, length0 = _seed_scales(config, theta0.shape[1], num_chains, theta0.device)
    r = _run_chains(key, theta0, eps0, length0, fn, config, _noise=_noise)
    return _unravel_result(r, unravel)
