"""MAMS: the Metropolis-adjusted microcanonical sampler.

Counterpart of ``hamiltorch_tpu/samplers/mams.py`` (Robnik, Cohn-Gordon &
Seljak 2025, arXiv:2503.01707): the isokinetic dynamics of MCLMC
(``samplers/mclmc.py``: a unit-sphere velocity, exact exponential-map
updates), but each draw proposes a whole ``num_steps_per_sample``-step
trajectory from a fully refreshed velocity and Metropolis-accepts it on the
trajectory's energy change dE (the kinetic changes less the log-density
change).  The test removes MCLMC's O(eps^2) bias: the chain targets
exp(log_prob) exactly.  The step size adapts by dual averaging
(``samplers/adaptation.py``) toward ``desired_accept_rate`` during ``burn``
draws, then freezes to the averaged iterate.

As in the JAX package: a draw is accepted when ``log u < -dE`` (strictly),
a trajectory with a non-finite dE, position or gradient is rejected and
flagged ``divergent`` (dual averaging sees NaN, alpha = 0), and with
``thin > 1`` a kept draw's stats are the last draw's of its window with
``divergent`` any-in-window.  Unlike the JAX code, dE is summed over the
trajectory in float64 and tested against log u in float64 (the JAX code
sums in float32): at d = 1e5 a float32 kinetic change rounds by ~4e-3 per
rotation, enough to decide accepts.  ``energy_change`` is stored in float32.

Chains run batched on a leading axis, each adapting its own step size.
Random numbers: draw ``g`` of chain ``c`` takes D normals (the velocity is
their unit vector) and one uniform from ``utils.rng``'s stream keyed on
(seed, c, MAMS_STREAM + g), so runs chunked with ``init_da`` /
``start_step`` equal the straight run bit for bit.  ``_noise = (z (S, C,
D), u (S, C))`` hands in the normals and uniforms instead (a test hook; S
counts every draw, thinned ones included; no C axis for ``run_mams``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..utils.convert import place_start
from ..utils.pytree import is_param_tree, stack_param_tree
from ..utils.rng import MAMS_STREAM, draw_noise
from ..ops.potential import value_and_grad
from .adaptation import DualAveragingState, da_init, da_update
from .mclmc import _bind_data, _make_step, _prep_flat, _ravel_chains, _unit, _where


@dataclasses.dataclass(frozen=True)
class MAMSConfig:
    """Configuration of :func:`run_mams`.

    ``num_samples`` counts every draw (trajectory); the trace includes the
    ``burn`` adaptation draws.  ``num_steps_per_sample`` is the trajectory's
    length in integrator steps; eps is what adapts.  ``adapt_step_size``
    requires ``burn > 0``; with it off the sampler runs at ``step_size``
    (the resume path).
    """

    num_samples: int
    num_steps_per_sample: int = 10
    step_size: float = 0.2
    burn: int = 0
    adapt_step_size: bool = True
    desired_accept_rate: float = 0.9
    integrator: str = "mclachlan"  # "mclachlan" | "leapfrog"
    thin: int = 1

    def __post_init__(self):
        if self.num_samples < 1:
            raise ValueError(f"num_samples={self.num_samples}; must be >= 1")
        if self.num_steps_per_sample < 1:
            raise ValueError("num_steps_per_sample must be >= 1")
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")
        if self.burn < 0:
            # burn is a GLOBAL draw index (resumed chunks run with burn >=
            # the chunk's num_samples); fresh runs check burn < num_samples
            # at the run_mams door
            raise ValueError(f"burn={self.burn} must be >= 0")
        if self.adapt_step_size and self.burn == 0:
            raise ValueError(
                "adapt_step_size requires burn > 0 (no draws to adapt on); "
                "set adapt_step_size=False to run at the given step_size"
            )
        if not 0.0 < self.desired_accept_rate < 1.0:
            raise ValueError("desired_accept_rate must be in (0, 1)")
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


class MAMSStats(NamedTuple):
    """Per-kept-draw diagnostics (the window's last draw when thinned)."""

    accept_prob: torch.Tensor  # min(1, exp(-dE)) of the trajectory
    accepted: torch.Tensor  # bool MH outcome
    energy_change: torch.Tensor  # trajectory dE (float32)
    divergent: torch.Tensor  # any non-finite trajectory in the window
    step_size: torch.Tensor  # eps the draw ran at


class MAMSResult(NamedTuple):
    samples: torch.Tensor  # (N_kept, D) or tree of (N_kept, ...) leaves; chains first
    stats: MAMSStats
    step_size: torch.Tensor  # frozen (averaged) eps after burn
    acc_rate: torch.Tensor  # mean post-burn acceptance
    final_theta: object  # last state (resume)
    final_da: DualAveragingState  # adaptation carry (resume)
    final_step: torch.Tensor  # global draw counter after the run


def _run_chains(key, theta0, lp, config: MAMSConfig, init_da=None, start_step: int = 0,
                _noise=None) -> MAMSResult:
    """MAMS on every chain of the (C, D) ``theta0``."""
    c, dims = theta0.shape
    dtype, device = theta0.dtype, theta0.device
    vg = value_and_grad(lp)
    step = torch.func.vmap(_make_step(vg, dims, config.integrator))
    unit = torch.func.vmap(_unit)
    n_kept = config.num_samples // config.thin
    adapt = config.adapt_step_size

    theta, (logp, g) = theta0, torch.func.vmap(vg)(theta0)
    da = init_da if init_da is not None else da_init(
        torch.full((c,), config.step_size, dtype=torch.float32, device=device))

    samples = torch.empty((c, n_kept, dims), dtype=dtype, device=device)
    stats = {name: torch.empty((c, n_kept), device=device,
                               dtype=torch.bool if name in ("accepted", "divergent") else torch.float32)
             for name in MAMSStats._fields}
    for b in range(n_kept):
        div = torch.zeros(c, dtype=torch.bool, device=device)
        for j in range(config.thin):
            local = b * config.thin + j
            g_idx = start_step + local
            if _noise is None:
                z, log_u = draw_noise(key, MAMS_STREAM + g_idx, c, dims, dtype, device)
            else:
                z, log_u = _noise[0][local], torch.log(_noise[1][local])
            u = unit(z)  # full refresh: uniform on the sphere
            eps = da.step_size if g_idx < config.burn or not adapt else torch.exp(da.log_eps_bar)
            eps = eps.to(dtype)
            x, lpv, gv = theta, logp, g
            de = torch.zeros(c, dtype=torch.float64, device=device)
            for _ in range(config.num_steps_per_sample):
                x, u, lpv, gv, d = step(x, u, lpv, gv, eps)
                de = de + d
            finite = (torch.isfinite(de) & torch.all(torch.isfinite(x), dim=1)
                      & torch.all(torch.isfinite(gv), dim=1))
            log_ratio = torch.where(finite, -de, torch.full_like(de, -torch.inf))
            alpha = torch.exp(torch.clamp(log_ratio, max=0.0))
            accept = log_u.double() < log_ratio
            theta, logp, g = _where(accept, x, theta), _where(accept, lpv, logp), _where(accept, gv, g)
            if adapt and g_idx < config.burn:
                da = da_update(da, torch.where(finite, log_ratio, torch.full_like(de, torch.nan)),
                               g_idx, desired_accept_rate=config.desired_accept_rate)
            div = div | ~finite
        samples[:, b] = theta
        stats["accept_prob"][:, b] = alpha
        stats["accepted"][:, b] = accept
        stats["energy_change"][:, b] = de
        stats["divergent"][:, b] = div
        stats["step_size"][:, b] = eps
    burn_kept = config.burn // config.thin
    kept_prob = stats["accept_prob"][:, burn_kept:] if n_kept > burn_kept else stats["accept_prob"]
    return MAMSResult(
        samples=samples, stats=MAMSStats(**stats),
        step_size=torch.exp(da.log_eps_bar) if adapt else da.step_size,
        acc_rate=kept_prob.mean(dim=1), final_theta=theta, final_da=da,
        final_step=torch.full((c,), start_step + config.num_samples, dtype=torch.int32,
                              device=device),
    )


def _unravel_result(r: MAMSResult, unravel) -> MAMSResult:
    if unravel is None:
        return r
    return r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))


def run_mams(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: MAMSConfig,
    data=None,
    init_da: DualAveragingState | None = None,
    start_step: int = 0,
    pass_grad=None,
    _noise=None,
) -> MAMSResult:
    """Metropolis-adjusted microcanonical sampling, one chain; see the
    module docstring.

    ``theta0`` may be flat (D,) or a parameter tree (samples keep leaf
    shapes); ``data=`` calls ``log_prob_fn(theta, data)``.  ``key`` is an
    integer seed; the chain runs on the device of ``theta0``.  Chunked runs
    resume bit for bit: feed ``final_theta`` / ``final_da`` /
    ``final_step`` back with the same ``config`` (post-burn draws do not
    adapt).
    """
    if start_step == 0 and config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0f, lp, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    if init_da is not None:
        init_da = DualAveragingState(**{k: torch.as_tensor(v)[None] for k, v in vars(init_da).items()})
    if _noise is not None:
        _noise = (_noise[0][:, None], _noise[1][:, None])
    r = _run_chains(key, theta0f[None], lp, config, init_da=init_da, start_step=int(start_step),
                    _noise=_noise)
    r = MAMSResult(
        samples=r.samples[0], stats=MAMSStats(*(s[0] for s in r.stats)),
        step_size=r.step_size[0], acc_rate=r.acc_rate[0], final_theta=r.final_theta[0],
        final_da=DualAveragingState(**{k: v[0] for k, v in vars(r.final_da).items()}),
        final_step=r.final_step[0],
    )
    return _unravel_result(r, unravel)


def run_mams_chains(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: MAMSConfig,
    num_chains: int,
    data=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
) -> MAMSResult:
    """Independent MAMS chains batched on a leading axis; each chain adapts
    its own step size, and every result carries the chain axis first.

    ``theta0`` may be (D,) (copied to every chain), (num_chains, D), or a
    parameter tree, single-chain (copied) or with a leading ``num_chains``
    axis on every leaf (``theta0_is_stacked`` overrides the detection).
    ``key`` is an integer seed; chain ``c`` draws from its own stream.
    """
    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    lp = _bind_data(log_prob_fn, data)
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        _, fn, unravel = _prep_flat(lp, template, None)
        theta0 = _ravel_chains(stacked)
    else:
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
        _, fn, unravel = _prep_flat(lp, theta0[0], None)
    return _unravel_result(_run_chains(key, theta0, fn, config, _noise=_noise), unravel)
