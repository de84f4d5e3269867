"""ChEES-HMC: cross-chain adaptive trajectory lengths (Hoffman, Radul &
Sountsov 2021), the ensemble alternative to NUTS.

Counterpart of ``hamiltorch_tpu/samplers/chees.py``.  Every chain of the
ensemble shares each draw's trajectory length: one jitter u ~ U(0, 1) a
draw gives the time t = u T and L = ceil(t / eps) leapfrog steps (capped at
``max_leapfrog_steps``) over the whole (C, D) block.  T adapts by Adam
ascent on the Change-in-the-Estimator-of-the-Expected-Square criterion

    ChEES = 1/4 E[ (||theta' - mu||^2 - ||theta - mu||^2)^2 ]

with a cross-chain gradient estimate, and the step size by dual averaging
toward the jittered-HMC optimum.

Where the JAX package runs a ``while_loop`` with a traced L, this module
computes ``ceil(u T / eps)`` on the chains' device in their dtype, reads it
to the host once a draw (one device-to-host sync a draw) and runs a host
loop of L batched leapfrog steps.  Every chain shares L, so no lane is
masked.  The adaptation's cross-chain sums stay on the device.

Random numbers: chain ``c``'s momentum normal and Metropolis uniform at
global draw ``n`` come from ``utils.rng.draw_noise`` (seed, chain, n); the
jitter, shared by every chain, from ``utils.rng.draw_jitter`` (seed, n), a
stream of its own (``CHEES_JITTER_STREAM``); ``trajectory_jitter="halton"``
takes the van der Corput point of the draw index instead.  A single start
is spread to the chains by ``0.01 * N(0, 1)`` from a generator seeded from
the key (``SPREAD_STREAM``).  ``_noise`` (a test hook) hands in the
momentum normals, the log Metropolis uniforms and the jitter instead.

The sharded ensemble (``parallel.sharding.run_chees_sharded``) runs this
loop on every rank's chains with ``axis_name``, a process group over which
the cross-chain sums are all-reduced, and ``chain_keys``, the chains'
global indices: each chain draws what it draws in the unsharded run, and
the jitter, keyed on the seed alone, is every rank's.  L is computed from
all-reduced values, so every rank runs the same number of leapfrog steps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.mass import DenseMass, DiagMass, make_diag_mass_tree, make_mass
from ..ops.potential import resolve_potential, value_and_grad
from ..utils.convert import place_start
from ..utils.progress import scan_progress
from ..utils.pytree import (
    is_param_tree,
    stack_param_tree,
    tree_leaves,
    tree_map,
    unravel_last_axis_fn,
)
from ..utils.rng import (
    SPREAD_STREAM,
    draw_jitter,
    draw_noise,
    draw_seed,
    keyed_chains,
)
from .adaptation import DualAveragingState, da_init, da_update
from .driver import _flat_chains, _tree_where, validate_common_config
from .nuts import BatchedMass, _t_dot, init_metric_seed, validate_trace_dtype
from .warmup import (
    WelfordCovState,
    WelfordState,
    schedule_flags,
    validate_adapt_mass,
    welford_cov_merge_batch,
    welford_merge_batch,
    windowed_step,
)

@dataclasses.dataclass(frozen=True)
class ChEESConfig:
    num_samples: int
    step_size: float = 0.1
    burn: int = 0
    init_trajectory_length: float = 1.0
    desired_accept_rate: float = 0.651  # optimal for jittered HMC
    adam_lr: float = 0.025
    max_leapfrog_steps: int = 1000
    adapt: bool = True
    # cross-chain windowed warmup: False, True / "diag" (a diagonal inverse
    # mass from Welford statistics over ALL chains, C observations a draw)
    # or "dense" (the full covariance, Chan-merged across the ensemble;
    # flat states only); honoured when burn > 0
    adapt_mass: bool | str = False
    # > 0: a progress line on the host's stdout every N draws
    progress_every: int = 0
    # "uniform": iid U(0, 1) jitter; "halton": the van der Corput base-2
    # point of the draw index (stratified, lower-variance criterion
    # gradients, the ChEES paper's choice)
    trajectory_jitter: str = "uniform"
    # thin > 1: keep every thin-th draw; num_samples counts ALL transitions
    # and must divide by thin.  A kept row carries the window's last info,
    # with divergent set if any draw of the window diverged
    thin: int = 1
    # store the kept trace in this dtype (a torch dtype NAME, e.g.
    # "bfloat16"); the chains sample in their own.  None = the state's
    trace_dtype: str | None = None

    def __post_init__(self):
        validate_common_config(self)
        validate_trace_dtype(self.trace_dtype)


def validate_chees(config: ChEESConfig, mass) -> None:
    """Reject configurations that would otherwise be silently ignored
    (shared by ``run_chees`` and ``run_chees_checkpointed``)."""
    if config.trajectory_jitter not in ("uniform", "halton"):
        raise ValueError(
            f"trajectory_jitter={config.trajectory_jitter!r}; expected "
            "'uniform' or 'halton'"
        )
    if config.thin > 1 and config.num_samples % config.thin:
        raise ValueError("num_samples must be divisible by thin")
    validate_adapt_mass(config.adapt_mass, mass)


def _vdc_base2(n: int) -> float:
    """Van der Corput base-2 radical inverse of draw ``n``: the bits of the
    uint32 ``n + 1`` reversed, scaled by 2**-32 in float32 (so that, as in
    the JAX package, a reversal of at least 2**32 - 128 rounds to 1.0).
    Returns the float32 value as a host float."""
    m = 0xFFFFFFFF
    x = (n + 1) & m
    x = ((x & 0x55555555) << 1 | (x & 0xAAAAAAAA) >> 1) & m
    x = ((x & 0x33333333) << 2 | (x & 0xCCCCCCCC) >> 2) & m
    x = ((x & 0x0F0F0F0F) << 4 | (x & 0xF0F0F0F0) >> 4) & m
    x = ((x & 0x00FF00FF) << 8 | (x & 0xFF00FF00) >> 8) & m
    x = (x << 16 | x >> 16) & m
    return float(np.float32(x) * np.float32(2.0**-32))


class ChEESInfo(NamedTuple):
    accept_prob: torch.Tensor  # (N, C)
    trajectory_length: torch.Tensor  # (N,)
    num_leapfrog: torch.Tensor  # (N,) int32
    step_size: torch.Tensor  # (N,)
    divergent: torch.Tensor  # (N, C)


class ChEESCarry(NamedTuple):
    """Everything a resumed run needs to continue the adaptation schedule
    (Welford mass window, Adam trajectory state, dual averaging) where a
    previous chunk stopped."""

    thetas: object  # (C, D), or a tree of (C, ...) leaves
    logps: torch.Tensor  # (C,)
    grads: object
    da: DualAveragingState
    log_t: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    wf_count: torch.Tensor
    wf_mean: torch.Tensor
    wf_m2: torch.Tensor  # (D,) diagonal warmup; (D, D) dense warmup
    # the adapted metric: the inverse-mass diagonal, or the (inv_mass,
    # chol_mass) pair under adapt_mass="dense"
    metric: object
    da_t: torch.Tensor


class ChEESResult(NamedTuple):
    samples: object  # (C, N, D), or a tree of (C, N, ...) leaves
    info: ChEESInfo
    final_step_size: torch.Tensor
    final_trajectory_length: torch.Tensor
    final_carry: ChEESCarry


def _leapfrog_count(q: float, cap: int) -> int:
    """``min(max(1, int32(q)), cap)`` of the host value ``q = ceil(t / eps)``,
    as XLA converts it (NaN to 0, saturating)."""
    if q != q:
        return 1
    if q >= cap:
        return cap
    return max(1, int(q))


def _batched_leapfrog(vg_batch, velocity, thetas, ps, logps, grads, eps, num_steps: int):
    """``num_steps`` leapfrog steps on every chain at once; the state is a
    (C, D) block or a tree of (C, ...) leaves updated in their own shapes
    (the JAX package's ``_batched_leapfrog`` and ``_batched_leapfrog_tree``)."""
    p = tree_map(lambda pl, gl: pl + 0.5 * eps * gl, ps, grads)
    th, logp, g = thetas, logps, grads
    for _ in range(num_steps):
        th = tree_map(lambda tl, vl: tl + eps * vl, th, velocity(p))
        logp, g = vg_batch(th)
        p = tree_map(lambda pl, gl: pl + eps * gl, p, g)
    p = tree_map(lambda pl, gl: pl - 0.5 * eps * gl, p, g)
    return th, p, logp, g


def _draw_ops(mass, metric, is_tree: bool, windowed: bool, dense: bool):
    """(sample, velocity) of the draw's metric over every chain: ``sample``
    maps the flat (C, D) normal to momenta (split into the leaves for a
    tree), ``velocity`` momenta to M^-1 p."""
    if dense:
        op = DenseMass(inv_mass=metric[0], chol_mass=metric[1])
    elif windowed:
        op = DiagMass(inv_diag=metric)
    else:
        op = mass.inner if is_tree else mass
    batched = BatchedMass(lambda _: op, None, per_chain=False)
    if not is_tree:
        return batched.sample, batched.velocity
    # leafwise velocity: the draw's diagonal in parameter-shaped leaves
    unflat = unravel_last_axis_fn(mass.template)
    if windowed:
        inv_tree = unflat(metric)
    else:
        inv_tree = mass.inv_diag_tree  # None: the identity

    def velocity(p):
        if inv_tree is None:
            return p
        return tree_map(lambda iv, x: iv * x, inv_tree, p)

    # momenta are drawn flat and split into leaves: the tree path draws what
    # the flat path draws
    return (lambda z: unflat(batched.sample(z))), velocity


def init_chees_carry(theta0s, logps, grads, config: ChEESConfig, mass) -> ChEESCarry:
    """The carry a run starts from: the chains with their potential
    evaluations, dual averaging at ``config.step_size``, log T at
    ``init_trajectory_length``, Adam at zero and the warmup seeded from the
    user's mass (shared with ``run_chees_checkpointed``: a resumed run must
    adapt from the metric a straight run adapts from)."""
    leaves = tree_leaves(theta0s)
    dtype, device = leaves[0].dtype, leaves[0].device
    d = sum(leaf[0].numel() for leaf in leaves)
    dense = bool(config.adapt_mass) and config.burn > 0 and config.adapt_mass == "dense"
    seed_mass = mass.inner if is_param_tree(theta0s) else mass
    wf0, metric0 = init_metric_seed(seed_mass, d, dtype, dense, device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return ChEESCarry(
        thetas=theta0s, logps=logps, grads=grads,
        da=da_init(config.step_size, dtype=dtype, device=device),
        log_t=torch.log(torch.tensor(config.init_trajectory_length, dtype=dtype, device=device)),
        adam_m=zero, adam_v=zero, wf_count=wf0.count, wf_mean=wf0.mean, wf_m2=wf0.m2,
        metric=metric0, da_t=torch.zeros((), dtype=torch.int32, device=device),
    )


def _run_chees(key, theta0s, log_prob_fn, config: ChEESConfig, mass, init_carry=None,
               start_iter: int = 0, collect_flags=None, end_flags=None, chain_keys=None,
               axis_name=None, _noise=None) -> ChEESResult:
    """One ChEES run over the chains on the leading axis of ``theta0s`` (a
    (C, D) block or a tree of (C, ...) leaves).

    ``init_carry`` / ``start_iter`` and this run's slice of the warmup
    schedule (numpy ``collect_flags`` / ``end_flags``; by default the
    draws' slice of the global schedule) continue an earlier chunk exactly.
    ``_noise = (z (S, C, D), log_u (S, C), u (S,))`` replaces the drawn
    momentum normals, log Metropolis uniforms and (uniform) jitter.

    ``axis_name``: the ensemble extends over the ranks of a process group
    (``parallel.sharding.resolve_group``) and every cross-chain reduction
    (ensemble mean, criterion gradient, acceptance average, Welford merge)
    is summed over it; ``chain_keys`` are then the batch's global chain
    indices (``parallel.sharding.derive_chain_keys``).
    """
    vg_batch = torch.func.vmap(value_and_grad(log_prob_fn))
    is_tree = is_param_tree(theta0s)
    leaves0 = tree_leaves(theta0s)
    c, dtype, device = leaves0[0].shape[0], leaves0[0].dtype, leaves0[0].device
    d = sum(leaf[0].numel() for leaf in leaves0)
    c_total = torch.tensor(float(c), dtype=dtype, device=device)
    if axis_name is None:
        def gsum(x):
            return x.sum(dim=0)
    else:
        from ..parallel.sharding import group_sum, resolve_group

        group = resolve_group(axis_name)
        c_total = group_sum(c_total, group)

        def gsum(x):
            return group_sum(x.sum(dim=0), group)
    windowed = bool(config.adapt_mass) and config.burn > 0
    dense = windowed and config.adapt_mass == "dense"
    if collect_flags is None:
        collect_flags, end_flags = schedule_flags(config.burn if windowed else 0, start_iter,
                                                  config.num_samples)

    if init_carry is None:
        init_carry = init_chees_carry(theta0s, *vg_batch(theta0s), config, mass)
    cy = init_carry
    thetas, logps, grads, da, log_t = cy.thetas, cy.logps, cy.grads, cy.da, cy.log_t
    adam_m, adam_v, metric, da_t = cy.adam_m, cy.adam_v, cy.metric, cy.da_t
    wf = (WelfordCovState if dense else WelfordState)(cy.wf_count, cy.wf_mean, cy.wf_m2)

    thin = max(config.thin, 1)
    kept = config.num_samples // thin
    cap = config.max_leapfrog_steps
    adapt = config.adapt and config.burn > 0
    halton = config.trajectory_jitter == "halton"
    trace_dtype = None if config.trace_dtype is None else getattr(torch, config.trace_dtype)
    samples = tree_map(
        lambda leaf: torch.empty((c, kept) + tuple(leaf.shape[1:]),
                                 dtype=trace_dtype or leaf.dtype, device=device), thetas)
    accept_buf = torch.empty((kept, c), dtype=dtype, device=device)
    div_buf = torch.empty((kept, c), dtype=torch.bool, device=device)
    traj_buf = torch.empty((kept,), dtype=dtype, device=device)
    step_buf = torch.empty((kept,), dtype=dtype, device=device)
    leapfrogs = []
    progress = (scan_progress(config.num_samples, config.progress_every)
                if config.progress_every > 0 else None)

    for b in range(kept):
        div_any = torch.zeros(c, dtype=torch.bool, device=device)
        for j in range(thin):
            i = b * thin + j
            n = start_iter + i
            if progress is not None:
                progress(i)  # the bar is sized per run, not global
            sample, velocity = _draw_ops(mass, metric, is_tree, windowed, dense)

            def kinetic(p, velocity=velocity):
                return 0.5 * _t_dot(p, velocity(p))

            if _noise is None:
                with keyed_chains(chain_keys, c):
                    z, log_u = draw_noise(key, n, c, d, dtype, device)
                u = None if halton else torch.tensor(draw_jitter(key, n), dtype=dtype,
                                                     device=device)
            else:
                z, log_u, u = _noise[0][i], _noise[1][i], _noise[2][i]
            if halton:
                u = torch.tensor(_vdc_base2(n), dtype=dtype, device=device)
            # one shared L for every chain, read once a draw (the sync)
            traj_t = u * torch.exp(log_t)
            eps = da.step_size
            num_steps = _leapfrog_count(float(torch.ceil(traj_t / eps)), cap)

            ps = sample(z)
            h0 = -logps + kinetic(ps)
            th_new, p_new, logp_new, grad_new = _batched_leapfrog(
                vg_batch, velocity, thetas, ps, logps, grads, eps, num_steps)
            h1 = -logp_new + kinetic(p_new)
            log_ratio = h0 - h1
            finite = torch.isfinite(log_ratio)
            zeros = torch.zeros_like(log_ratio)
            alpha = torch.where(finite, torch.exp(torch.clamp(log_ratio, max=0.0)), zeros)
            accept = finite & (log_u < log_ratio)
            thetas_out = _tree_where(accept, th_new, thetas)
            grads_out = _tree_where(accept, grad_new, grads)
            logps_out = torch.where(accept, logp_new, logps)
            # the values this draw used (pre-update)
            info_step_size, info_traj_len = eps, torch.exp(log_t)

            # adaptation needs a warmup phase; with burn <= 0 the freeze at
            # n == burn would clobber the step size with exp(log_eps_bar) = 1
            if adapt and n < config.burn:
                # the ChEES gradient with respect to the trajectory time
                mu = tree_map(lambda leaf: gsum(leaf) / c_total, thetas_out)
                diff_new = tree_map(lambda a, m: a - m, th_new, mu)
                diff_old = tree_map(lambda a, m: a - m, thetas, mu)
                dsq_new, dsq_old = _t_dot(diff_new, diff_new), _t_dot(diff_old, diff_old)
                v_end = velocity(p_new)  # d theta'/dt at the endpoint
                per_chain = (dsq_new - dsq_old) * _t_dot(diff_new, v_end)
                alpha_sum = gsum(alpha)
                w = alpha / torch.clamp(alpha_sum, min=1e-6)
                # per_chain is fourth order in theta: a chain far out but
                # finite can overflow it, and one inf gradient would make
                # Adam's v inf and log T NaN for the rest of the run.  Mask
                # non-finite contributions and bound the total (Adam
                # normalises by sqrt(v): the clip caps the transient only)
                contrib = torch.where(finite, w * per_chain, zeros)
                contrib = torch.where(torch.isfinite(contrib), contrib, zeros)
                grad_log_t = torch.clamp(traj_t * gsum(contrib), -1e6, 1e6)

                t1 = torch.tensor(n + 1, dtype=dtype, device=device)
                adam_m = 0.9 * adam_m + 0.1 * grad_log_t
                adam_v = 0.999 * adam_v + 0.001 * grad_log_t**2
                m_hat = adam_m / (1.0 - 0.9**t1)
                v_hat = adam_v / (1.0 - 0.999**t1)
                log_t_new = log_t + config.adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
                # keep trajectories sane: T in [eps, eps * max_leapfrog_steps]
                log_t = torch.clamp(log_t_new, torch.log(eps), torch.log(eps * cap))

                # windowed warmup counts dual averaging from the last window end
                da = da_update(
                    da, torch.log(torch.clamp(alpha_sum / c_total, min=1e-10)),
                    da_t if windowed else n, desired_accept_rate=config.desired_accept_rate)
            elif adapt and n == config.burn:
                da = dataclasses.replace(da, step_size=torch.exp(da.log_eps_bar))

            window_end = bool(end_flags[i])
            if windowed:
                if bool(collect_flags[i]):
                    merge = welford_cov_merge_batch if dense else welford_merge_batch
                    wf = merge(wf, _flat_chains(thetas_out), gsum=gsum, count=c_total)
                wf, metric, da = windowed_step(wf, metric, da, window_end, dense)
            da_t = torch.zeros_like(da_t) if window_end else da_t + 1
            thetas, logps, grads = thetas_out, logps_out, grads_out
            div_any |= ~finite

        tree_map(lambda buf, t: buf[:, b].copy_(t), samples, thetas)
        accept_buf[b] = alpha
        div_buf[b] = div_any
        traj_buf[b] = info_traj_len
        step_buf[b] = info_step_size
        leapfrogs.append(num_steps)

    if progress is not None:
        progress.end()
    info = ChEESInfo(accept_prob=accept_buf, trajectory_length=traj_buf,
                     num_leapfrog=torch.tensor(leapfrogs, dtype=torch.int32, device=device),
                     step_size=step_buf, divergent=div_buf)
    return ChEESResult(
        samples=samples,
        info=info,
        final_step_size=da.step_size,
        final_trajectory_length=torch.exp(log_t),
        final_carry=ChEESCarry(
            thetas=thetas, logps=logps, grads=grads, da=da, log_t=log_t, adam_m=adam_m,
            adam_v=adam_v, wf_count=wf.count, wf_mean=wf.mean, wf_m2=wf.m2, metric=metric,
            da_t=da_t),
    )


def prepare_chees(key, theta0, config: ChEESConfig, num_chains: int, inv_mass=None,
                  theta0_is_stacked: bool | None = None):
    """(theta0s with a leading chain axis, validated mass) of a ChEES entry;
    shared with ``run_chees_checkpointed``.  A single start (a (D,) vector
    or an unstacked tree) is spread to ``num_chains`` copies by ``0.01 *
    N(0, 1)`` from a generator seeded by ``draw_seed(key, 0,
    SPREAD_STREAM)``; a stacked start is taken as it is."""
    from .hmc import _as_like

    theta0 = place_start(theta0)
    spread = draw_seed(key, 0, SPREAD_STREAM)
    if is_param_tree(theta0):
        stacked = theta0_is_stacked
        if stacked is None:
            stacked = all(leaf.shape[:1] == (num_chains,) for leaf in tree_leaves(theta0))
        template, theta0s = stack_param_tree(theta0, num_chains, key=spread,
                                             noise=0.0 if stacked else 0.01, stacked=stacked)
        mass = make_diag_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]), template,
                                   "ChEES ensembles",
                                   dense_requested=config.adapt_mass == "dense")
        validate_chees(config, mass.inner)
        return theta0s, mass
    theta0s = theta0
    if theta0.ndim == 1:
        # a small spread so that the ensemble mean and criterion are
        # informative from the start
        _, theta0s = stack_param_tree(theta0, num_chains, key=spread, noise=0.01, stacked=False)
    mass = make_mass(_as_like(inv_mass, theta0s), theta0s.shape[-1])
    validate_chees(config, mass)
    return theta0s, mass


def run_chees(
    key: int,
    log_prob_fn,
    theta0,
    config: ChEESConfig,
    num_chains: int = 16,
    inv_mass=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
) -> ChEESResult:
    """ChEES-HMC over a chain ensemble; needs ``num_chains`` >= ~8 for a
    stable cross-chain criterion gradient.

    ``theta0`` may be a flat (D,) vector (spread to the chains) or a (C, D)
    block, or a parameter tree, single-chain (spread) or with a leading
    ``num_chains`` axis on every leaf (``theta0_is_stacked`` overrides the
    detection).  With a tree the leapfrog updates leaves in their own
    shapes, ``samples`` is a tree of (C, N, ...) leaves, and ``inv_mass``
    may be None, a flat (D,) diagonal or a matching tree of diagonals;
    dense and block metrics and ``adapt_mass="dense"`` take the flat path.
    ``samples`` is (C, N, D) chain-major; ``info`` is draw-major, (N, C)
    per chain and (N,) for the shared step size, trajectory length and
    leapfrog count.  ``key`` is an integer seed; the chains run on the
    device of ``theta0`` (the card for a start that is not a tensor).
    ``_noise``: see :func:`_run_chees` (a test hook).
    """
    lp = resolve_potential(log_prob_fn, None)
    theta0s, mass = prepare_chees(key, theta0, config, num_chains, inv_mass, theta0_is_stacked)
    return _run_chees(key, theta0s, lp, config, mass, _noise=_noise)
