"""Parallel tempering (replica exchange) HMC for multimodal posteriors.

Counterpart of ``hamiltorch_tpu/samplers/tempering.py``.  K replicas at
inverse temperatures beta_k (a geometric ladder from 1 down to 1/max_temp)
each take one HMC step on the tempered potential beta_k * logp with step
size eps / sqrt(beta_k) (kick scale eps * beta_k); then adjacent pairs swap
states with probability min(1, exp((beta_a - beta_b)(logp_b - logp_a))),
alternating the even and odd pairings with the parity of the GLOBAL draw
index.  The cached untempered log-probabilities and gradients move with
the states; the step sizes belong to the temperature slots and stay.

Ladder adaptation (``adapt_ladder``): during burn the log temperature gaps
S_i = log(T_{i+1} - T_i) move by kappa(n) (A_i - mean(A)), A an EMA of each
pair's swap acceptance, renormalised so that both ends stay pinned
(``betas_from_log_gaps``).  Step-size adaptation (``adapt_step_size``): dual
averaging per temperature slot while n < burn, frozen to the averaged step
at n == burn.

The replica axis is one batch axis: every replica's leapfrog step is one
``torch.func.vmap``-ed value and gradient over the ladder, and
``run_pt_chains`` runs its E ladders as ONE batch of E*K lanes (one vmapped
value and gradient a leapfrog step); swaps stay inside each ladder (the
gather indices are offset by e*K).  States are flat (K, D) blocks or trees
of (K, ...) leaves.

Random numbers: at global draw n, ladder e draws its replicas' momentum
normals, Metropolis uniforms and swap uniforms from one generator keyed on
(seed, e, ``PT_STREAM`` + n) (``utils.rng.draw_ladder_noise``), so chunked
runs reproduce the straight run bit for bit.  ``_noise`` (a test hook) hands
in ``{"z": (S, [E,] K, D), "u_mh": (S, [E,] K), "u_swap": (S, [E,] K)}``
instead; one swap uniform serves each pair (the lower index's).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.mass import make_diag_mass_tree, make_mass
from ..ops.potential import resolve_potential, value_and_grad
from ..utils.convert import place_start
from ..utils.progress import scan_progress
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from ..utils.rng import PT_STREAM, chain_ids, draw_ladder_noise
from .adaptation import DualAveragingState, da_update
from .driver import _tree_where, validate_common_config
from .hmc import _as_like


@dataclasses.dataclass(frozen=True)
class PTConfig:
    num_samples: int  # total transitions, INCLUDING the first `burn` dropped
    num_steps_per_sample: int = 10
    step_size: float = 0.1
    num_temps: int = 8
    max_temp: float = 30.0
    burn: int = 0  # dropped from returned samples/stats; adaptation window
    adapt_ladder: bool = False  # swap-rate-equalising ladder (see module docstring)
    ladder_t0: float = 10.0  # adaptation-decay offset kappa = t0/(nu(n+t0))
    ladder_nu: float = 1.0
    # per-slot dual averaging of the step size during burn, frozen to the
    # averaged step after; seeded from eps * sqrt(T_k)
    adapt_step_size: bool = False
    desired_accept_rate: float = 0.8
    # > 0: a progress line on the host's stdout every N draws
    progress_every: int = 0

    def __post_init__(self):
        validate_common_config(self)


class PTInfo(NamedTuple):
    accept_prob: torch.Tensor  # (N, K) per-replica HMC acceptance
    swap_accept: torch.Tensor  # (N, K-1) adjacent-pair swap outcomes (bool)
    betas: torch.Tensor  # (K,) final ladder (adapted when adapt_ladder)
    swap_rate_ema: torch.Tensor  # (K-1,) final per-pair swap-acceptance EMA
    step_sizes: torch.Tensor  # (K,) final per-replica steps


class PTResult(NamedTuple):
    samples: object  # (N - burn, D): the cold (beta=1) chain
    replica_samples: object  # (N - burn, K, D): the full ladder
    info: PTInfo
    final_carry: "PTCarry | None" = None  # resume state (see checkpoint.py)


class PTCarry(NamedTuple):
    """Full resume state of a tempering run (a ladder, or E ladders with a
    leading ensemble axis on every field)."""

    thetas: object  # (K, D) replica positions, or a tree of (K, ...) leaves
    logps: torch.Tensor  # (K,) cached UNtempered log-probs
    grads: object  # (K, D) cached gradients
    s: torch.Tensor  # (K-1,) log temperature gaps (ladder parameterisation)
    ema: torch.Tensor  # (K-1,) per-pair swap-acceptance EMA
    # per-slot dual-averaging state ((K,) fields); step sizes belong to
    # TEMPERATURE SLOTS, not chain states: they do not move on swaps
    da: DualAveragingState


def check_num_temps(theta0: torch.Tensor, config: PTConfig) -> None:
    """A 2-d/3-d theta0's replica axis must agree with config.num_temps;
    otherwise the array shape would silently override the configured ladder."""
    if theta0.ndim >= 2 and theta0.shape[-2] != config.num_temps:
        raise ValueError(
            f"theta0 provides {theta0.shape[-2]} replicas but "
            f"config.num_temps={config.num_temps}; the replica axis sets the "
            "ladder size — make them agree."
        )


_tmap = tree_map


def _rbcast(v, leaf):
    """(K,) replica vector broadcast against a (K, ...) leaf."""
    return v.reshape((v.shape[0],) + (1,) * (leaf.ndim - 1))


# per-replica select broadcast over each leaf's parameter dims
_r_where = _tree_where


def _check_tree_num_temps(theta0s, config: PTConfig) -> None:
    """Tree analogue of :func:`check_num_temps`."""
    k = tree_leaves(theta0s)[0].shape[0]
    if k != config.num_temps:
        raise ValueError(
            f"theta0 provides {k} replicas but config.num_temps="
            f"{config.num_temps}; the replica axis sets the ladder size — "
            "make them agree (theta0_is_stacked=False broadcasts a single "
            "state instead)."
        )


def betas_from_log_gaps(s: torch.Tensor, max_temp: float) -> torch.Tensor:
    """Ladder parameterisation: log temperature gaps S_i = log(T_{i+1}-T_i),
    renormalised so T_0 = 1 and T_{K-1} = max_temp stay pinned.  Returns
    inverse temperatures (K,), or (E, K) for (E, K-1) gaps."""
    g = torch.exp(s)
    zero = torch.zeros(s.shape[:-1] + (1,), dtype=s.dtype, device=s.device)
    temps = 1.0 + torch.cat([zero, torch.cumsum(g, dim=-1)], dim=-1) * (
        (max_temp - 1.0) / torch.sum(g, dim=-1, keepdim=True))
    return 1.0 / temps


def swap_partners(k: int, device) -> dict:
    """Per draw parity (0 even, 1 odd): ``(partner, pair_lo, attempted)``,
    each replica's partner, the lower index of its pair (whose uniform the
    pair uses) and which adjacent pairs (i, i+1) are attempted, as (K,),
    (K,) and (K-1,) tensors on ``device``."""
    idx = np.arange(k)
    even = np.clip(np.where(idx % 2 == 0, idx + 1, idx - 1), 0, k - 1)
    odd = np.where(idx % 2 == 1, idx + 1, idx - 1)
    odd[0] = 0
    if k % 2 == 0:
        odd[-1] = k - 1
    odd = np.clip(odd, 0, k - 1)
    out = {}
    for parity, partner in ((0, even), (1, odd)):
        out[parity] = (torch.as_tensor(partner, device=device),
                       torch.as_tensor(np.minimum(idx, partner), device=device),
                       torch.as_tensor(partner[:-1] == idx[:-1] + 1, device=device))
    return out


def _map_carry(fn, carry: PTCarry) -> PTCarry:
    da = carry.da
    return PTCarry(tree_map(fn, carry.thetas), fn(carry.logps), tree_map(fn, carry.grads),
                   fn(carry.s), fn(carry.ema),
                   DualAveragingState(*(fn(t) for t in (da.step_size, da.log_eps_bar, da.h_t,
                                                        da.mu))))


def init_pt_carry(log_prob_fn, theta0s, config: PTConfig, ensembles: int | None = None
                  ) -> PTCarry:
    """The carry a run starts from: the replicas with their potential
    evaluations, the geometric ladder's log gaps, the EMA at 0.5 and dual
    averaging seeded from eps * sqrt(T_k).  With ``ensembles=E`` the
    replicas carry a leading (E, K) and every field a leading E axis."""
    leaf0 = tree_leaves(theta0s)[0]
    lead = 1 if ensembles is None else 2
    k, dtype, device = leaf0.shape[lead - 1], leaf0.dtype, leaf0.device
    temps_geo = torch.exp(torch.linspace(0.0, float(np.log(config.max_temp)), k,
                                         dtype=torch.float64)).to(dtype=dtype, device=device)
    lanes = tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[lead:])), theta0s)
    logps, grads = torch.func.vmap(value_and_grad(log_prob_fn))(lanes)
    e = 1 if ensembles is None else ensembles
    eps0 = config.step_size * torch.sqrt(temps_geo)
    carry = PTCarry(
        thetas=tree_map(lambda t: t.reshape((e,) + tuple(t.shape[lead - 1:])), theta0s),
        logps=logps.reshape(e, k),
        grads=tree_map(lambda g: g.reshape((e, k) + tuple(g.shape[1:])), grads),
        s=torch.log(torch.diff(temps_geo)).expand(e, k - 1).clone(),
        ema=torch.full((e, k - 1), 0.5, dtype=dtype, device=device),
        da=DualAveragingState(
            step_size=eps0.expand(e, k).clone(),
            log_eps_bar=torch.zeros((e, k), dtype=dtype, device=device),
            h_t=torch.zeros((e, k), dtype=dtype, device=device),
            mu=torch.log(10.0 * eps0).expand(e, k).clone(),
        ),
    )
    return carry if ensembles is not None else _map_carry(lambda t: t[0], carry)


def _run_pt(key: int, theta0s, log_prob_fn, config: PTConfig, mass, init_carry=None,
            start_iter: int = 0, ensembles: int | None = None, _noise=None, _margins=None):
    """``config.num_samples`` tempering draws; returns ``(traj, alphas,
    swaps, final_carry)`` with the full (unburned) trajectory, (N, K, ...)
    or, with ``ensembles=E``, (E, N, K, ...) and a leading E on the rest.

    ``init_carry`` / ``start_iter`` continue an earlier chunk exactly (the
    global draw index keys the noise and the pairing parity).  ``_margins``
    (a test hook), when a list, receives each draw's least distance of a
    Metropolis or swap decision from its other outcome.
    """
    e = 1 if ensembles is None else ensembles
    if init_carry is None:
        init_carry = init_pt_carry(log_prob_fn, theta0s, config, ensembles)
    cy = init_carry if ensembles is not None else _map_carry(lambda t: t.unsqueeze(0),
                                                             init_carry)
    leaf0 = tree_leaves(cy.thetas)[0]
    k, dtype, device = leaf0.shape[1], leaf0.dtype, leaf0.device
    d = sum(leaf[0, 0].numel() for leaf in tree_leaves(cy.thetas))

    def lanes(tree):  # (E, K, ...) -> (E*K, ...)
        return tree_map(lambda t: t.reshape((e * k,) + tuple(t.shape[2:])), tree)

    def ladders(tree):  # (E*K, ...) -> (E, K, ...)
        return tree_map(lambda t: t.reshape((e, k) + tuple(t.shape[1:])), tree)

    vg = torch.func.vmap(value_and_grad(log_prob_fn))
    sample = torch.func.vmap(mass.sample)
    velocity = torch.func.vmap(mass.velocity)
    kinetic = torch.func.vmap(mass.kinetic)
    maps = swap_partners(k, device)
    idx = torch.arange(k, device=device)
    offsets = (torch.arange(e, device=device) * k)[:, None]

    thetas, logps, grads = lanes(cy.thetas), cy.logps.reshape(-1), lanes(cy.grads)
    s, ema, da = cy.s, cy.ema, cy.da
    num = config.num_samples
    traj = tree_map(lambda t: torch.empty((e, num) + tuple(t.shape[1:]), dtype=t.dtype,
                                          device=device), cy.thetas)
    alphas = torch.empty((e, num, k), dtype=dtype, device=device)
    swaps = torch.empty((e, num, k - 1), dtype=torch.bool, device=device)
    progress = (scan_progress(num, config.progress_every) if config.progress_every > 0
                else None)

    for i in range(num):
        n = start_iter + i
        if progress is not None:
            progress(i)  # the bar is sized per run, not global
        betas = betas_from_log_gaps(s, config.max_temp)  # (E, K)
        b = betas.reshape(-1)
        eps_k = (da.step_size.reshape(-1) if config.adapt_step_size
                 else config.step_size / torch.sqrt(b))
        if _noise is None:
            drawn = [draw_ladder_noise(key, n, ens, k, d, PT_STREAM, dtype, device)
                     for ens in chain_ids(e)]
            z = torch.cat([dr[0] for dr in drawn])
            u_mh = torch.cat([dr[1] for dr in drawn])
            u_swap = torch.stack([dr[2] for dr in drawn])
        else:
            z = _noise["z"][i].reshape(e * k, d)
            u_mh, u_swap = _noise["u_mh"][i].reshape(-1), _noise["u_swap"][i].reshape(e, k)

        # --- one tempered HMC transition per replica (batched) -----------
        ps = sample(z)
        h0 = -b * logps + kinetic(ps)
        eb = eps_k * b  # per-replica tempered kick scale
        p = tree_map(lambda pl, gl: pl + 0.5 * _rbcast(eb, pl) * gl, ps, grads)
        th, lgp, g = thetas, logps, grads
        for _ in range(config.num_steps_per_sample):
            th = tree_map(lambda tl, vl: tl + _rbcast(eps_k, tl) * vl, th, velocity(p))
            lgp, g = vg(th)
            p = tree_map(lambda pl, gl: pl + _rbcast(eb, pl) * gl, p, g)
        p = tree_map(lambda pl, gl: pl - 0.5 * _rbcast(eb, pl) * gl, p, g)
        h1 = -b * lgp + kinetic(p)
        log_ratio = h0 - h1
        finite = torch.isfinite(log_ratio)
        alpha = torch.where(finite, torch.exp(torch.clamp(log_ratio, max=0.0)),
                            torch.zeros_like(log_ratio))
        log_u = torch.log(u_mh)
        accept = finite & (log_u < log_ratio)
        thetas = _r_where(accept, th, thetas)
        logps = torch.where(accept, lgp, logps)
        grads = _r_where(accept, g, grads)

        if config.adapt_step_size and config.burn > 0:
            # per-slot dual averaging on THIS draw's (pre-swap) acceptance
            if n < config.burn:
                lar = torch.where(finite, log_ratio, torch.full_like(log_ratio, float("nan")))
                da = da_update(da, lar.reshape(e, k), n,
                               desired_accept_rate=config.desired_accept_rate)
            elif n == config.burn:
                da = dataclasses.replace(da, step_size=torch.exp(da.log_eps_bar))

        # --- replica exchange: alternate even/odd adjacent pairings -------
        partner, pair_lo, attempted = maps[n % 2]
        lps = logps.reshape(e, k)
        log_swap = (betas - betas[:, partner]) * (lps[:, partner] - lps)
        log_u_pair = torch.log(u_swap[:, pair_lo])
        paired = partner != idx
        do_swap = paired & (log_u_pair < log_swap)
        src = (torch.where(do_swap, partner, idx) + offsets).reshape(-1)
        thetas = tree_map(lambda t: t[src], thetas)
        logps = logps[src]
        grads = tree_map(lambda t: t[src], grads)
        swap_mask = do_swap[:, :-1] & attempted
        if _margins is not None:
            inf = torch.full_like(log_ratio, float("inf"))
            m_mh = torch.where(finite, (log_u - log_ratio).abs(), inf).min()
            m_sw = torch.where(paired & torch.isfinite(log_swap), (log_u_pair - log_swap).abs(),
                               inf.reshape(e, k)).min()
            _margins.append(torch.minimum(m_mh, m_sw))

        if config.adapt_ladder and config.burn > 0:
            alpha_pair = torch.exp(torch.clamp(log_swap[:, :-1], max=0.0))
            alpha_pair = torch.where(torch.isfinite(alpha_pair), alpha_pair,
                                     torch.zeros_like(alpha_pair))
            ema = torch.where(attempted, 0.9 * ema + 0.1 * alpha_pair, ema)
            kappa = config.ladder_t0 / (config.ladder_nu * (
                torch.tensor(n, dtype=dtype, device=device) + 1.0 + config.ladder_t0))
            ds = kappa * (ema - torch.mean(ema, dim=-1, keepdim=True))
            if n < config.burn:
                s = s + ds

        tree_map(lambda buf, t: buf[:, i].copy_(t), traj, ladders(thetas))
        alphas[:, i] = alpha.reshape(e, k)
        swaps[:, i] = swap_mask

    if progress is not None:
        progress.end()
    carry = PTCarry(ladders(thetas), logps.reshape(e, k), ladders(grads), s, ema, da)
    if ensembles is None:
        return tree_map(lambda t: t[0], traj), alphas[0], swaps[0], _map_carry(
            lambda t: t[0], carry)
    return traj, alphas, swaps, carry


def prepare_pt(theta0, config: PTConfig, inv_mass=None, theta0_is_stacked: bool | None = None):
    """(theta0s with a leading replica axis, validated mass) of a single
    ladder; shared with ``run_pt_checkpointed``.  A tree takes diagonal
    metrics only (a per-leaf or flat diagonal, or None)."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, theta0s = stack_param_tree(theta0, config.num_temps,
                                             stacked=theta0_is_stacked)
        _check_tree_num_temps(theta0s, config)
        return theta0s, make_diag_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]),
                                            template, "parallel tempering")
    theta0s = theta0
    if theta0.ndim == 1:
        theta0s = theta0.unsqueeze(0).expand((config.num_temps,) + tuple(theta0.shape)).clone()
    check_num_temps(theta0s, config)
    return theta0s, make_mass(_as_like(inv_mass, theta0s), theta0s.shape[-1])


def run_parallel_tempering(
    key: int,
    log_prob_fn,
    theta0,
    config: PTConfig,
    inv_mass=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
    _margins=None,
) -> PTResult:
    """Replica-exchange HMC; returns the cold chain plus the full ladder.

    ``config.burn`` draws are dropped from the returned samples and stats
    (and bound the adaptation window).  ``theta0`` is a flat (D,) state
    (copied to every replica) or a (K, D) block, or a parameter tree, single
    or with a leading K axis on every leaf (``theta0_is_stacked`` overrides
    the detection).  ``key`` is an integer seed; the ladder runs on the
    device of ``theta0`` (the card for a start that is not a tensor).
    ``_noise`` / ``_margins``: see :func:`_run_pt` (test hooks)."""
    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0s, mass = prepare_pt(theta0, config, inv_mass, theta0_is_stacked)
    lp = resolve_potential(log_prob_fn, None)
    traj, alphas, swaps, carry = _run_pt(key, theta0s, lp, config, mass, _noise=_noise,
                                         _margins=_margins)
    return assemble_pt_result(traj, alphas, swaps, carry, config)


def assemble_pt_result(traj, alphas, swaps, carry_f: PTCarry, config: PTConfig) -> PTResult:
    """Burn-slice a (possibly chunk-concatenated) trajectory into a PTResult."""
    burn = max(config.burn, 0)
    return PTResult(
        samples=_tmap(lambda t: t[burn:, 0], traj),  # cold (beta=1) chain
        replica_samples=_tmap(lambda t: t[burn:], traj),
        info=PTInfo(
            accept_prob=alphas[burn:],
            swap_accept=swaps[burn:],
            betas=betas_from_log_gaps(carry_f.s, config.max_temp),
            swap_rate_ema=carry_f.ema,
            step_sizes=carry_f.da.step_size,
        ),
        final_carry=carry_f,
    )


def run_pt_chains(
    key: int,
    log_prob_fn,
    theta0,
    config: PTConfig,
    num_ensembles: int,
    inv_mass=None,
    _noise=None,
    _margins=None,
) -> PTResult:
    """``num_ensembles`` independent replica-exchange ladders, run as ONE
    batch of E*K lanes (one vmapped value and gradient a leapfrog step).

    Returns a PTResult with a leading ensemble axis: ``samples`` (E, N -
    burn, D) cold chains, ``replica_samples`` (E, N - burn, K, D),
    per-ensemble info and carries.  A single state broadcasts to every
    (ensemble, replica) slot; (K, ...) states broadcast over the ensembles;
    (E, K, ...) states are taken as they are (trees likewise, leaf by leaf).
    Ensemble e draws the noise a single ladder run with the same key draws
    as ladder e (ensemble 0 is ``run_parallel_tempering``'s ladder).
    """
    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0s, mass = _pt_ensemble_stack(theta0, config, num_ensembles, inv_mass)
    lp = resolve_potential(log_prob_fn, None)
    traj, alphas, swaps, carry = _run_pt(key, theta0s, lp, config, mass,
                                         ensembles=num_ensembles, _noise=_noise,
                                         _margins=_margins)
    return assemble_pt_ensemble_result(traj, alphas, swaps, carry, config)


def _pt_ensemble_stack(theta0, config: PTConfig, num_ensembles: int, inv_mass):
    """(stacked theta0, mass) for an (E, K, ...) PT ensemble entry, shared
    by ``run_pt_chains`` and the checkpointed ensembles.  Flat theta0 gives
    an (E, K, D) block with any mass form; a tree gives (E, K, ...) leaves
    with diagonal metrics only.  A single state broadcasts to every slot,
    leaves with a leading K axis are per-REPLICA states (only the ensemble
    axis broadcasts), and (E, K, ...) leaves are taken as they are."""
    theta0 = place_start(theta0)
    e, k = num_ensembles, config.num_temps

    def bcast(t, lead):
        return t.expand(lead + tuple(t.shape)).clone()

    if is_param_tree(theta0):
        theta0 = tree_map(torch.as_tensor, theta0)
        leaves = tree_leaves(theta0)
        if all(leaf.ndim >= 2 and tuple(leaf.shape[:2]) == (e, k) for leaf in leaves):
            template = tree_map(lambda t: t[0, 0], theta0)
        elif all(leaf.ndim >= 1 and tuple(leaf.shape[:1]) == (k,) for leaf in leaves):
            template = tree_map(lambda t: t[0], theta0)
            theta0 = tree_map(lambda t: bcast(t, (e,)), theta0)
        else:
            template = theta0
            theta0 = tree_map(lambda t: bcast(t, (e, k)), template)
        _check_tree_num_temps(tree_map(lambda t: t[0], theta0), config)
        mass = make_diag_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]), template,
                                   "parallel tempering")
        return theta0, mass
    if theta0.ndim == 1:
        theta0 = bcast(theta0, (e, k))
    elif theta0.ndim == 2:
        theta0 = bcast(theta0, (e,))
    check_num_temps(theta0, config)
    return theta0, make_mass(_as_like(inv_mass, theta0), theta0.shape[-1])


def assemble_pt_ensemble_result(traj, alphas, swaps, carry_f: PTCarry,
                                config: PTConfig) -> PTResult:
    """Ensemble-axis variant of :func:`assemble_pt_result`: burn-slice
    (E, N, K, D) trajectories (or trees of (E, N, K, ...) leaves) into a
    PTResult with a leading ensemble axis."""
    burn = max(config.burn, 0)
    return PTResult(
        samples=_tmap(lambda t: t[:, burn:, 0], traj),
        replica_samples=_tmap(lambda t: t[:, burn:], traj),
        info=PTInfo(
            accept_prob=alphas[:, burn:],
            swap_accept=swaps[:, burn:],
            betas=betas_from_log_gaps(carry_f.s, config.max_temp),
            swap_rate_ema=carry_f.ema,
            step_sizes=carry_f.da.step_size,
        ),
        final_carry=carry_f,
    )
