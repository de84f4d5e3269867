"""True tree-doubling NUTS (multinomial, iterative).

Counterpart of ``hamiltorch_tpu/samplers/nuts.py``: dynamic trajectory
lengths by the No-U-Turn criterion (Hoffman & Gelman 2014) with multinomial
state selection and biased progressive sampling (Betancourt 2017, app. A).
Subtrees are built without recursion: leaves are added left to right and
the U-turn is checked over every complete dyadic interval that ends at the
new leaf.  The start ``a`` of such an interval is kept in checkpoint slot
``popcount(a)``; among starts alive at one time the popcounts strictly
increase, so ``max_tree_depth + 1`` slots suffice.  A backward expansion
integrates with step ``-eps`` and every U-turn check uses ``dir * p``, with
the mass matrix entering through velocities M^{-1} p, as in Stan.

Where the JAX package runs one chain's ``lax.while_loop`` per depth and per
leaf under ``vmap``, this module runs every chain at once with the depth
and the leaf index as host integers: they advance in lockstep for every
live chain.  ``for depth in range(max_depth)`` stops when no chain is
alive, and ``for s in range(2**depth)`` when no chain's subtree is; per-chain
bool masks freeze the lanes that finished, over every carry field, with
``torch.where``.  The dyadic checks are host-side too: for each ``k`` with
``2**k`` dividing ``s + 1`` the slot ``popcount(s - 2**k + 1)`` is a host
int that indexes the ``(max_depth + 1, C, ...)`` checkpoint slab.  The
gradient is evaluated for every lane, finished ones included (the waste of
JAX's ``vmap`` too), and each leaf costs one device-to-host sync
(``bool(alive.any())``).  ``leaf_steps`` counts the leaf iterations run, so
``leaf_steps * C`` gradients were computed; ``NUTSInfo.num_leapfrogs`` counts
the ones each chain used.

Random numbers: the JAX key tree (``fold_in`` per draw, ``split`` per depth
and per leaf) has no counterpart in a ``torch.Generator``.  At the start of
draw ``n`` chain ``c`` draws everything the draw can use from its own
stream, seeded by ``utils.rng.draw_seed(key, c, NUTS_STREAM + n)``: ``z``
(D,) for the momentum, ``u_dir`` (max_depth,), ``u_merge`` (max_depth,) and
``u_leaf`` (max_depth, 2**(max_depth - 1)).  The direction at depth ``d`` is
``u_dir[d] < 0.5``, the merge ``log(u_merge[d]) < log_ratio`` and the choice
of leaf ``s`` ``u_leaf[d, s] < p_take``, as in the JAX code.  A chain's draws
depend on neither the number of chains nor the chunking.  ``_noise`` (a
test hook) hands in these four arrays with leading ``(S, C)`` axes instead.

The chain state may be a flat (C, D) block or a parameter tree with a
leading chain axis on every leaf; mass operators (one chain's) are
``torch.func.vmap``-ed over the chains.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.mass import (
    DenseMass,
    DiagMass,
    IdentityMass,
    TreeMass,
    diag_tree_mass_view,
    make_diag_mass_tree,
    make_mass,
)
from ..ops.potential import resolve_potential, value_and_grad
from ..utils.convert import place_start
from ..utils.progress import scan_progress
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from ..utils.rng import NUTS_STREAM, draw_nuts_noise, keyed_chains
from .adaptation import da_init, da_update
from .driver import ChainState, MCMCResult, MCMCStats, _flat_chains, _tree_where, validate_common_config
from .warmup import (
    schedule_flags,
    validate_adapt_mass,
    welford_cov_init,
    welford_cov_merge_batch,
    welford_cov_update,
    welford_init,
    welford_merge_batch,
    welford_update,
    windowed_step,
)

DIVERGENCE_THRESHOLD = 1000.0

# leaf iterations run since import (each evaluates the gradient of every
# chain of its batch); read and reset by callers that count computed work
leaf_steps = 0


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    num_samples: int
    step_size: float = 0.1
    burn: int = 0
    max_tree_depth: int = 10
    adapt_step_size: bool = True
    desired_accept_rate: float = 0.8
    # Stan-style windowed warmup (samplers/warmup.py): False, True / "diag"
    # (a diagonal inverse mass) or "dense" (the full covariance, flat states
    # only); honoured when burn > 0
    adapt_mass: bool | str = False
    # > 0: a progress line on the host's stdout every N draws
    progress_every: int = 0
    # thin > 1: keep every thin-th draw; num_samples counts ALL transitions
    # and must divide by thin.  Kept row b is the state after transition
    # (b+1)*thin - 1; its infos are the window's mean accept_prob, any
    # divergence, summed leapfrogs, and the kept draw's energies, depth and
    # step size
    thin: int = 1
    # store the kept trace in this dtype (a torch dtype NAME, e.g.
    # "bfloat16"); the chain keeps sampling in its own.  None = the state's
    trace_dtype: str | None = None

    def __post_init__(self):
        validate_common_config(self)
        if self.thin < 1:
            raise ValueError(f"thin={self.thin}; must be >= 1")
        if self.thin > 1 and self.num_samples % self.thin:
            raise ValueError(
                f"num_samples={self.num_samples} must be divisible by thin={self.thin}"
            )
        if self.max_tree_depth < 1:
            raise ValueError(f"max_tree_depth={self.max_tree_depth}; must be >= 1")
        validate_trace_dtype(self.trace_dtype)


def validate_trace_dtype(trace_dtype) -> None:
    """``trace_dtype`` must be None or the name of a floating torch dtype."""
    if trace_dtype is None:
        return
    if not isinstance(trace_dtype, str):
        raise ValueError(
            f"trace_dtype={trace_dtype!r}; pass a dtype NAME string (e.g. 'bfloat16')"
        )
    dtype = getattr(torch, trace_dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"trace_dtype={trace_dtype!r} is not a torch dtype")
    if not dtype.is_floating_point:
        raise ValueError(
            f"trace_dtype={trace_dtype!r}; the sample trace is real-valued — pass a "
            "floating dtype name"
        )


class _End(NamedTuple):
    """One trajectory end of every chain: position, momentum, cached potential."""

    theta: object
    p: object
    logp: torch.Tensor
    grad: object


def _popcount(x):
    """Set bits of a non-negative 32-bit integer (a host int or an integer tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _bcast(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-chain (C,) value shaped to broadcast over a (C, ...) leaf."""
    return v.reshape(v.shape + (1,) * (leaf.ndim - v.ndim))


def _t_dot(a, b) -> torch.Tensor:
    """(C,): each chain's <a, b> over all leaves."""
    parts = [(al * bl).reshape(al.shape[0], -1).sum(dim=1)
             for al, bl in zip(tree_leaves(a), tree_leaves(b))]
    return parts[0] if len(parts) == 1 else sum(parts)


def _t_any_neq(a, b) -> torch.Tensor:
    """(C,): True where any element of a chain's state differs (the chain moved)."""
    parts = [(al != bl).reshape(al.shape[0], -1).any(dim=1)
             for al, bl in zip(tree_leaves(a), tree_leaves(b))]
    out = parts[0]
    for part in parts[1:]:
        out = out | part
    return out


def _where_end(pred, new: _End, old: _End) -> _End:
    return _End(*(_tree_where(pred, n, o) for n, o in zip(new, old)))


class BatchedMass:
    """One chain's mass operator applied to every chain with ``torch.func.vmap``.

    ``op_of(metric)`` builds the operator; ``metric`` has a leading chain
    axis when ``per_chain`` (each chain's windowed warmup) and none when it
    is shared (a fixed mass, the ensemble's pooled metric).  The identity
    and diagonal operators are elementwise and broadcast over the chain axis
    as they are, without ``vmap``'s per-call cost (a NUTS leaf is
    host-bound).
    """

    def __init__(self, op_of: Callable, metric, per_chain: bool):
        one = tree_map(lambda m: m[0], metric) if per_chain else metric
        if isinstance(op_of(one), (IdentityMass, DiagMass)):
            op = op_of(metric)
            self.sample, self.velocity = op.sample, op.velocity
        elif per_chain:
            sample = torch.func.vmap(lambda m, z: op_of(m).sample(z))
            velocity = torch.func.vmap(lambda m, p: op_of(m).velocity(p))
            self.sample = lambda z: sample(metric, z)
            self.velocity = lambda p: velocity(metric, p)
        else:
            op = op_of(metric)
            self.sample, self.velocity = torch.func.vmap(op.sample), torch.func.vmap(op.velocity)


def _kinetic(p, v) -> torch.Tensor:
    """(C,): 0.5 pᵀM⁻¹p from the momentum and its velocity ``v`` = M⁻¹p,
    reduced leaf by leaf (the JAX package's NUTS reduces a tree's kinetic
    energy per leaf too, ``TreeMass.kinetic_leafwise``).  Each leaf's
    velocity is computed once and serves the energy and the U-turn checks."""
    return 0.5 * _t_dot(p, v)


def _single_step(vg, mass: BatchedMass, end: _End, eps) -> _End:
    p_half = tree_map(lambda p, g: p + 0.5 * _bcast(eps, p) * g, end.p, end.grad)
    theta = tree_map(lambda t, v: t + _bcast(eps, t) * v, end.theta, mass.velocity(p_half))
    logp, grad = vg(theta)
    p = tree_map(lambda ph, g: ph + 0.5 * _bcast(eps, ph) * g, p_half, grad)
    return _End(theta, p, logp, grad)


def _is_uturn(theta_minus, v_minus, theta_plus, v_plus, record=None, live=None):
    """True where either end's velocity (M⁻¹p, in physical time order)
    points back across the span."""
    dtheta = tree_map(lambda tp, tm: tp - tm, theta_plus, theta_minus)
    d_minus, d_plus = _t_dot(dtheta, v_minus), _t_dot(dtheta, v_plus)
    if record is not None:
        record(torch.minimum(d_minus.abs(), d_plus.abs()), live)
    return (d_minus < 0) | (d_plus < 0)


class _Subtree(NamedTuple):
    end: _End  # outgoing edge of the subtree (integration order)
    theta_prop: object
    logp_prop: torch.Tensor
    grad_prop: object
    h_prop: torch.Tensor  # Hamiltonian at the proposed leaf
    log_weight: torch.Tensor  # logsumexp of H0 - H over the leaves
    sum_alpha: torch.Tensor
    num_alpha: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    num_steps: torch.Tensor


def _build_subtree(vg, mass, start: _End, depth: int, direction, eps, h0, u_leaf, live,
                   ck_theta, ck_v, record=None) -> _Subtree:
    """Integrate up to 2**depth leaves from ``start`` in ``direction`` for
    the chains where ``live``; a chain's subtree stops at its first U-turn
    or divergence.  ``u_leaf`` (C, 2**(max_depth-1)) holds the leaf-choice
    uniforms; ``ck_theta`` / ``ck_v`` are the checkpoint slabs of positions
    and velocities M⁻¹p (the U-turn checks read the velocity of ``dir * p``,
    ``dir`` times the stored one)."""
    global leaf_steps
    signed_eps = eps * direction
    c = h0.shape[0]
    zeros_i = torch.zeros(c, dtype=torch.int32, device=h0.device)
    no = torch.zeros(c, dtype=torch.bool, device=h0.device)
    end = start
    theta_prop, logp_prop, grad_prop, h_prop = start.theta, start.logp, start.grad, h0
    log_weight = torch.full_like(h0, -torch.inf)
    sum_alpha, num_alpha, num_steps = torch.zeros_like(h0), zeros_i, zeros_i
    turning, diverging = no, no
    alive = live
    for s in range(1 << depth):
        if s > 0 and not bool(alive.any()):  # the per-leaf sync
            break
        leaf_steps += 1
        leaf = _single_step(vg, mass, end, signed_eps)
        v_leaf = mass.velocity(leaf.p)
        h = -leaf.logp + _kinetic(leaf.p, v_leaf)
        delta = h0 - h  # log leaf weight
        div = ~torch.isfinite(delta) | (delta < -DIVERGENCE_THRESHOLD)
        delta_safe = torch.where(div, torch.full_like(delta, -torch.inf), delta)

        # progressive multinomial proposal within the subtree
        new_log_w = torch.logaddexp(log_weight, delta_safe)
        p_take = torch.exp(delta_safe - new_log_w)  # w_leaf / w_subtree
        u = u_leaf[:, s]
        take = alive & (u < p_take)
        if record is not None:  # a diverged leaf's p_take is NaN or 0: never taken
            record((u - p_take).abs(), alive & ~div)
        alpha = torch.clamp(torch.exp(torch.where(torch.isfinite(delta), delta,
                                                  torch.full_like(delta, -torch.inf))), max=1.0)

        # checkpoint even positions; slot popcount(s) is collision-free
        if s % 2 == 0:
            slot = _popcount(s)
            tree_map(lambda ck, lf: ck[slot].copy_(lf), ck_theta, leaf.theta)
            tree_map(lambda ck, lf: ck[slot].copy_(lf), ck_v, v_leaf)

        # U-turn over every dyadic interval [s - 2**k + 1, s] ending here
        turn = turning
        k = 1
        while (s + 1) % (1 << k) == 0:
            slot_a = _popcount(s - (1 << k) + 1)
            v_a = tree_map(lambda ck: _bcast(direction, ck[slot_a]) * ck[slot_a], ck_v)
            v_s = tree_map(lambda x: _bcast(direction, x) * x, v_leaf)
            turn = turn | _is_uturn(tree_map(lambda ck: ck[slot_a], ck_theta), v_a,
                                    leaf.theta, v_s, record, alive)
            k += 1

        end = _where_end(alive, leaf, end)
        theta_prop = _tree_where(take, leaf.theta, theta_prop)
        logp_prop = torch.where(take, leaf.logp, logp_prop)
        grad_prop = _tree_where(take, leaf.grad, grad_prop)
        h_prop = torch.where(take, h, h_prop)
        log_weight = torch.where(alive, new_log_w, log_weight)
        sum_alpha = torch.where(alive, sum_alpha + alpha, sum_alpha)
        num_alpha = torch.where(alive, num_alpha + 1, num_alpha)
        num_steps = torch.where(alive, num_steps + 1, num_steps)
        turning = torch.where(alive, turn, turning)
        diverging = torch.where(alive, div, diverging)
        alive = alive & ~turning & ~diverging
    return _Subtree(end, theta_prop, logp_prop, grad_prop, h_prop, log_weight, sum_alpha,
                    num_alpha, turning, diverging, num_steps)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean leaf acceptance statistic (for adaptation)
    divergent: torch.Tensor
    tree_depth: torch.Tensor
    num_leapfrogs: torch.Tensor
    energy: torch.Tensor  # H at trajectory start (fresh momentum): the E-BFMI series
    step_size: torch.Tensor
    # H at the state the multinomial selection returned; energy_new - energy
    # is this draw's trajectory energy error (zero only if the chain stayed)
    energy_new: torch.Tensor


def nuts_transition(vg, mass: BatchedMass, max_depth: int):
    """One NUTS draw of every chain: ``(noise, theta, logp, grad, step_size)
    -> (theta, logp, grad, NUTSInfo)``.

    ``vg`` is the value-and-gradient batched over the chains, ``mass`` a
    :class:`BatchedMass`, ``step_size`` (C,).  ``noise`` holds this draw's
    ``z`` (C, D), ``u_dir`` / ``u_merge`` (C, max_depth) and ``u_leaf`` (C,
    max_depth, 2**(max_depth-1)).  ``record(margin, live)``, when given,
    receives every decision's distance from its other outcome on the live
    chains (a test hook).
    """

    def transition(noise, theta, logp, grad, step_size, record=None):
        dtype = logp.dtype
        c = logp.shape[0]
        p0 = mass.sample(noise["z"])
        h0 = -logp + _kinetic(p0, mass.velocity(p0))
        left = right = _End(theta, p0, logp, grad)
        theta_prop, logp_prop, grad_prop = theta, logp, grad
        h_prop = h0  # staying put has zero trajectory energy error
        log_weight = torch.zeros_like(h0)  # the initial state has weight exp(0)
        zeros_i = torch.zeros(c, dtype=torch.int32, device=logp.device)
        sum_alpha, num_alpha, num_steps, depth = torch.zeros_like(h0), zeros_i, zeros_i, zeros_i
        turning = torch.zeros(c, dtype=torch.bool, device=logp.device)
        diverging = turning
        alive = ~turning
        ck_theta = tree_map(lambda leaf: leaf.new_empty((max_depth + 1,) + tuple(leaf.shape)), theta)
        ck_v = tree_map(lambda leaf: leaf.new_empty((max_depth + 1,) + tuple(leaf.shape)), theta)
        for d in range(max_depth):
            if d > 0 and not bool(alive.any()):
                break
            u_dir = noise["u_dir"][:, d]
            go_right = u_dir < 0.5
            if record is not None:
                record((u_dir - 0.5).abs(), alive)
            direction = torch.where(go_right, 1.0, -1.0).to(dtype)
            start = _where_end(go_right, right, left)
            sub = _build_subtree(vg, mass, start, d, direction, step_size, h0,
                                 noise["u_leaf"][:, d], alive, ck_theta, ck_v, record)

            invalid = sub.turning | sub.diverging
            # biased progressive merge: take the new subtree's proposal with
            # probability min(1, W_new / W_old) when the subtree is valid
            log_ratio = sub.log_weight - log_weight
            log_u = torch.log(noise["u_merge"][:, d])
            grow = alive & ~invalid
            if record is not None:
                record((log_u - log_ratio).abs(), grow)
            take = grow & (log_u < log_ratio)
            theta_prop = _tree_where(take, sub.theta_prop, theta_prop)
            logp_prop = torch.where(take, sub.logp_prop, logp_prop)
            grad_prop = _tree_where(take, sub.grad_prop, grad_prop)
            h_prop = torch.where(take, sub.h_prop, h_prop)
            log_weight = torch.where(grow, torch.logaddexp(log_weight, sub.log_weight), log_weight)

            # advance the chosen end only where the subtree is valid
            right = _where_end(grow & go_right, sub.end, right)
            left = _where_end(grow & ~go_right, sub.end, left)
            # top-level U-turn across the whole trajectory (where the subtree
            # was invalid the chain stops whatever this says)
            top_turn = _is_uturn(left.theta, mass.velocity(left.p), right.theta,
                                 mass.velocity(right.p), record, grow)

            sum_alpha = torch.where(alive, sum_alpha + sub.sum_alpha, sum_alpha)
            num_alpha = torch.where(alive, num_alpha + sub.num_alpha, num_alpha)
            num_steps = torch.where(alive, num_steps + sub.num_steps, num_steps)
            turning = torch.where(alive, sub.turning | top_turn, turning)
            diverging = torch.where(alive, sub.diverging, diverging)
            depth = torch.where(alive, depth + 1, depth)
            alive = alive & ~turning & ~diverging

        info = NUTSInfo(
            accept_prob=sum_alpha / torch.clamp(num_alpha, min=1),
            divergent=diverging,
            tree_depth=depth,
            num_leapfrogs=num_steps,
            energy=h0,
            step_size=step_size,
            energy_new=h_prop,
        )
        return theta_prop, logp_prop, grad_prop, info

    return transition


def _aggregate_info_window(infos_w: NUTSInfo) -> NUTSInfo:
    """Collapse a (thin, ...) window of per-draw infos to one kept row."""
    return NUTSInfo(
        accept_prob=torch.mean(infos_w.accept_prob, dim=0),
        divergent=torch.any(infos_w.divergent, dim=0),
        tree_depth=infos_w.tree_depth[-1],
        num_leapfrogs=torch.sum(infos_w.num_leapfrogs, dim=0, dtype=torch.int32),
        energy=infos_w.energy[-1],
        step_size=infos_w.step_size[-1],
        energy_new=infos_w.energy_new[-1],
    )


def _nuts_aux_kept(aux_w):
    """Collapse a (thin, ...) window of (info, moved) rows to one kept row:
    the infos aggregated, moved any within the window."""
    infos_w, moved_w = aux_w
    return _aggregate_info_window(infos_w), torch.any(moved_w, dim=0)


def init_metric_seed(mass, d: int, dtype, dense: bool, device=None, batch: tuple = ()):
    """(wf0, metric0) warmup seed from the user's mass operator, with
    leading ``batch`` axes (one per chain, or none for a pooled metric).

    Shared by the samplers and the checkpointed runners: the two must agree
    bit for bit, or a resumed run would adapt from another metric."""

    def expand(t):
        return t.expand(batch + tuple(t.shape)).clone()

    if dense:
        inv, chol = init_dense_metric(mass, d, dtype, device)
        return welford_cov_init(d, dtype, device, batch), (expand(inv), expand(chol))
    if isinstance(mass, DiagMass):
        metric = torch.as_tensor(mass.inv_diag, dtype=dtype, device=device)
    else:
        metric = torch.ones((d,), dtype=dtype, device=device)
    return welford_init(d, dtype, device, batch), expand(metric)


def init_dense_metric(mass, d: int, dtype, device=None):
    """(inv_cov, chol_mass) seed for dense windowed warmup from the user's
    mass operator: dense as given, diagonal as its diagonal embedding,
    identity as (I, I)."""
    if isinstance(mass, DenseMass):
        return (torch.as_tensor(mass.inv_mass, dtype=dtype, device=device),
                torch.as_tensor(mass.chol_mass, dtype=dtype, device=device))
    if isinstance(mass, DiagMass):
        inv_diag = torch.as_tensor(mass.inv_diag, dtype=dtype, device=device)
        return torch.diag(inv_diag), torch.diag(torch.rsqrt(inv_diag))
    eye = torch.eye(d, dtype=dtype, device=device)
    return eye, eye


def _draw_op(mass, template, windowed: bool, dense: bool):
    """``op_of(metric)``: the draw's one-chain mass operator."""
    if dense:
        return lambda m: DenseMass(inv_mass=m[0], chol_mass=m[1])
    if windowed:
        if template is not None:
            return lambda m: diag_tree_mass_view(m, template)
        return lambda m: DiagMass(inv_diag=m)
    return lambda _: mass


def _run_nuts_batched(key, theta0, log_prob_fn, config: NUTSConfig, mass, pooled: bool = False,
                      init_state=None, init_da=None, start_iter: int = 0, init_warm=None,
                      collect_flags=None, end_flags=None, chain_keys=None, axis_name=None,
                      _noise=None, _margins=None):
    """NUTS over the chains on the leading axis of every leaf of ``theta0``.

    ``pooled=False`` runs independent chains, each adapting its own step
    size and metric (``run_nuts_chains``); ``pooled=True`` adapts one step
    size on the ensemble-mean acceptance statistic and one metric from
    every chain's draws, Chan-merged (``run_nuts_ensemble``).  Returns
    ``(MCMCResult, NUTSInfo)`` with the chain axis first on every stat, and
    ``final_warm`` the ``(welford, metric, da_t)`` carry.  ``init_state``,
    ``init_da``, ``start_iter``, ``init_warm`` and the schedule's slice
    (numpy ``collect_flags`` / ``end_flags``) continue an earlier chunk
    exactly.  ``_margins``, a list, collects every decision's least margin
    (a test hook).

    ``axis_name`` (pooled only): the ensemble extends over the ranks of a
    process group (``parallel.sharding.resolve_group``), and the pooled
    statistics (the mean acceptance for dual averaging, the Welford batch
    moments) are summed over it; ``chain_keys`` are then the batch's global
    chain indices (``parallel.sharding.derive_chain_keys``), the chains'
    slice of the unsharded ensemble's stream.
    """
    vg = torch.func.vmap(value_and_grad(log_prob_fn))
    if init_state is None:
        logp0, grad0 = vg(theta0)
        init_state = ChainState(theta0, logp0, grad0)
    leaves = tree_leaves(init_state.theta)
    c, dtype, device = leaves[0].shape[0], leaves[0].dtype, leaves[0].device
    dim = sum(leaf[0].numel() for leaf in leaves)
    template = mass.template if isinstance(mass, TreeMass) else None
    windowed = bool(config.adapt_mass) and config.burn > 0
    dense = windowed and config.adapt_mass == "dense"
    batch = () if pooled else (c,)
    if init_da is None:
        init_da = da_init(torch.full(batch, config.step_size, dtype=dtype, device=device),
                          dtype=dtype, device=device)
    if init_warm is None:
        seed_mass = mass.inner if template is not None else mass
        wf0, metric0 = init_metric_seed(seed_mass, dim, dtype, dense, device, batch)
        init_warm = (wf0, metric0, torch.zeros(batch, dtype=torch.int32, device=device))
    if collect_flags is None:
        collect_flags, end_flags = schedule_flags(config.burn if windowed else 0, start_iter,
                                                  config.num_samples)
    max_depth, thin = config.max_tree_depth, config.thin
    kept = config.num_samples // thin
    adapt = config.adapt_step_size and config.burn > 0
    op_of = _draw_op(mass, template, windowed, dense)
    record = None
    if _margins is not None:
        def record(margin, live):
            _margins.append(torch.where(live, margin, torch.full_like(margin, torch.inf)).min())

    trace_dtype = None if config.trace_dtype is None else getattr(torch, config.trace_dtype)
    samples = tree_map(
        lambda leaf: torch.empty((c, kept) + tuple(leaf.shape[1:]),
                                 dtype=trace_dtype or leaf.dtype, device=device),
        init_state.theta)
    info_bufs, moved_buf = [], torch.empty((c, kept), dtype=torch.bool, device=device)
    progress = (scan_progress(config.num_samples, config.progress_every)
                if config.progress_every > 0 else None)

    gsum = count = None
    if axis_name is not None:
        from ..parallel.sharding import group_sum, resolve_group

        group = resolve_group(axis_name)
        count = group_sum(torch.tensor(float(c), dtype=dtype, device=device), group)

        def gsum(x):
            return group_sum(torch.sum(x, dim=0), group)

    state, da, (wf, metric, da_t) = init_state, init_da, init_warm
    for b in range(kept):
        window, moves = [], []
        for j in range(thin):
            i = b * thin + j
            n = start_iter + i
            if progress is not None:
                progress(i)  # the bar is sized per run, not global
            if _noise is None:
                with keyed_chains(chain_keys, c):
                    noise = draw_nuts_noise(key, NUTS_STREAM + n, c, dim, max_depth, dtype,
                                            device)
            else:
                noise = {name: z[i] for name, z in _noise.items()}
            step_size = da.step_size.expand(c) if pooled else da.step_size
            bmass = BatchedMass(op_of, metric, per_chain=windowed and not pooled)
            theta, logp, grad, info = nuts_transition(vg, bmass, max_depth)(
                noise, *state, step_size, record)
            moves.append(_t_any_neq(theta, state.theta))
            state = ChainState(theta, logp, grad)
            window.append(info)

            if adapt:
                # dual averaging on the mean leaf acceptance statistic;
                # windowed warmup counts from the last window end
                if not pooled:
                    stat = info.accept_prob
                elif gsum is None:
                    stat = info.accept_prob.mean()
                else:
                    stat = gsum(info.accept_prob) / count
                if n < config.burn:
                    da = da_update(da, torch.log(torch.clamp(stat, min=1e-10)),
                                   da_t if windowed else n,
                                   desired_accept_rate=config.desired_accept_rate)
                elif n == config.burn:
                    da = dataclasses.replace(da, step_size=torch.exp(da.log_eps_bar))

            window_end = bool(end_flags[i])
            if windowed:
                if bool(collect_flags[i]):
                    flat = _flat_chains(state.theta)
                    if pooled:
                        merge = welford_cov_merge_batch if dense else welford_merge_batch
                        wf = merge(wf, flat, gsum=gsum, count=count)
                    else:
                        wf = (welford_cov_update if dense else welford_update)(wf, flat)
                wf, metric, da = windowed_step(wf, metric, da, window_end, dense)
            da_t = torch.zeros_like(da_t) if window_end else da_t + 1

        row, moved = _nuts_aux_kept((NUTSInfo(*(torch.stack(f) for f in zip(*window))),
                                     torch.stack(moves)))
        tree_map(lambda buf, t: buf[:, b].copy_(t), samples, state.theta)
        info_bufs.append(row)
        moved_buf[:, b] = moved

    if progress is not None:
        progress.end()
    info = NUTSInfo(*(torch.stack(f, dim=1) for f in zip(*info_bufs)))
    stats = MCMCStats(
        accept_prob=info.accept_prob,
        accepted=moved_buf,  # the real outcome: the chain moved this draw
        divergent=info.divergent,
        energy_old=info.energy,
        energy_new=info.energy_new,
        step_size=info.step_size,
        fp_iters=torch.zeros_like(info.tree_depth),
        fp_residual=torch.zeros_like(info.accept_prob),
    )
    return MCMCResult(
        samples=samples,
        stats=stats,
        final_step_size=da.step_size,
        acc_rate=info.accept_prob.mean() if pooled else info.accept_prob.mean(dim=1),
        final_state=state,
        final_da=da,
        final_warm=(wf, metric, da_t),
    ), info


def _time_major(result: MCMCResult, info: NUTSInfo):
    """The ensemble's layout: stats and infos (N, C), samples (C, N, ...)."""
    def t(x):
        return x.transpose(0, 1).contiguous()

    info = NUTSInfo(*(t(f) for f in info))
    # the rate over the time-major layout: the checkpointed ensemble reduces
    # the same tensor, and a reduction's order (on the card) follows the layout
    return (result._replace(stats=MCMCStats(*(t(s) for s in result.stats)),
                            acc_rate=info.accept_prob.mean()), info)


def _tree_nuts_mass(inv_mass, template, config: NUTSConfig) -> TreeMass:
    """Validated TreeMass for a tree NUTS entry (diagonal metrics only)."""
    from .hmc import _as_like  # hmc imports this module through warmup

    mass = make_diag_mass_tree(_as_like(inv_mass, tree_leaves(template)[0]), template, "NUTS",
                               dense_requested=config.adapt_mass == "dense")
    validate_nuts_mass(config, mass.inner)
    return mass


def validate_nuts_mass(config: NUTSConfig, mass) -> None:
    """``adapt_mass`` mode against the user's inverse mass (shared with the
    checkpointed runners)."""
    validate_adapt_mass(config.adapt_mass, mass)


def _flat_nuts_mass(inv_mass, theta0: torch.Tensor, config: NUTSConfig):
    from .hmc import _as_like

    mass = make_mass(_as_like(inv_mass, theta0), theta0.shape[-1])
    validate_nuts_mass(config, mass)
    return mass


def _prepare_chains(theta0, config: NUTSConfig, num_chains: int, inv_mass, stacked):
    """(theta0 with a leading chain axis, mass) of a chains / ensemble entry."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, theta0 = stack_param_tree(theta0, num_chains, stacked=stacked)
        return theta0, _tree_nuts_mass(inv_mass, template, config)
    if theta0.ndim == 1:
        theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
    return theta0, _flat_nuts_mass(inv_mass, theta0, config)


def _prepare_one(theta0, config: NUTSConfig, inv_mass):
    """(theta0 with a chain axis of 1, mass) of a single-chain entry."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, 1, stacked=False)
        return stacked, _tree_nuts_mass(inv_mass, template, config)
    return theta0[None], _flat_nuts_mass(inv_mass, theta0, config)


def run_nuts(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config: NUTSConfig,
    inv_mass=None,
    pass_grad=None,
    _noise=None,
    _margins=None,
):
    """Sample one chain with tree-doubling NUTS.  Returns (MCMCResult, NUTSInfo).

    ``config.adapt_mass`` with ``burn > 0`` runs Stan's windowed warmup:
    the inverse mass (diagonal, or dense on a flat state) is estimated from
    Welford statistics over doubling slow windows, with dual averaging
    restarted at each window end.  ``theta0`` is a flat (D,) tensor or a
    parameter tree (``samples`` is then a tree of (N, ...) leaves), and
    ``inv_mass`` None, a (D,) diagonal, a (D, D) matrix, blocks, or for a
    tree a matching tree of diagonals (dense and block metrics and dense
    warmup take the flat path).  ``key`` is an integer seed; the chain runs
    on the device of ``theta0`` (the card for a start that is not a tensor).
    ``_noise`` (a test hook): ``{"z", "u_dir", "u_merge", "u_leaf"}``, each
    with leading ``(num_samples, 1)`` axes.
    """
    from .hmc import _first_chain

    lp = resolve_potential(log_prob_fn, pass_grad)
    stacked, mass = _prepare_one(theta0, config, inv_mass)
    res, info = _run_nuts_batched(key, stacked, lp, config, mass, _noise=_noise,
                                  _margins=_margins)
    return _first_chain(res), NUTSInfo(*(f[0] for f in info))


def run_nuts_chains(
    key: int,
    log_prob_fn,
    theta0,
    config: NUTSConfig,
    num_chains: int,
    inv_mass=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
    _margins=None,
):
    """Independent NUTS chains batched on a leading axis.  Returns
    (MCMCResult, NUTSInfo) with the chain axis first: ``samples`` (C, N, D)
    or a tree of (C, N, ...) leaves, stats and infos (C, N).

    Each chain adapts its own step size and metric; for one pooled
    adaptation see :func:`run_nuts_ensemble`.  ``theta0`` may be (D,)
    (copied to every chain), (C, D), or a parameter tree, single-chain or
    with a leading ``num_chains`` axis on every leaf
    (``theta0_is_stacked`` overrides the detection).  ``_noise`` as in
    :func:`run_nuts` with leading ``(num_samples, num_chains)`` axes.
    """
    lp = resolve_potential(log_prob_fn, None)
    theta0, mass = _prepare_chains(theta0, config, num_chains, inv_mass, theta0_is_stacked)
    return _run_nuts_batched(key, theta0, lp, config, mass, _noise=_noise, _margins=_margins)


def run_nuts_ensemble(
    key: int,
    log_prob_fn,
    theta0,
    config: NUTSConfig,
    num_chains: int,
    inv_mass=None,
    theta0_is_stacked: bool | None = None,
    _noise=None,
    _margins=None,
):
    """NUTS chain ensemble with pooled (cross-chain) adaptation.

    One step size and one mass matrix adapt from every chain each draw:
    dual averaging on the ensemble-mean acceptance statistic, and with
    ``adapt_mass`` (True / "diag", or "dense") a Welford estimate that
    Chan-merges the C chains' states per draw, so warmup needs ~C-fold
    fewer draws than per-chain adaptation.  Returns (MCMCResult, NUTSInfo):
    ``samples`` is (C, N, D) chain-major (a tree of (C, N, ...) leaves for
    a tree state), while ``stats`` and the ``NUTSInfo`` fields are
    TIME-major (N, C), as in the JAX package.  ``final_warm`` is the
    ``(welford, metric, da_t)`` carry: ``final_warm[1]`` is the adapted
    inverse-mass diagonal, or the ``(inv_mass, chol_mass)`` pair of the
    dense metric.  The sharded form is
    ``parallel.sharding.run_nuts_ensemble_sharded``.
    """
    lp = resolve_potential(log_prob_fn, None)
    theta0, mass = _prepare_chains(theta0, config, num_chains, inv_mass, theta0_is_stacked)
    return _time_major(*_run_nuts_batched(key, theta0, lp, config, mass, pooled=True,
                                          _noise=_noise, _margins=_margins))
