"""Barker proposal MCMC (Livingstone & Zanella 2022).

Counterpart of ``hamiltorch_tpu/samplers/barker.py``.  Each coordinate
proposes a symmetric increment ``z_i ~ N(0, (eps*s_i)^2)`` and keeps it
with probability ``sigmoid(z_i * g_i)`` (else flips its sign), where ``g =
grad log p``.  The skew-symmetric kernel is a valid Metropolis--Hastings
proposal whose correction is a sum of softplus terms; the gradient enters
only through a BOUNDED probability, so one large gradient cannot catapult
the chain.  One gradient a draw.

Step size adapts by dual averaging toward ``desired_accept_rate`` (0.574,
the paper's optimum) while the global draw index is below ``burn`` and
freezes to the averaged step after (its state float32, as in the JAX
package, or float64 for a float64 chain).  With ``adapt_scale`` a Welford
estimate of each coordinate's posterior std accumulates over ``[burn//4,
3*burn//4)`` and becomes the proposal scale from ``3*burn//4`` on (when
it has more than two draws), leaving the last quarter of burn for dual
averaging to re-tune eps against it.

Batching: ``run_barker_chains`` runs C chains as ONE (C, D) batch, one
``torch.func.vmap``-ed value and gradient a draw; each chain has its own
dual-averaging and Welford state ((C,) and (C, D) tensors).
``run_barker`` is the same loop at C = 1.

Random numbers: at global draw n ONE generator seeded by ``draw_seed(key,
0, BARKER_STREAM + n)`` (``utils.rng.stream_generator``) draws every
chain's unit normals, keep uniforms and Metropolis uniform (float32, as
the JAX package draws it), so chunked runs reproduce the straight run bit
for bit.  ``_noise`` (a test hook) hands in ``{"z": (S, [C,] D),
"u_keep": (S, [C,] D), "u_mh": (S, [C])}`` instead (S draws; the chain
axis for ``run_barker_chains``); the sampler multiplies z by eps * s
itself.  ``_margins`` (a test hook), when a list, receives each draw's
least distance of a keep or Metropolis decision from its other outcome.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.potential import value_and_grad
from ..utils.convert import place_start
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from ..utils.rng import BARKER_STREAM, chain_rows, stream_generator
from .adaptation import DualAveragingState, da_init, da_update
from .mclmc import _bind_data, _prep_flat, _ravel_chains
from .warmup import WelfordState, welford_init, welford_update, welford_variance


@dataclasses.dataclass(frozen=True)
class BarkerConfig:
    """Static configuration for :func:`run_barker`.

    ``num_samples`` counts TOTAL draws; the trace includes the ``burn``
    adaptation draws.  ``adapt_step_size`` requires ``burn > 0``;
    ``adapt_scale`` requires ``burn >= 8`` (the Welford window is the middle
    half of burn).
    """

    num_samples: int
    step_size: float = 0.5
    burn: int = 0
    adapt_step_size: bool = True
    desired_accept_rate: float = 0.574
    adapt_scale: bool = False
    thin: int = 1

    def __post_init__(self):
        if self.num_samples < 1:
            raise ValueError(f"num_samples={self.num_samples}; must be >= 1")
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")
        if self.burn < 0:
            # burn is a GLOBAL draw index (a resumed chunk may run with burn
            # >= its own num_samples); fresh runs check burn < num_samples
            # at the entry points
            raise ValueError(f"burn={self.burn} must be >= 0")
        if self.adapt_step_size and self.burn == 0:
            raise ValueError(
                "adapt_step_size requires burn > 0 (no draws to adapt on); "
                "set adapt_step_size=False to run at the given step_size"
            )
        if self.adapt_scale and self.burn < 8:
            raise ValueError(
                "adapt_scale requires burn >= 8 (the Welford window is "
                "burn/4..3*burn/4)"
            )
        if not 0.0 < self.desired_accept_rate < 1.0:
            raise ValueError("desired_accept_rate must be in (0, 1)")
        if self.thin < 1:
            raise ValueError("thin must be >= 1")
        if self.num_samples % self.thin:
            raise ValueError(
                f"num_samples={self.num_samples} must be divisible by "
                f"thin={self.thin}"
            )


class BarkerStats(NamedTuple):
    """Per-kept-draw diagnostics (the window's last transition when thinned)."""

    accept_prob: torch.Tensor  # min(1, exp(log MH ratio)), float32
    accepted: torch.Tensor  # bool MH outcome
    divergent: torch.Tensor  # any non-finite proposal evaluation in the window
    step_size: torch.Tensor  # eps the draw ran at, float32


class BarkerResult(NamedTuple):
    samples: object  # (N_kept, D) or a tree of (N_kept, ...) leaves; chains first
    stats: BarkerStats
    step_size: torch.Tensor  # frozen (averaged) eps after burn
    acc_rate: torch.Tensor  # mean post-burn acceptance probability
    final_theta: object  # last state (resume)
    final_da: DualAveragingState  # adaptation carry (resume)
    final_welford: WelfordState  # scale-adaptation carry (resume)
    final_step: torch.Tensor  # global draw counter after the run
    scale: torch.Tensor  # (D,) proposal stds the post-burn phase uses


def _softplus(x):
    # log(1 + e^x) without torch's linear cut-off above 20, as jax.nn.softplus
    return torch.logaddexp(x, torch.zeros_like(x))


def init_barker_da(config: BarkerConfig, chains: int, device, dtype=torch.float32
                   ) -> DualAveragingState:
    """Every chain's dual-averaging state at ``config.step_size``, (C,)
    tensors in float32 for a float32 or narrower chain, as the JAX package
    keeps it, and in float64 for a float64 chain (float32 adaptation would
    round a float64 chain's acceptances to float32 and drift by 1e-7)."""
    da_dtype = torch.promote_types(dtype, torch.float32)
    return da_init(torch.full((chains,), config.step_size, dtype=da_dtype), dtype=da_dtype,
                   device=device)


def _draw_scale(config: BarkerConfig, scale_arr, wf: WelfordState, n: int, dtype):
    """(C, D) proposal stds at global draw ``n``: the given scale, or from
    ``3*burn//4`` on each chain's Welford estimate once it has > 2 draws."""
    c = wf.count.shape[0]
    base = scale_arr.expand(c, scale_arr.shape[-1])
    if not config.adapt_scale or n < (3 * config.burn) // 4:
        return base
    var = torch.clamp(welford_variance(wf), min=1e-20)
    return torch.where((wf.count > 2)[:, None], torch.sqrt(var).to(dtype), base)


def _run_barker(key: int, theta, fn, config: BarkerConfig, scale, init_da=None,
                init_welford=None, start_step: int = 0, _noise=None, _margins=None):
    """``config.num_samples`` draws of C chains from ``theta`` (C, D); a
    BarkerResult with the chain axis first on every field."""
    c, dims = theta.shape
    dtype, device = theta.dtype, theta.device
    n_kept = config.num_samples // config.thin
    vg = torch.func.vmap(value_and_grad(fn))
    logp, g = vg(theta)
    da = init_da if init_da is not None else init_barker_da(config, c, device, dtype)
    wf = init_welford if init_welford is not None else welford_init(dims, dtype, device, (c,))
    scale_arr = torch.as_tensor(scale, dtype=dtype, device=device).expand(dims)
    w_start, w_end = config.burn // 4, (3 * config.burn) // 4

    samples = torch.empty((c, n_kept, dims), dtype=dtype, device=device)
    stats = BarkerStats(
        accept_prob=torch.empty((c, n_kept), dtype=torch.float32, device=device),
        accepted=torch.empty((c, n_kept), dtype=torch.bool, device=device),
        divergent=torch.empty((c, n_kept), dtype=torch.bool, device=device),
        step_size=torch.empty((c, n_kept), dtype=torch.float32, device=device),
    )
    neg_inf = torch.tensor(float("-inf"), device=device)
    for b in range(n_kept):
        div = torch.zeros((c,), dtype=torch.bool, device=device)
        for t in range(config.thin):
            i = b * config.thin + t
            n = start_step + i
            if _noise is None:
                gen = stream_generator(key, BARKER_STREAM, n, device)
                # the whole block of a sharded run's chains, then this batch's rows
                total, lo = chain_rows(c)
                nz = torch.randn((total, dims), generator=gen, dtype=dtype, device=gen.device)
                u_keep = torch.rand((total, dims), generator=gen, dtype=dtype, device=gen.device)
                u_mh = torch.rand((total,), generator=gen, dtype=torch.float32, device=gen.device)
                nz, u_keep, u_mh = (t[lo:lo + c].to(device) for t in (nz, u_keep, u_mh))
            else:
                nz = _noise["z"][i].reshape(c, dims)
                u_keep = _noise["u_keep"][i].reshape(c, dims)
                u_mh = _noise["u_mh"][i].reshape(c)
            if n < config.burn or not config.adapt_step_size:
                eps = da.step_size.to(dtype)
            else:
                eps = torch.exp(da.log_eps_bar).to(dtype)
            s = _draw_scale(config, scale_arr, wf, n, dtype)
            z = eps[:, None] * s * nz
            # keep +z with probability sigmoid(z * g), else flip: the Barker skew
            p_keep = torch.sigmoid(z * g)
            keep = u_keep < p_keep
            d = torch.where(keep, z, -z)
            y = theta + d
            lpy, gy = vg(y)
            # lpy == -inf is a hard-support step-out: a clean rejection, not a
            # divergence; NaN / +inf, or a non-finite gradient at a finite
            # lpy, is divergent
            outside = torch.isneginf(lpy)
            bad = (torch.isnan(lpy) | torch.isposinf(lpy)
                   | (~outside & ~torch.isfinite(gy).all(dim=-1)))
            # q(x|y)/q(y|x) per coordinate: softplus(-d*g) - softplus(d*gy)
            corr = torch.sum(_softplus(-d * g) - _softplus(d * gy), dim=-1)
            log_ratio = torch.where(bad | outside, neg_inf,
                                    (lpy - logp).to(torch.float32) + corr)
            alpha = torch.exp(torch.clamp(log_ratio, max=0.0))
            log_u = torch.log(u_mh)
            accept = log_u < log_ratio
            if _margins is not None:
                inf = torch.full_like(log_ratio, float("inf"))
                m_mh = torch.where(torch.isfinite(log_ratio), (log_u - log_ratio).abs(), inf)
                _margins.append(torch.minimum(m_mh.min(), (u_keep - p_keep).abs().min()))
            theta = torch.where(accept[:, None], y, theta)
            logp = torch.where(accept, lpy, logp)
            g = torch.where(accept[:, None], gy, g)
            if config.adapt_step_size and n < config.burn:
                lar = torch.where(bad, torch.full_like(log_ratio, float("nan")), log_ratio)
                da = da_update(da, lar, n, desired_accept_rate=config.desired_accept_rate)
            if config.adapt_scale and w_start <= n < w_end:
                wf = welford_update(wf, theta)
            div = div | bad
        samples[:, b] = theta
        stats.accept_prob[:, b] = alpha
        stats.accepted[:, b] = accept
        stats.divergent[:, b] = div
        stats.step_size[:, b] = eps.to(torch.float32)

    burn_kept = config.burn // config.thin
    tail = stats.accept_prob[:, burn_kept:] if n_kept > burn_kept else stats.accept_prob
    end = start_step + config.num_samples
    return BarkerResult(
        samples=samples, stats=stats,
        step_size=torch.exp(da.log_eps_bar) if config.adapt_step_size else da.step_size,
        acc_rate=torch.mean(tail, dim=1), final_theta=theta, final_da=da, final_welford=wf,
        final_step=torch.full((c,), end, dtype=torch.int32, device=device),
        scale=_draw_scale(config, scale_arr, wf, max(end, config.burn), dtype),
    )


def _ravel_scale(scale, theta0_tree):
    """A per-leaf scale tree ravels to (D,) in the state's leaf order; plain
    scalars and (D,) tensors pass through."""
    if scale is None:
        return 1.0
    if hasattr(scale, "ndim") or isinstance(scale, (int, float)):
        arr = torch.as_tensor(scale)
        if arr.ndim <= 1:
            return arr
    leaves = tree_leaves(tree_map(
        lambda leaf, s: torch.as_tensor(s, dtype=leaf.dtype, device=leaf.device).expand(
            leaf.shape), theta0_tree, scale))
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def _one_chain(r: BarkerResult, unravel) -> BarkerResult:
    """Drop the chain axis of a one-chain batch; unravel a tree state."""
    def first(t):
        return t[0]

    r = BarkerResult(
        samples=r.samples[0], stats=BarkerStats(*(first(t) for t in r.stats)),
        step_size=first(r.step_size), acc_rate=first(r.acc_rate),
        final_theta=first(r.final_theta),
        final_da=DualAveragingState(*(first(t) for t in dataclasses.astuple(r.final_da))),
        final_welford=WelfordState(*(first(t) for t in r.final_welford)),
        final_step=first(r.final_step), scale=first(r.scale))
    if unravel is not None:
        r = r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))
    return r


def _as_batch(state):
    """A one-chain carry (0-d / (D,) fields) with a leading chain axis."""
    if state is None:
        return None
    if isinstance(state, DualAveragingState):
        return DualAveragingState(*(torch.as_tensor(t).reshape(1) for t in
                                    dataclasses.astuple(state)))
    return WelfordState(torch.as_tensor(state.count).reshape(1), state.mean.reshape(1, -1),
                        state.m2.reshape(1, -1))


def run_barker(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: BarkerConfig,
    scale=None,
    data=None,
    init_da: DualAveragingState | None = None,
    init_welford: WelfordState | None = None,
    start_step: int = 0,
    pass_grad=None,
    _noise=None,
    _margins=None,
) -> BarkerResult:
    """Barker proposal sampling; see the module docstring.

    ``theta0`` may be flat (D,) or a parameter tree (samples keep leaf
    shapes).  ``scale``: per-coordinate proposal stds, a scalar, a (D,)
    tensor or (tree states) a per-leaf tree; seed it from ``advi(...)``
    stds or ``laplace_approx``, or set ``config.adapt_scale`` to learn it
    during burn.  ``data=`` calls ``log_prob_fn(theta, data)``.  ``key`` is
    an integer seed; the chain runs on the device of ``theta0`` (the card
    for a start that is not a tensor).

    Chunked runs resume bit for bit: feed ``final_theta`` / ``final_da`` /
    ``final_welford`` / ``final_step`` back with the same key and config.
    """
    if start_step == 0 and config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0 = place_start(theta0)
    scale_f = (_ravel_scale(scale, theta0) if is_param_tree(theta0)
               else (1.0 if scale is None else scale))
    theta0f, fn, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    r = _run_barker(key, theta0f[None], fn, config, scale_f, init_da=_as_batch(init_da),
                    init_welford=_as_batch(init_welford), start_step=int(start_step),
                    _noise=_noise, _margins=_margins)
    return _one_chain(r, unravel)


def run_barker_chains(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: BarkerConfig,
    num_chains: int,
    scale=None,
    data=None,
    theta0_is_stacked=None,
    _noise=None,
    _margins=None,
) -> BarkerResult:
    """Independent Barker chains as one (C, D) batch; each chain adapts its
    own step size and, with ``adapt_scale``, its own scale.  Every field of
    the result carries the chain axis first (``samples`` (C, N_kept, D)).
    ``theta0`` may be (D,) (copied to every chain), (C, D), or a tree,
    single or with a leading C axis on every leaf (``theta0_is_stacked``
    overrides the detection)."""
    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    lp = _bind_data(log_prob_fn, data)
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        scale_f = _ravel_scale(scale, template)
        _, fn, unravel = _prep_flat(lp, template, None)
        theta0 = _ravel_chains(stacked)
    else:
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
        scale_f = 1.0 if scale is None else scale
        _, fn, unravel = _prep_flat(lp, theta0[0], None)
    r = _run_barker(key, theta0, fn, config, scale_f, _noise=_noise, _margins=_margins)
    if unravel is not None:
        r = r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))
    return r
