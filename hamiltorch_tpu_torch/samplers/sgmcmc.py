"""Stochastic-gradient MCMC: SGLD, pSGLD, SGHMC and their cyclical forms.

Counterpart of ``hamiltorch_tpu/samplers/sgmcmc.py``.  One random
minibatch gradient a step and no Metropolis correction:

* SGLD (Welling & Teh 2011):   theta += (eps/2) P ghat + N(0, eps*T*P)
* pSGLD (Li et al. 2016):      P from an RMSProp accumulator of ghat^2
* SGHMC (Chen, Fox & Guestrin 2014), SGD-with-momentum form:
      v <- (1 - friction) v + eps P ghat + N(0, 2*friction*eps*T*P)
      theta <- theta + v
* cSGLD / cSGHMC (Zhang et al. 2020): cosine cycles of the step size, each
  an exploration stage (noise-free ascent, nothing kept) and a sampling
  stage of the base dynamics.

``ghat = num_terms * grad(term_fn(theta, m))`` is the unbiased estimate
from one uniformly drawn term, on the split-HMC protocol
``term_fn(theta, m[, data])`` (``m`` a host int;
``models.bnn.define_split_model_log_prob`` builds it), so a split-HMC
workload moves to SG-MCMC by swapping the runner.  As in the JAX package,
pSGLD omits the Gamma(theta) drift correction and SGHMC's noise uses the
full 2*friction*eps (Bhat = 0).

Where the JAX package ``vmap``s whole single-chain runs over split keys,
the runners here take every chain at once on a leading axis.  Each chain
draws its own term each step, so the chains are grouped by term and each
group's gradient is one ``vmap``-ed evaluation
(``integrators.splitting._grad_by_term``).  A non-finite update is
rejected for its chain, the step skipped and ``stats.divergent`` set:
divergences are data, never exceptions.

Precision: SGLD's step size is a float32 scalar (the decay schedule
computes in float32), and the update runs in the promotion of the leaf's
dtype with float32 (float32 for a bfloat16 leaf, float64 for a float64
one) before landing back in the leaf's dtype, as JAX's strong float32
scalar makes it; SGHMC's scalars are Python floats and its update keeps
the leaf's dtype.

Random numbers, keyed on the global step ``g`` so that a chunked run
resumed from ``final_theta`` / ``final_aux`` / ``final_step`` equals the
straight run bit for bit: chain ``c``'s term at step ``g`` is a hash of
(seed, c, g) on the host (``utils.rng.sg_term_indices``), and its normals
come from one generator a thinning window, seeded by (seed, c, the
window's first step) (``utils.rng.draw_sg_window``).  ``_noise`` (a test
hook) hands in the terms and normals instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..integrators.splitting import _grad_by_term
from ..utils.convert import place_start
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map, tree_unflatten_like
from ..utils.rng import draw_sg_window, sg_term_indices
from .driver import _tree_where

@dataclasses.dataclass(frozen=True)
class SGLDConfig:
    """Configuration of :func:`run_sgld`.

    ``num_samples`` counts ALL transitions; with ``thin > 1`` every
    thin-th state is kept (``num_samples`` must be divisible by ``thin``).
    ``step_size`` may decay polynomially: ``eps_t = step_size * (1 + t /
    decay_t0) ** (-decay_gamma)`` (gamma = 0 keeps it constant).
    ``temperature`` scales the injected noise (T < 1: a cold posterior).
    ``preconditioner="rmsprop"`` is pSGLD; it and ``inv_mass`` (a static
    diagonal preconditioner) exclude each other.
    """

    num_samples: int
    step_size: float
    thin: int = 1
    decay_gamma: float = 0.0
    decay_t0: float = 1.0
    temperature: float = 1.0
    preconditioner: str = "none"  # "none" | "rmsprop"
    rmsprop_alpha: float = 0.99
    rmsprop_eps: float = 1e-5

    def __post_init__(self):
        _validate_sg_common(self)
        if self.preconditioner not in ("none", "rmsprop"):
            raise ValueError(
                f"preconditioner={self.preconditioner!r}; must be 'none' or 'rmsprop'"
            )
        if not 0.0 < self.rmsprop_alpha < 1.0:
            raise ValueError("rmsprop_alpha must be in (0, 1)")
        if not self.rmsprop_eps > 0:
            raise ValueError("rmsprop_eps must be positive")
        if self.decay_gamma < 0 or not self.decay_t0 > 0:
            raise ValueError("decay_gamma must be >= 0 and decay_t0 > 0")


@dataclasses.dataclass(frozen=True)
class SGHMCConfig:
    """Configuration of :func:`run_sghmc`.

    ``friction`` is the per-step momentum decay in (0, 1]; the injected
    noise variance is ``2 * friction * step_size * temperature * P`` per
    coordinate (P = inv_mass, default 1).  ``resample_momentum_every=k``
    refreshes v from its stationary marginal N(0, step_size * temperature
    * P) every k steps (0 = persistent momentum).
    """

    num_samples: int
    step_size: float
    thin: int = 1
    friction: float = 0.05
    temperature: float = 1.0
    resample_momentum_every: int = 0

    def __post_init__(self):
        _validate_sg_common(self)
        if not 0.0 < self.friction <= 1.0:
            raise ValueError("friction must be in (0, 1]")
        if self.resample_momentum_every < 0:
            raise ValueError("resample_momentum_every must be >= 0")


def _validate_sg_common(config) -> None:
    if config.num_samples < 1:
        raise ValueError(f"num_samples={config.num_samples}; must be >= 1")
    if not config.step_size > 0:
        raise ValueError("step_size must be positive")
    if config.thin < 1:
        raise ValueError("thin must be >= 1")
    if config.num_samples % config.thin:
        raise ValueError(
            f"num_samples={config.num_samples} must be divisible by thin={config.thin}"
        )
    if not config.temperature > 0:
        raise ValueError("temperature must be positive")


class SGMCMCStats(NamedTuple):
    """Per-kept-draw diagnostics."""

    step_size: torch.Tensor  # eps_t at the kept step (float32)
    grad_norm: torch.Tensor  # l2 norm of the gradient ESTIMATE at the kept step
    divergent: torch.Tensor  # bool: any non-finite (skipped) step in the window


class SGMCMCResult(NamedTuple):
    samples: object  # (N, D) or a tree of (N, ...) leaves; chains first for *_chains
    stats: SGMCMCStats
    final_theta: object
    final_aux: object  # SGHMC momentum / pSGLD accumulator (resume), else None
    final_step: torch.Tensor  # global step counter after the run


def _leaf_noise(bufs: list, j: int, template):
    """Step ``j``'s standard normals of a window, one per leaf: ``bufs``
    holds (C, steps, ...) blocks in leaf order; returns a tree shaped like
    ``template`` (the (C, ...) chain state)."""
    return tree_unflatten_like(template, [buf[:, j] for buf in bufs])


def _resolve_precond(inv_mass, theta0, what: str):
    """None, or a diagonal preconditioner matching ``theta0``'s structure
    (one chain's) on its device."""
    if inv_mass is None:
        return None
    if not is_param_tree(theta0):
        pre = torch.as_tensor(inv_mass, device=theta0.device)
        if pre.shape != theta0.shape:
            raise ValueError(
                f"{what}: inv_mass shape {tuple(pre.shape)} != theta {tuple(theta0.shape)} "
                "(diagonal preconditioners only)"
            )
        return pre
    # a tree state: per-leaf diagonals (scalars broadcast)
    return tree_map(
        lambda leaf, m: torch.as_tensor(m, dtype=leaf.dtype, device=leaf.device)
        .expand(leaf.shape), theta0, inv_mass)


def _make_ghat(term_fn, num_terms: int, data, psum_axis=None, prior_fn=None):
    """``ghat(theta, terms)``: every chain's unbiased gradient estimate,
    ``num_terms`` times the gradient of its own term ``terms[c]`` (host
    ints); the chains are grouped by term, one ``vmap``-ed gradient a
    distinct term.

    With ``psum_axis`` (a process group or mesh dimension name,
    ``parallel.sharding.resolve_group``), ``term_fn`` sees only its rank's
    batch shard and the batch's term gradients are summed over the group
    in one all-reduce BEFORE the ``num_terms`` scaling; ``prior_fn`` then
    enters once, locally (every rank holds the whole theta): the prior
    must not ride the sum or it counts once per rank."""
    group = None
    if psum_axis is not None:
        from ..parallel.sharding import resolve_group

        group = resolve_group(psum_axis)
    prior_grad = None if prior_fn is None else torch.func.vmap(torch.func.grad(prior_fn))
    fn = term_fn if data is None else (lambda t, m: term_fn(t, m, data))
    scale = float(num_terms)
    grads = {}

    def grad_term(theta, m):
        if m not in grads:
            grads[m] = torch.func.vmap(torch.func.grad(lambda t, m=m: fn(t, m)))
        return grads[m](theta)

    def ghat(theta, terms):
        g = _grad_by_term(grad_term, theta, terms)
        if group is not None:
            from ..parallel.sharding import tree_group_sum

            g = tree_group_sum(g, group)
        g = tree_map(lambda leaf: scale * leaf, g)
        if prior_grad is not None:
            g = tree_map(torch.add, g, prior_grad(theta))
        return g

    return ghat


def _step_eps(config, t: int) -> torch.Tensor:
    """Polynomial decay eps_t as a float32 scalar (constant when
    ``decay_gamma == 0``)."""
    gamma = getattr(config, "decay_gamma", 0.0)
    if gamma == 0.0:
        return torch.tensor(config.step_size, dtype=torch.float32)
    t0 = getattr(config, "decay_t0", 1.0)
    return config.step_size * (1.0 + torch.tensor(float(t), dtype=torch.float32) / t0) ** (-gamma)


def _finite_select(new_tree, old_tree):
    """(selected_tree, ok): each chain keeps its old state when ANY leaf of
    its new one is non-finite; ``ok`` is (C,)."""
    ok = None
    for leaf in tree_leaves(new_tree):
        fin = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        ok = fin if ok is None else ok & fin
    return _tree_where(ok, new_tree, old_tree), ok


def _grad_norm(g) -> torch.Tensor:
    """(C,) float32 l2 norm of each chain's gradient estimate."""
    sq = [(leaf.to(torch.float32) ** 2).reshape(leaf.shape[0], -1).sum(dim=1)
          for leaf in tree_leaves(g)]
    return torch.sqrt(sum(sq))


def _work(leaf: torch.Tensor) -> torch.dtype:
    """The dtype a float32 scalar promotes ``leaf`` to under JAX's rules."""
    return torch.promote_types(leaf.dtype, torch.float32)


def _sgld_update(theta, g, z, p_tree, eps, temp):
    """theta + (eps/2) P g + sqrt(eps T P) z, leaf by leaf in the promoted
    precision, back in each leaf's dtype; ``z`` None adds no noise."""

    def leaf_update(t, gl, zl, pl):
        w = _work(t)
        t_, g_ = t.to(w), gl.to(w)
        if pl is None:
            out = t_ + 0.5 * eps * g_
            if zl is not None:
                out = out + torch.sqrt(eps * temp) * zl.to(w)
        else:
            p_ = pl.to(w)
            out = t_ + 0.5 * eps * p_ * g_
            if zl is not None:
                out = out + torch.sqrt(eps * temp * p_) * zl.to(w)
        return out.to(t.dtype)

    leaves_t, leaves_g = tree_leaves(theta), tree_leaves(g)
    leaves_z = tree_leaves(z) if z is not None else [None] * len(leaves_t)
    leaves_p = tree_leaves(p_tree) if p_tree is not None else [None] * len(leaves_t)
    return tree_unflatten_like(theta, [leaf_update(*a) for a in
                                       zip(leaves_t, leaves_g, leaves_z, leaves_p)])


class _Noise:
    """The terms and normals of a run: drawn a thinning window at a time
    from the seed, or replayed from ``_noise`` (``{"m": (S, C), "z": (S, C,
    ...) leaves, "fresh": (S, C, ...) leaves}``, S the run's steps)."""

    def __init__(self, key, num_terms: int, noise=None):
        self.key, self.num_terms, self.noise = key, num_terms, noise
        self.z = self.fresh = None

    def window(self, theta, first_step: int, steps: int, extra: int = 0):
        if self.noise is None:
            self.z, self.fresh = draw_sg_window(self.key, first_step, tree_leaves(theta), steps,
                                                extra)
        self.n_fresh = 0

    def terms(self, theta, step: int, i: int) -> list:
        if self.noise is None:
            return sg_term_indices(self.key, step, tree_leaves(theta)[0].shape[0],
                                   self.num_terms)
        return [int(m) for m in self.noise["m"][i]]

    def normals(self, theta, j: int, i: int):
        if self.noise is None:
            return _leaf_noise(self.z, j, theta)
        return tree_map(lambda zl: zl[i], self.noise["z"])

    def refresh(self, theta, i: int):
        if self.noise is None:
            out = _leaf_noise(self.fresh, self.n_fresh, theta)
            self.n_fresh += 1
            return out
        return tree_map(lambda zl: zl[i], self.noise["fresh"])


def _buffers(theta, kept: int):
    """(samples, grad-norm, divergent) buffers of a chain batch: (C, kept, ...)."""
    leaf0 = tree_leaves(theta)[0]
    c, device = leaf0.shape[0], leaf0.device
    samples = tree_map(lambda leaf: leaf.new_empty((c, kept) + tuple(leaf.shape[1:])), theta)
    return (samples, torch.empty((c, kept), dtype=torch.float32, device=device),
            torch.empty((c, kept), dtype=torch.bool, device=device))


def _run_sgld(key, theta0, term_fn, num_terms: int, config: SGLDConfig, pre=None, data=None,
              init_aux=None, start_step: int = 0, psum_axis=None, prior_fn=None,
              _noise=None) -> SGMCMCResult:
    """SGLD / pSGLD over the chains on the leading axis of every leaf of
    ``theta0``; ``init_aux`` / ``start_step`` continue an earlier run.
    Stats are (C, kept)."""
    ghat = _make_ghat(term_fn, num_terms, data, psum_axis, prior_fn)
    rmsprop = config.preconditioner == "rmsprop"
    temp, thin = config.temperature, config.thin
    kept = config.num_samples // thin
    if init_aux is None and rmsprop:
        init_aux = tree_map(torch.zeros_like, theta0)
    noise = _Noise(key, num_terms, _noise)
    samples, gn_buf, div_buf = _buffers(theta0, kept)
    eps_kept = []
    theta, aux = theta0, init_aux
    for b in range(kept):
        g0 = start_step + b * thin
        noise.window(theta, g0, thin)
        div = torch.zeros_like(div_buf[:, 0])
        for j in range(thin):
            i = b * thin + j
            g = ghat(theta, noise.terms(theta, g0 + j, i))
            eps = _step_eps(config, g0 + j)
            if rmsprop:
                a = config.rmsprop_alpha
                aux_new = tree_map(lambda v, gl: a * v + (1 - a) * gl * gl, aux, g)
                p_tree = tree_map(lambda v: 1.0 / (torch.sqrt(v) + config.rmsprop_eps), aux_new)
            else:
                aux_new, p_tree = aux, pre
            new = _sgld_update(theta, g, noise.normals(theta, j, i), p_tree, eps, temp)
            theta, ok = _finite_select(new, theta)
            if rmsprop:
                aux = _tree_where(ok, aux_new, aux)
            div |= ~ok
        tree_map(lambda buf, t: buf[:, b].copy_(t), samples, theta)
        gn_buf[:, b] = _grad_norm(g)
        div_buf[:, b] = div
        eps_kept.append(float(eps))
    return _result(samples, eps_kept, gn_buf, div_buf, theta, aux,
                   start_step + config.num_samples)


def _run_sghmc(key, theta0, term_fn, num_terms: int, config: SGHMCConfig, pre=None, data=None,
               init_aux=None, start_step: int = 0, psum_axis=None, prior_fn=None,
               _noise=None) -> SGMCMCResult:
    """SGHMC over the chains on the leading axis of every leaf of
    ``theta0``; ``init_aux`` (the momentum) / ``start_step`` continue an
    earlier run.  Stats are (C, kept)."""
    ghat = _make_ghat(term_fn, num_terms, data, psum_axis, prior_fn)
    eps, alpha, temp = config.step_size, config.friction, config.temperature
    noise_std = (2.0 * alpha * eps * temp) ** 0.5  # x sqrt(P) per leaf below
    v_std = (eps * temp) ** 0.5  # the stationary marginal of v is N(0, eps*T*P)
    thin, every = config.thin, config.resample_momentum_every
    kept = config.num_samples // thin
    if init_aux is None:
        init_aux = tree_map(torch.zeros_like, theta0)
    pre = None if pre is None else tree_map(lambda p, t: p.to(t.dtype), pre, theta0)
    noise = _Noise(key, num_terms, _noise)
    samples, gn_buf, div_buf = _buffers(theta0, kept)
    theta, v = theta0, init_aux

    def with_pre(fn_plain, fn_pre, *trees):
        return tree_map(fn_plain, *trees) if pre is None else tree_map(fn_pre, *trees, pre)

    for b in range(kept):
        g0 = start_step + b * thin
        refreshes = sum(1 for j in range(thin) if every and (g0 + j) % every == 0)
        noise.window(theta, g0, thin, refreshes)
        div = torch.zeros_like(div_buf[:, 0])
        for j in range(thin):
            i = b * thin + j
            if every and (g0 + j) % every == 0:
                v = with_pre(lambda zl: v_std * zl,
                             lambda zl, pl: v_std * torch.sqrt(pl) * zl,
                             noise.refresh(theta, i))
            g = ghat(theta, noise.terms(theta, g0 + j, i))
            z = noise.normals(theta, j, i)
            v_new = with_pre(lambda vl, gl, zl: (1.0 - alpha) * vl + eps * gl + noise_std * zl,
                             lambda vl, gl, zl, pl: ((1.0 - alpha) * vl + eps * pl * gl
                                                     + noise_std * torch.sqrt(pl) * zl),
                             v, g, z)
            t_new = tree_map(lambda t, vl: t + vl, theta, v_new)
            (theta, v), ok = _finite_select((t_new, v_new), (theta, v))
            div |= ~ok
        tree_map(lambda buf, t: buf[:, b].copy_(t), samples, theta)
        gn_buf[:, b] = _grad_norm(g)
        div_buf[:, b] = div
    return _result(samples, [float(torch.tensor(eps, dtype=torch.float32))] * kept, gn_buf,
                   div_buf, theta, v, start_step + config.num_samples)


def _result(samples, eps_kept, gn_buf, div_buf, theta, aux, final_step) -> SGMCMCResult:
    """An SGMCMCResult of a chain batch: stats (C, kept), ``final_step`` (C,)
    (the JAX package's vmapped runs give one per chain)."""
    c, device = gn_buf.shape[0], gn_buf.device
    eps = torch.tensor(eps_kept, dtype=torch.float32, device=device).expand(c, -1).clone()
    return SGMCMCResult(
        samples=samples,
        stats=SGMCMCStats(step_size=eps, grad_norm=gn_buf, divergent=div_buf),
        final_theta=theta, final_aux=aux,
        final_step=torch.full((c,), final_step, dtype=torch.int32, device=device),
    )


def _prep(key, term_fn, num_terms, theta0, config, inv_mass, data, what):
    """(theta0 as tensors, preconditioner, data on theta0's device)."""
    if num_terms < 1:
        raise ValueError(f"num_terms={num_terms}; must be >= 1")
    theta0 = place_start(theta0)
    pre = _resolve_precond(inv_mass, theta0, what)
    if pre is not None and getattr(config, "preconditioner", "none") == "rmsprop":
        raise ValueError(
            "inv_mass (static preconditioner) and preconditioner='rmsprop' "
            "are mutually exclusive — pSGLD estimates its own"
        )
    if data is not None:
        device = tree_leaves(theta0)[0].device
        data = tree_map(lambda a: a if isinstance(a, torch.Tensor)
                        else torch.as_tensor(a, device=device), data)
    return theta0, pre, data


def _first_chain(res):
    """A one-chain batch's result without its chain axis."""
    def first(t):
        return t[0]

    return type(res)(*(tree_map(first, f) for f in res))


def _one_chain(runner, key, term_fn, num_terms, theta0, config, inv_mass, data, init_aux,
               start_step, what, _noise):
    theta0, pre, data = _prep(key, term_fn, num_terms, theta0, config, inv_mass, data, what)
    if _noise is not None:
        _noise = {k: tree_map(lambda t: t[:, None], v) for k, v in _noise.items()}
    add = lambda tree: tree_map(lambda t: t.unsqueeze(0), tree)  # noqa: E731
    res = runner(key, add(theta0), term_fn, num_terms, config, pre, data,
                 None if init_aux is None else add(tree_map(torch.as_tensor, init_aux)),
                 int(start_step), _noise=_noise)
    return _first_chain(res)


def run_sgld(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config: SGLDConfig,
    inv_mass=None,
    data=None,
    init_aux=None,
    start_step: int = 0,
    _noise=None,
) -> SGMCMCResult:
    """Stochastic-gradient Langevin dynamics over a term-decomposed target.

    ``term_fn(theta, m)`` (``term_fn(theta, m, data)`` when ``data`` is
    given) returns one term of ``log p(theta) = sum_m term(theta, m)``, the
    split-HMC protocol, so ``define_split_model_log_prob`` feeds it
    directly; ``num_terms=1`` with ``lambda t, m: lp(t)`` is unadjusted
    Langevin.  ``theta0`` may be flat (D,) or a parameter tree (``samples``
    keep the leaf shapes behind a kept-draws axis).  Chunked runs resume
    bit for bit: feed a run's ``final_theta`` / ``final_aux`` /
    ``final_step`` back as ``theta0`` / ``init_aux`` / ``start_step`` (at a
    multiple of ``thin``).  ``key`` is an integer seed; the chain runs on
    the device of ``theta0`` (the card for a start that is not a tensor).
    ``_noise = {"m": (S,), "z": (S, ...) leaves}`` replaces the drawn terms
    and normals (a test hook).
    """
    return _one_chain(_run_sgld, key, term_fn, num_terms, theta0, config, inv_mass, data,
                      init_aux, start_step, "run_sgld", _noise)


def run_sghmc(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config: SGHMCConfig,
    inv_mass=None,
    data=None,
    init_aux=None,
    start_step: int = 0,
    _noise=None,
) -> SGMCMCResult:
    """Stochastic-gradient HMC (momentum form); the ``term_fn`` protocol and
    the chunked-resume contract of :func:`run_sgld` (``init_aux`` carries
    the momentum).  ``_noise`` adds ``"fresh"``, the refresh normals of
    every step (read at the refresh steps)."""
    return _one_chain(_run_sghmc, key, term_fn, num_terms, theta0, config, inv_mass, data,
                      init_aux, start_step, "run_sghmc", _noise)


def _stack_chains(theta0, num_chains, theta0_is_stacked):
    """(one chain's template, theta0 with a leading chain axis)."""
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        return stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
    if theta0.ndim == 1:
        return theta0, theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
    return theta0[0], theta0


def _run_chains(runner, key, term_fn, num_terms, theta0, config, inv_mass, data, num_chains,
                theta0_is_stacked, what, _noise=None):
    template, theta0 = _stack_chains(theta0, num_chains, theta0_is_stacked)
    _, pre, data = _prep(key, term_fn, num_terms, template, config, inv_mass, data, what)
    return runner(key, theta0, term_fn, num_terms, config, pre, data, _noise=_noise)


def run_sgld_chains(key, term_fn, num_terms, theta0, config: SGLDConfig, num_chains: int,
                    inv_mass=None, data=None, theta0_is_stacked=None,
                    _noise=None) -> SGMCMCResult:
    """Independent SGLD chains batched on a leading axis (samples, stats
    and ``final_step`` gain a leading ``num_chains`` axis).  Chain ``c``
    draws its own terms and normals; ``_noise`` as in :func:`run_sgld` with
    a chain axis after the step axis."""
    return _run_chains(_run_sgld, key, term_fn, num_terms, theta0, config, inv_mass, data,
                       num_chains, theta0_is_stacked, "run_sgld_chains", _noise)


def run_sghmc_chains(key, term_fn, num_terms, theta0, config: SGHMCConfig, num_chains: int,
                     inv_mass=None, data=None, theta0_is_stacked=None,
                     _noise=None) -> SGMCMCResult:
    """Independent SGHMC chains batched on a leading axis."""
    return _run_chains(_run_sghmc, key, term_fn, num_terms, theta0, config, inv_mass, data,
                       num_chains, theta0_is_stacked, "run_sghmc_chains", _noise)


# ---------------------------------------------------------------------------
# Cyclical SG-MCMC (cSGLD / cSGHMC)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSGMCMCConfig:
    """Configuration of :func:`run_csgmcmc` (Zhang et al. 2020, "Cyclical
    Stochastic Gradient MCMC for Bayesian Deep Learning").

    ``num_cycles`` cycles of ``cycle_length`` steps under the cosine
    schedule ``eps_t = (step_size / 2) * (cos(pi * (t mod L) / L) + 1)``.
    The first ``exploration_steps`` of every cycle are noise-free
    preconditioned gradient ascent, nothing kept; the remaining
    ``sampling_steps`` run the base dynamics (``base="sgld"`` or
    ``"sghmc"``) and keep every ``thin``-th state, tagged with its cycle:
    ``num_cycles * sampling_steps / thin`` snapshots.
    """

    num_cycles: int
    cycle_length: int
    step_size: float
    exploration_frac: float = 0.8
    thin: int = 1
    temperature: float = 1.0
    base: str = "sgld"  # "sgld" | "sghmc"
    friction: float = 0.05  # sghmc base only

    def __post_init__(self):
        if self.num_cycles < 1 or self.cycle_length < 2:
            raise ValueError(
                f"num_cycles={self.num_cycles} (>=1) and cycle_length="
                f"{self.cycle_length} (>=2) required"
            )
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")
        if not 0.0 <= self.exploration_frac < 1.0:
            raise ValueError("exploration_frac must be in [0, 1)")
        if self.base not in ("sgld", "sghmc"):
            raise ValueError(f"base={self.base!r}; must be 'sgld' or 'sghmc'")
        if not 0.0 < self.friction <= 1.0:
            raise ValueError("friction must be in (0, 1]")
        if not self.temperature > 0:
            raise ValueError("temperature must be positive")
        if self.thin < 1:
            raise ValueError("thin must be >= 1")
        # exploration_steps floors, so exploration_frac < 1 always leaves
        # at least one sampling step
        if self.sampling_steps % self.thin:
            raise ValueError(
                f"sampling steps per cycle ({self.sampling_steps}) must be "
                f"divisible by thin={self.thin}"
            )

    @property
    def exploration_steps(self) -> int:
        return int(self.exploration_frac * self.cycle_length)

    @property
    def sampling_steps(self) -> int:
        return self.cycle_length - self.exploration_steps


class CSGMCMCResult(NamedTuple):
    samples: object  # (K, ...) snapshots, K = num_cycles * kept a cycle
    cycle: torch.Tensor  # (K,) int32: the cycle of each snapshot
    stats: SGMCMCStats  # per snapshot (step size at the kept step, grad norm, div)
    final_theta: object
    final_aux: object  # momentum (sghmc) or None


def _run_csgmcmc(key, theta0, term_fn, num_terms: int, config: CSGMCMCConfig, pre=None,
                 data=None, psum_axis=None, prior_fn=None, _noise=None) -> CSGMCMCResult:
    """Cyclical SG-MCMC over the chains on the leading axis of every leaf of
    ``theta0``.  ``_noise`` as for SGLD over all ``num_cycles *
    cycle_length`` steps (the exploration steps read only ``"m"``)."""
    ghat = _make_ghat(term_fn, num_terms, data, psum_axis, prior_fn)
    ell, temp, alpha = config.cycle_length, config.temperature, config.friction
    sghmc = config.base == "sghmc"
    thin = config.thin
    per_cycle = config.sampling_steps // thin
    kept = config.num_cycles * per_cycle
    noise = _Noise(key, num_terms, _noise)
    samples, gn_buf, div_buf = _buffers(theta0, kept)
    eps_kept = []

    def eps_at(t: int) -> torch.Tensor:
        pos = torch.tensor(float(t % ell), dtype=torch.float32)
        return (config.step_size / 2.0) * (torch.cos(math.pi * pos / ell) + 1.0)

    def one_step(theta, v, step: int, z):
        """One update at global step ``step``; ``z`` None in the exploration
        stage (deterministic ascent, Zhang et al. section 3.2)."""
        g = ghat(theta, noise.terms(theta, step, step))
        eps = eps_at(step)
        if sghmc:
            ns = torch.sqrt(2.0 * alpha * eps * temp)

            def v_leaf(vl, gl, zl, pl):
                w = _work(vl)
                out = (1.0 - alpha) * vl.to(w)
                if pl is None:
                    out = out + eps * gl.to(w)
                    if zl is not None:
                        out = out + ns * zl.to(w)
                else:
                    p_ = pl.to(w)
                    out = out + eps * p_ * gl.to(w)
                    if zl is not None:
                        out = out + ns * torch.sqrt(p_) * zl.to(w)
                return out

            leaves_v = tree_leaves(v)
            leaves_z = tree_leaves(z) if z is not None else [None] * len(leaves_v)
            leaves_p = tree_leaves(pre) if pre is not None else [None] * len(leaves_v)
            v_work = [v_leaf(*a) for a in zip(leaves_v, tree_leaves(g), leaves_z, leaves_p)]
            t_new = tree_unflatten_like(theta, [(t.to(vw.dtype) + vw).to(t.dtype) for t, vw in
                                                zip(tree_leaves(theta), v_work)])
            v_new = tree_unflatten_like(v, [vw.to(vl.dtype) for vw, vl in zip(v_work, leaves_v)])
            (theta, v), ok = _finite_select((t_new, v_new), (theta, v))
        else:
            theta, ok = _finite_select(_sgld_update(theta, g, z, pre, eps, temp), theta)
        return theta, v, ok, g, eps

    theta, v = theta0, tree_map(torch.zeros_like, theta0)
    cycles = []
    for cyc in range(config.num_cycles):
        base_step = cyc * ell
        for s in range(config.exploration_steps):
            theta, v, _, _, _ = one_step(theta, v, base_step + s, None)
        for b in range(per_cycle):
            g0 = base_step + config.exploration_steps + b * thin
            noise.window(theta, g0, thin)
            div = torch.zeros_like(div_buf[:, 0])
            for j in range(thin):
                theta, v, ok, g, eps = one_step(theta, v, g0 + j,
                                                noise.normals(theta, j, g0 + j))
                div |= ~ok
            k = cyc * per_cycle + b
            tree_map(lambda buf, t: buf[:, k].copy_(t), samples, theta)
            gn_buf[:, k] = _grad_norm(g)
            div_buf[:, k] = div
            eps_kept.append(float(eps))
            cycles.append(cyc)
    res = _result(samples, eps_kept, gn_buf, div_buf, theta, v, 0)
    c = gn_buf.shape[0]
    return CSGMCMCResult(
        samples=samples,
        cycle=torch.tensor(cycles, dtype=torch.int32, device=gn_buf.device).expand(c, -1).clone(),
        stats=res.stats,
        final_theta=theta,
        final_aux=v if sghmc else None,
    )


def run_csgmcmc(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config: CSGMCMCConfig,
    inv_mass=None,
    data=None,
    _noise=None,
) -> CSGMCMCResult:
    """Cyclical SG-MCMC (cSGLD / cSGHMC) over a term-decomposed target, on
    the ``term_fn(theta, m[, data])`` protocol of :func:`run_sgld`: each
    cycle's hot restart relocates the chain, each cool-down collects
    locally mixed snapshots (the standard recipe for multimodal BNN
    posteriors).  ``_noise`` as in :func:`run_sgld` over every step of the
    run (a test hook).  There is no chunked-resume contract (as in the JAX
    package)."""
    theta0, pre, data = _prep(key, term_fn, num_terms, theta0, config, inv_mass, data,
                              "run_csgmcmc")
    if _noise is not None:
        _noise = {k: tree_map(lambda t: t[:, None], v) for k, v in _noise.items()}
    res = _run_csgmcmc(key, tree_map(lambda t: t.unsqueeze(0), theta0), term_fn, num_terms,
                       config, pre, data, _noise=_noise)
    return _first_chain(res)


def _csgmcmc_sharded_adapter(key, theta0, term_fn, num_terms, config, pre=None, data=None,
                             init_aux=None, start_step=0, psum_axis=None, prior_fn=None):
    """Arity adapter for ``parallel.sharding._run_sgmcmc_sharded``, which
    threads (init_aux, start_step) resume slots the cyclical sampler does
    not have (a cycle's exploration stage re-derives its state; there is no
    chunked-resume contract)."""
    if init_aux is not None or start_step:
        raise ValueError(
            "cyclical SG-MCMC has no chunked-resume contract "
            "(init_aux/start_step unsupported)"
        )
    return _run_csgmcmc(key, theta0, term_fn, num_terms, config, pre, data, psum_axis,
                        prior_fn)


def run_csgmcmc_chains(key, term_fn, num_terms, theta0, config: CSGMCMCConfig,
                       num_chains: int, inv_mass=None, data=None, theta0_is_stacked=None,
                       _noise=None) -> CSGMCMCResult:
    """Independent cyclical SG-MCMC chains batched on a leading axis
    (samples, ``cycle`` and stats gain a leading ``num_chains`` axis)."""
    template, theta0 = _stack_chains(theta0, num_chains, theta0_is_stacked)
    _, pre, data = _prep(key, term_fn, num_terms, template, config, inv_mass, data,
                         "run_csgmcmc_chains")
    return _run_csgmcmc(key, theta0, term_fn, num_terms, config, pre, data, _noise=_noise)
