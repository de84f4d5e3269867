"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Counterpart of ``hamiltorch_tpu/samplers/elliptical.py``: the sampler for
models with a GAUSSIAN PRIOR and any likelihood (GP latents, BNNs with
Gaussian weight priors).  Each draw moves along the ellipse through the
current state and a fresh prior sample,

    f' = (f - mu) cos(t) + (nu - mu) sin(t) + mu,    nu ~ N(mu, Sigma),

slice-sampling the angle t: no step size, no tuning and no gradients, only
likelihood evaluations.  The bracket shrinks toward t = 0 on rejection, so
the loop ends (t = 0 gives f itself); ``max_shrink`` caps it, and a lane at
the cap keeps its state and flags ``stats.divergent``.  A non-finite
likelihood counts as -inf.  ``models.define_model_prior_and_lik`` gives
the (zero-mean Gaussian prior, likelihood) pair it takes: ``prior_scale``
from the per-leaf ``tau_list`` (std 1/sqrt(tau)).

The shrink loop, the one data-dependent loop, is a host loop over shrink
iterations across all C lanes with per-lane masks and one host read an
iteration ("is any lane still below its slice?"); every iteration
evaluates the likelihood of every lane in one ``torch.func.vmap`` batch,
as the JAX package's vmapped ``while_loop`` does, and a lane that has
found its slice keeps its proposal and its count.  Angles are computed as
``jax.random.uniform`` computes them from a unit uniform u (float32):
``t0 = max(0, u * 2 pi)`` and ``max(lo, u * (hi - lo) + lo)``, the
product and sum one fused multiply-add as XLA compiles it (``_scale``);
cos and sin are taken in the state's dtype.  Log-likelihoods are kept in float32, as
in the JAX package.

Random numbers: at global draw n ONE generator seeded by ``draw_seed(key,
0, ELLIPTICAL_STREAM + n)`` (``utils.rng.stream_generator``) draws every
lane's prior normals, slice-level uniform and first angle, then one (C,)
uniform at each shrink iteration, in order: lane c's k-th uniform does not
depend on how long the other lanes loop, and chunked runs reproduce the
straight run bit for bit.  ``_noise`` (a test hook) hands in ``{"nu": (S,
[C,] D), "u": (S, [C]), "t0": (S, [C]), "t_shrink": (S, [C,]
max_shrink)}`` unit draws instead (S draws; the chain axis for
``run_elliptical_chains``).  ``_margins`` (a test hook), when a list,
receives each draw's least distance of a slice test from its other outcome.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..ops.potential import make_flat_potential
from ..utils.convert import place_start
from ..utils.pytree import (
    is_param_tree,
    ravel_pytree_fn,
    stack_param_tree,
    tree_leaves,
    tree_map,
)
from ..utils.rng import ELLIPTICAL_STREAM, stream_generator
from .mclmc import _bind_data, _ravel_chains


@dataclasses.dataclass(frozen=True)
class EllipticalConfig:
    """Static configuration for :func:`run_elliptical`.

    ``max_shrink`` caps the angle-shrink loop of a draw (the expected count
    is 1-3; the cap guards numerically degenerate likelihoods, and hitting
    it flags ``stats.divergent``).
    """

    num_samples: int
    thin: int = 1
    max_shrink: int = 64

    def __post_init__(self):
        if self.num_samples < 1:
            raise ValueError(f"num_samples={self.num_samples}; must be >= 1")
        if self.thin < 1:
            raise ValueError("thin must be >= 1")
        if self.num_samples % self.thin:
            raise ValueError(
                f"num_samples={self.num_samples} must be divisible by "
                f"thin={self.thin}"
            )
        if self.max_shrink < 1:
            raise ValueError("max_shrink must be >= 1")


class EllipticalStats(NamedTuple):
    """Per-kept-draw diagnostics."""

    shrinks: torch.Tensor  # angle-shrink iterations the draw needed (int32)
    loglik: torch.Tensor  # log-likelihood of the kept state (float32)
    divergent: torch.Tensor  # shrink cap hit in the window


class EllipticalResult(NamedTuple):
    samples: object  # (N_kept, D) or a tree of (N_kept, ...) leaves; chains first
    stats: EllipticalStats
    final_theta: object  # last state (resume)
    final_loglik: torch.Tensor  # cached L(final_theta), float32 (resume)
    final_step: torch.Tensor  # global draw counter after the run


TWO_PI = 2.0 * math.pi


def _coerce_prior(prior_scale, prior_mean, dims: int, dtype, device):
    """The prior's scale and mean as tensors; the scale's ndim picks the
    draw form (a scalar, (D,) stds or a (D, D) lower-Cholesky factor)."""
    scale = torch.as_tensor(prior_scale, dtype=dtype, device=device)
    if scale.ndim > 2:
        raise ValueError(
            f"prior_scale must be a scalar, (D,) diag stds, or (D, D) "
            f"lower-Cholesky factor; got shape {tuple(scale.shape)}"
        )
    mean = (torch.zeros((dims,), dtype=dtype, device=device) if prior_mean is None
            else torch.as_tensor(prior_mean, dtype=dtype, device=device))
    return scale, mean


def _scale(u, lo, hi):
    """``max(lo, u * (hi - lo) + lo)`` in float32 with the product and the
    sum fused, as XLA compiles ``jax.random.uniform(key, (), float32, lo,
    hi)``: float32 products are exact in float64, so one rounding of the
    float64 sum gives the fused result."""
    width = (hi - lo).double()
    return torch.maximum(lo, (u.double() * width + lo.double()).to(torch.float32))


def _run_elliptical(key: int, theta, log_lik_fn, config: EllipticalConfig, prior_scale,
                    prior_mean, init_loglik=None, start_step: int = 0, _noise=None,
                    _margins=None) -> EllipticalResult:
    """``config.num_samples`` draws of C lanes from ``theta`` (C, D); every
    field of the result carries the lane axis first."""
    c, dims = theta.shape
    dtype, device = theta.dtype, theta.device
    n_kept = config.num_samples // config.thin
    vll = torch.func.vmap(log_lik_fn)
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=device)

    def ll(t):  # -inf outside the support: proposals there shrink away
        with torch.no_grad():
            v = vll(t)
        return torch.where(torch.isfinite(v), v, torch.full_like(v, float("-inf"))).to(
            torch.float32)

    def prior_draw(z):
        if prior_scale.ndim == 2:
            return prior_mean + z @ prior_scale.T
        return prior_mean + prior_scale * z

    f = theta
    llf = ll(f) if init_loglik is None else torch.as_tensor(init_loglik, device=device).to(
        torch.float32).reshape(c)
    samples = torch.empty((c, n_kept, dims), dtype=dtype, device=device)
    shrinks = torch.empty((c, n_kept), dtype=torch.int32, device=device)
    loglik = torch.empty((c, n_kept), dtype=torch.float32, device=device)
    divergent = torch.empty((c, n_kept), dtype=torch.bool, device=device)
    for b in range(n_kept):
        div = torch.zeros((c,), dtype=torch.bool, device=device)
        for s in range(config.thin):
            i = b * config.thin + s
            if _noise is None:
                gen = stream_generator(key, ELLIPTICAL_STREAM, start_step + i, device)
                nu_z = torch.randn((c, dims), generator=gen, dtype=dtype, device=gen.device)
                u = torch.rand((2, c), generator=gen, dtype=torch.float32, device=gen.device)
                nu_z, u_y, u_t0 = nu_z.to(device), u[0].to(device), u[1].to(device)

                def shrink_uniform(k):
                    return torch.rand((c,), generator=gen, dtype=torch.float32,
                                      device=gen.device).to(device)
            else:
                nu_z = _noise["nu"][i].reshape(c, dims)
                u_y, u_t0 = _noise["u"][i].reshape(c), _noise["t0"][i].reshape(c)
                t_shrink = _noise["t_shrink"][i].reshape(c, -1)

                def shrink_uniform(k):
                    return t_shrink[:, k]
            nu = prior_draw(nu_z)
            log_y = llf + torch.log(u_y)
            t = _scale(u_t0, torch.zeros_like(u_t0), two_pi)
            f_c, nu_c = f - prior_mean, nu - prior_mean

            def propose(angle):
                ad = angle.to(dtype)[:, None]
                return f_c * torch.cos(ad) + nu_c * torch.sin(ad) + prior_mean

            lo, hi = t - two_pi, t
            fp = propose(t)
            llp = ll(fp)
            n = torch.zeros((c,), dtype=torch.int32, device=device)
            active = llp <= log_y
            margin = (llp - log_y).abs()
            k = 0
            while k < config.max_shrink and bool(active.any()):
                # shrink each active lane's bracket toward 0 past its rejected angle
                neg = t < 0.0
                lo = torch.where(active & neg, t, lo)
                hi = torch.where(active & ~neg, t, hi)
                t_new = _scale(shrink_uniform(k), lo, hi)
                fp_new = propose(t_new)
                ll_new = ll(fp_new)
                t = torch.where(active, t_new, t)
                fp = torch.where(active[:, None], fp_new, fp)
                llp = torch.where(active, ll_new, llp)
                n = n + active.to(torch.int32)
                k += 1
                margin = torch.where(active, torch.minimum(margin, (ll_new - log_y).abs()), margin)
                active = active & (llp <= log_y)
            if _margins is not None:
                _margins.append(margin.min())
            ok = llp > log_y  # False only at the shrink cap: hold the state
            f = torch.where(ok[:, None], fp, f)
            llf = torch.where(ok, llp, llf)
            div = div | ~ok
        samples[:, b] = f
        shrinks[:, b] = n
        loglik[:, b] = llf
        divergent[:, b] = div
    return EllipticalResult(
        samples=samples, stats=EllipticalStats(shrinks=shrinks, loglik=loglik,
                                               divergent=divergent),
        final_theta=f, final_loglik=llf,
        final_step=torch.full((c,), start_step + config.num_samples, dtype=torch.int32,
                              device=device))


def _prep_elliptical(log_lik_fn, theta0, prior_scale, prior_mean):
    """(flat theta0, flat likelihood, unravel or None, scale, mean): a tree
    state ravels, and per-leaf scale / mean trees ravel alongside it."""
    if not is_param_tree(theta0):
        if theta0.ndim != 1:
            raise ValueError(
                f"theta0 must be 1-d (got shape {tuple(theta0.shape)}); pass "
                "tree states as a tree, not a matrix"
            )
        return theta0, log_lik_fn, None, prior_scale, prior_mean
    flat0, unravel = ravel_pytree_fn(theta0)

    def ravel_like(spec):
        # a tree of per-leaf values (scalar or leaf-shaped) ravels to (D,) in
        # the state's leaf order; a plain scalar passes through
        if spec is None:
            return None
        if hasattr(spec, "ndim") or isinstance(spec, (int, float)):
            arr = torch.as_tensor(spec)
            if arr.ndim == 0:
                return arr
        leaves = tree_leaves(tree_map(
            lambda leaf, v: torch.as_tensor(v, dtype=leaf.dtype, device=leaf.device).expand(
                leaf.shape), theta0, spec))
        return torch.cat([leaf.reshape(-1) for leaf in leaves])

    return (flat0, make_flat_potential(log_lik_fn, theta0), unravel, ravel_like(prior_scale),
            ravel_like(prior_mean))


def _one_chain(r: EllipticalResult) -> EllipticalResult:
    return EllipticalResult(samples=r.samples[0],
                            stats=EllipticalStats(*(t[0] for t in r.stats)),
                            final_theta=r.final_theta[0], final_loglik=r.final_loglik[0],
                            final_step=r.final_step[0])


def run_elliptical(
    key: int,
    log_lik_fn: Callable,
    theta0,
    config: EllipticalConfig,
    prior_scale=1.0,
    prior_mean=None,
    data=None,
    init_loglik=None,
    start_step: int = 0,
    _noise=None,
    _margins=None,
) -> EllipticalResult:
    """Elliptical slice sampling; see the module docstring.

    ``log_lik_fn`` is the LIKELIHOOD alone (the Gaussian prior enters
    through ``prior_scale`` / ``prior_mean``); it is only ever evaluated.
    ``prior_scale``: a scalar std, (D,) stds, a (D, D) lower-Cholesky factor
    of the prior covariance, or (tree states) a tree of per-leaf stds.
    ``theta0`` may be flat (D,) or a parameter tree.  ``data=`` calls
    ``log_lik_fn(theta, data)``.  ``key`` is an integer seed; the chain runs
    on the device of ``theta0`` (the card for a start that is not a tensor).

    Chunked runs resume bit for bit: feed ``final_theta`` /
    ``final_loglik`` / ``final_step`` back with the same key and config.
    """
    theta0 = place_start(theta0)
    theta0f, fn, unravel, scale_f, mean_f = _prep_elliptical(
        _bind_data(log_lik_fn, data), theta0, prior_scale, prior_mean)
    scale, mean = _coerce_prior(scale_f, mean_f, theta0f.shape[0], theta0f.dtype,
                                theta0f.device)
    r = _one_chain(_run_elliptical(key, theta0f[None], fn, config, scale, mean,
                                   init_loglik=init_loglik, start_step=int(start_step),
                                   _noise=_noise, _margins=_margins))
    if unravel is not None:
        r = r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))
    return r


def run_elliptical_chains(
    key: int,
    log_lik_fn: Callable,
    theta0,
    config: EllipticalConfig,
    num_chains: int,
    prior_scale=1.0,
    prior_mean=None,
    data=None,
    theta0_is_stacked=None,
    _noise=None,
    _margins=None,
) -> EllipticalResult:
    """Independent elliptical-slice chains as one (C, D) batch (samples (C,
    N_kept, D)); the shrink loop runs every lane until each has found its
    slice or reached the cap, one vmapped likelihood an iteration.
    ``theta0`` may be (D,) (copied), (C, D), or a tree, single or with
    leading C axes (``theta0_is_stacked`` overrides the detection)."""
    lik = _bind_data(log_lik_fn, data)
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, stacked = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
        _, fn, unravel, scale_f, mean_f = _prep_elliptical(lik, template, prior_scale,
                                                           prior_mean)
        theta0 = _ravel_chains(stacked)
    else:
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
        _, fn, unravel, scale_f, mean_f = _prep_elliptical(lik, theta0[0], prior_scale,
                                                           prior_mean)
    scale, mean = _coerce_prior(scale_f, mean_f, theta0.shape[1], theta0.dtype, theta0.device)
    r = _run_elliptical(key, theta0, fn, config, scale, mean, _noise=_noise, _margins=_margins)
    if unravel is not None:
        r = r._replace(samples=unravel(r.samples), final_theta=unravel(r.final_theta))
    return r
