"""MAP estimation, the Laplace approximation and ADVI.

Counterpart of ``hamiltorch_tpu/optim.py``.  The three rungs of the
approximate ladder over the potentials the samplers take: a MAP point
(``map_estimate``, a warm start for any sampler), the local curvature
(``laplace_approx``: a Gaussian at the mode, its covariance as an
``inv_mass``, and a Laplace evidence estimate) and a global Gaussian fit by
stochastic optimisation (``advi``, mean-field or full-rank; its stds seed
Barker's ``scale=``).

optax becomes ``torch.optim``: ``optimizer=`` takes a callable ``params ->
torch.optim.Optimizer`` (default ``torch.optim.Adam(params,
lr=learning_rate)``, which computes optax.adam's update m̂ / (√v̂ + eps)).
The loops run on the host, one step a ``torch.func`` value and gradient.
A step whose new parameters (``map_estimate``: or optimizer state; ``advi``:
or objective) are not finite is rejected: the parameters and every tensor
of the optimizer's state go back to copies made before the step, and
``num_rejected`` counts the step.

Random numbers: ADVI's Monte Carlo normals at step i come from a generator
seeded by ``draw_seed(key, 0, OPTIM_STREAM + i)``, the draws of
``laplace_sample`` and ``advi_sample`` from ``draw_seed(key, 1,
OPTIM_STREAM)`` (``utils.rng.stream_generator``); ``key`` is an integer
seed (``advi``'s default 0, as the JAX package's is ``PRNGKey(0)``).
``_noise`` (a test hook) hands in the normals instead: (num_steps,
num_mc_samples, D) for ``advi``, (num_samples, D) for the samplers.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .ops.potential import value_and_grad
from .utils.convert import place_start
from .utils.precision import full_float32
from .utils.pytree import is_param_tree, ravel_pytree_fn, tree_leaves, tree_unflatten_like
from .utils.rng import OPTIM_STREAM, stream_generator


class MAPResult(NamedTuple):
    theta: object  # best-log-prob iterate seen (use this as the MAP)
    log_prob: torch.Tensor  # log_prob at ``theta``, float32
    final_theta: object  # last iterate (the optimizer's end state)
    log_prob_trace: torch.Tensor  # (num_steps,) pre-update log_prob values, float32
    num_rejected: torch.Tensor  # non-finite update steps (kept the previous state)


def _bind(log_prob_fn, data):
    if not callable(log_prob_fn):
        raise TypeError(f"log_prob_fn must be callable, got {type(log_prob_fn)}")
    return log_prob_fn if data is None else (lambda t: log_prob_fn(t, data))


def _all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _state_tensors(opt: torch.optim.Optimizer) -> list:
    return [v for state in opt.state.values() for v in state.values()
            if isinstance(v, torch.Tensor)]


def _guarded_step(opt: torch.optim.Optimizer, params: list, grads: list, extra_ok=True,
                  check_state: bool = True) -> bool:
    """One optimizer step from ``grads`` (the gradients of the objective it
    minimises); rejected, parameters and state restored, unless the new
    parameters (and, with ``check_state``, the state) are finite and
    ``extra_ok``.  Returns whether the step was kept."""
    saved_p = [p.detach().clone() for p in params]
    saved_s = [t.clone() for t in _state_tensors(opt)]
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    ok = bool(extra_ok) and _all_finite(params)
    if ok and check_state:
        ok = _all_finite(_state_tensors(opt))
    if not ok:
        with torch.no_grad():
            for p, s in zip(params, saved_p):
                p.copy_(s)
            state = _state_tensors(opt)
            if len(state) == len(saved_s):
                for t, s in zip(state, saved_s):
                    t.copy_(s)
            else:  # the first step created the state: a rejected one leaves none
                opt.state.clear()
    return ok


def _make_optimizer(optimizer, params, learning_rate):
    if optimizer is None:
        return torch.optim.Adam(params, lr=learning_rate)
    return optimizer(params)


def map_estimate(
    log_prob_fn: Callable,
    theta0,
    num_steps: int = 1000,
    learning_rate: float = 1e-2,
    optimizer=None,
    data=None,
) -> MAPResult:
    """Maximise ``log_prob_fn`` from ``theta0``: a MAP fit or warm start.

    ``theta0`` may be flat or a parameter tree; ``data=`` calls
    ``log_prob_fn(theta, data)``.  ``optimizer``: a callable ``params ->
    torch.optim.Optimizer`` (default Adam at ``learning_rate``).  The best
    iterate (the final one included) comes back as ``theta``; use it to seed
    ``sample(..., params_init=...)`` or any ``run_*`` entry.  The fit runs
    on the device of ``theta0`` (the card for a start that is not a tensor).
    """
    if num_steps < 1:
        raise ValueError(f"num_steps={num_steps}; must be >= 1")
    lp = _bind(log_prob_fn, data)
    theta0 = place_start(theta0)
    tree = is_param_tree(theta0)
    leaves0 = tree_leaves(theta0) if tree else [theta0]
    params = [torch.as_tensor(leaf).detach().clone() for leaf in leaves0]

    def as_theta(ps):
        return tree_unflatten_like(theta0, ps) if tree else ps[0]

    vg = value_and_grad(lambda ps: lp(as_theta(ps)))
    opt = _make_optimizer(optimizer, params, learning_rate)
    device = params[0].device
    trace = torch.empty((num_steps,), dtype=torch.float32, device=device)
    best_t = [p.clone() for p in params]
    best_v = torch.tensor(float("-inf"), dtype=torch.float32, device=device)
    rejected = 0

    def track(v32, ps):
        nonlocal best_v
        better = (v32 > best_v) & torch.isfinite(v32)
        for b, p in zip(best_t, ps):
            b.copy_(torch.where(better, p, b))
        best_v = torch.where(better, v32, best_v)

    for i in range(num_steps):
        v, g = vg([p.detach() for p in params])
        v32 = v.to(torch.float32)
        trace[i] = v32
        track(v32, params)
        if not _guarded_step(opt, params, [-gi for gi in g]):
            rejected += 1
    # the final iterate may beat every pre-update value in the trace
    with torch.no_grad():
        track(lp(as_theta(params)).to(torch.float32), params)
    return MAPResult(theta=as_theta(best_t), log_prob=best_v,
                     final_theta=as_theta([p.detach() for p in params]),
                     log_prob_trace=trace,
                     num_rejected=torch.tensor(rejected, dtype=torch.int32, device=device))


class LaplaceResult(NamedTuple):
    """Gaussian approximation N(mean, cov) of the posterior at a mode."""

    mean: torch.Tensor  # flat (D,) mode (the ravel of a tree theta_map)
    cov: torch.Tensor  # (D, D) posterior covariance (PD-projected)
    prec: torch.Tensor  # (D, D) precision = clipped negative Hessian
    log_evidence: torch.Tensor  # lp(mode) + D/2 log 2pi - logdet(prec)/2
    unravel: object  # flat -> the original theta structure (None for flat modes)


def _flat_potential(lp, theta):
    """(flat theta, flat potential, unravel or None)."""
    if not is_param_tree(theta):
        return theta, lp, None
    flat0, unravel = ravel_pytree_fn(theta)
    return flat0, (lambda v: lp(unravel(v))), unravel


def laplace_approx(
    log_prob_fn: Callable,
    theta_map,
    data=None,
    min_eig_ratio: float = 1e-8,
) -> LaplaceResult:
    """Laplace (Gaussian) approximation of the posterior around a mode.

    The negative Hessian (``torch.func.hessian``, TF32 off) is symmetrised
    and its spectrum clipped at ``min_eig_ratio * max_eig`` (a flat or
    indefinite direction would otherwise have no Gaussian).
    ``log_evidence`` is ``lp(mode) + D/2 log 2pi - logdet(prec)/2``, the
    cheap counterpart of ``run_smc``'s and ``run_ti``'s evidence;
    ``torch.diag(cov)`` or ``cov`` is a curvature-matched ``inv_mass``.
    ``theta_map`` may be flat or a tree (``unravel`` maps draws back).
    O(D^2) memory and an O(D^3) ``eigh``: for low-dimensional, last-layer
    and model-comparison uses.
    """
    lp = _bind(log_prob_fn, data)
    theta_map = place_start(theta_map)
    flat0, lp_flat, unravel = _flat_potential(lp, theta_map)
    flat0 = torch.as_tensor(flat0).detach()
    d = int(flat0.shape[0])
    with full_float32():
        h = torch.func.hessian(lp_flat)(flat0)
        neg_h = -0.5 * (h + h.T)
        eigs, vecs = torch.linalg.eigh(neg_h)
        floor = torch.clamp(torch.max(eigs), min=0.0) * min_eig_ratio + 1e-30
        eigs_c = torch.maximum(eigs, floor)
        prec = (vecs * eigs_c) @ vecs.T
        cov = (vecs / eigs_c) @ vecs.T
        log_det_prec = torch.sum(torch.log(eigs_c))
        with torch.no_grad():
            log_z = lp_flat(flat0) + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * log_det_prec
    return LaplaceResult(mean=flat0, cov=cov, prec=prec, log_evidence=log_z, unravel=unravel)


def _sample_normals(key, num_samples: int, like: torch.Tensor, _noise):
    if _noise is not None:
        return torch.as_tensor(_noise, device=like.device).to(like.dtype)
    gen = stream_generator(key, OPTIM_STREAM, 0, like.device, slot=1)
    return torch.randn((num_samples, like.shape[0]), generator=gen, dtype=like.dtype,
                       device=gen.device).to(like.device)


def _unravel_draws(flat, unravel):
    return flat if unravel is None else unravel(flat)


def laplace_sample(key, result: LaplaceResult, num_samples: int, _noise=None):
    """Draws from the Laplace Gaussian; tree modes come back as trees with
    a leading ``num_samples`` axis, flat modes as (N, D).  ``key`` is an
    integer seed."""
    with full_float32():
        chol = torch.linalg.cholesky(result.cov)
        z = _sample_normals(key, num_samples, result.mean, _noise)
        flat = result.mean[None, :] + z @ chol.T
    return _unravel_draws(flat, result.unravel)


class ADVIResult(NamedTuple):
    """Gaussian variational fit.

    Mean-field: q = N(mean, diag(exp(2 log_std))), ``scale_tril`` None.
    Full-rank: q = N(mean, L L^T) with ``scale_tril = L`` (lower
    triangular; ``log_std`` then holds ``log(diag(L))``).
    """

    mean: torch.Tensor  # flat (D,) variational mean
    log_std: torch.Tensor  # flat (D,) variational log-std / log diag(L)
    elbo_trace: torch.Tensor  # (num_steps,) one-sample ELBO estimates
    elbo: torch.Tensor  # mean of the last 10% of the trace
    unravel: object  # flat -> the original theta structure (None for flat)
    scale_tril: object = None  # (D, D) lower-triangular L (full-rank only)


def advi_cov(result: ADVIResult) -> torch.Tensor:
    """The fitted covariance: ``diag(exp(2 log_std))`` (mean-field) or ``L
    L^T`` (full-rank); feed it (or its diagonal) to a sampler's
    ``inv_mass``."""
    if result.scale_tril is None:
        return torch.diag(torch.exp(2.0 * result.log_std))
    with full_float32():
        return result.scale_tril @ result.scale_tril.T


def _build_l(log_diag, low):
    return torch.tril(low, -1) + torch.diag(torch.exp(log_diag))


def advi(
    log_prob_fn: Callable,
    theta0,
    num_steps: int = 2000,
    learning_rate: float = 1e-2,
    num_mc_samples: int = 4,
    init_log_std: float = -2.0,
    optimizer=None,
    data=None,
    key=None,
    method: str = "meanfield",
    _noise=None,
) -> ADVIResult:
    """ADVI (Kucukelbir et al. 2017): maximise the ELBO of a Gaussian q.

    Reparameterisation gradients (``theta = mean + scale z``) with
    ``num_mc_samples`` normals a step, one vmapped evaluation of the
    potential over them; the result averages the last 10% of the iterates.
    ``method="meanfield"`` fits a diagonal Gaussian; ``"fullrank"`` fits
    N(mean, L L^T) with L = tril(low, -1) + diag(exp(log_diag)), exact on
    correlated Gaussians, at O(D^2) parameters.  ``theta0`` may be flat or
    a tree; ``key`` an integer seed (default 0).  ``exp(2 log_std)`` (or
    ``advi_cov``) is an ``inv_mass``, and ``exp(log_std)`` Barker's
    ``scale=``.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps={num_steps}; must be >= 1")
    if num_mc_samples < 1:
        raise ValueError(f"num_mc_samples={num_mc_samples}; must be >= 1")
    if method not in ("meanfield", "fullrank"):
        raise ValueError(
            f"method={method!r}; must be 'meanfield' or 'fullrank'"
        )
    lp = _bind(log_prob_fn, data)
    theta0 = place_start(theta0)
    flat0, lp_flat, unravel = _flat_potential(lp, theta0)
    flat0 = torch.as_tensor(flat0).detach()
    key = 0 if key is None else key
    d, dtype, device = flat0.shape[0], flat0.dtype, flat0.device
    fullrank = method == "fullrank"
    params = [flat0.clone(), torch.full_like(flat0, init_log_std)]
    if fullrank:
        params.append(torch.zeros((d, d), dtype=dtype, device=device))
    vlp = torch.func.vmap(lp_flat)
    entropy_const = 0.5 * d * (1.0 + math.log(2 * math.pi))

    def neg_elbo(ps, z):
        if fullrank:
            theta = ps[0][None, :] + z @ _build_l(ps[1], ps[2]).T
        else:
            theta = ps[0][None, :] + torch.exp(ps[1])[None, :] * z
        e_lp = torch.mean(vlp(theta))
        return -(e_lp + (torch.sum(ps[1]) + entropy_const))

    gv = torch.func.grad_and_value(neg_elbo)
    opt = _make_optimizer(optimizer, params, learning_rate)
    # tail-averaged iterates: under Monte Carlo gradient noise the fit wanders
    # around the optimum; averaging the last 10% of steps removes most of it
    tail = max(num_steps // 10, 1)
    cutoff = num_steps - tail
    acc = [torch.zeros_like(p) for p in params]
    elbos = torch.empty((num_steps,), dtype=dtype, device=device)
    for i in range(num_steps):
        if _noise is None:
            gen = stream_generator(key, OPTIM_STREAM, i, device)
            z = torch.randn((num_mc_samples, d), generator=gen, dtype=dtype,
                            device=gen.device).to(device)
        else:
            z = torch.as_tensor(_noise[i], device=device).to(dtype)
        g, v = gv([p.detach() for p in params], z)
        _guarded_step(opt, params, g, extra_ok=torch.isfinite(v), check_state=False)
        if i >= cutoff:
            for a, p in zip(acc, params):
                a.add_(p.detach())
        elbos[i] = -v
    fit = [a / tail for a in acc]
    elbo = torch.mean(elbos[-tail:])
    if fullrank:
        return ADVIResult(mean=fit[0], log_std=fit[1], elbo_trace=elbos, elbo=elbo,
                          unravel=unravel, scale_tril=_build_l(fit[1], fit[2]))
    return ADVIResult(mean=fit[0], log_std=fit[1], elbo_trace=elbos, elbo=elbo,
                      unravel=unravel)


def advi_sample(key, result: ADVIResult, num_samples: int, _noise=None):
    """Draws from the fitted Gaussian (diagonal or full-rank); tree fits
    come back as trees with a leading ``num_samples`` axis.  ``key`` is an
    integer seed."""
    z = _sample_normals(key, num_samples, result.mean, _noise)
    if result.scale_tril is None:
        flat = result.mean[None, :] + torch.exp(result.log_std)[None, :] * z
    else:
        with full_float32():
            flat = result.mean[None, :] + z @ result.scale_tril.T
    return _unravel_draws(flat, result.unravel)
