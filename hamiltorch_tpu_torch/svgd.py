"""Stein variational gradient descent (SVGD): particle-ensemble VI.

Counterpart of ``hamiltorch_tpu/svgd.py`` (Liu & Wang 2016).  ``n``
interacting particles follow the kernelized Wasserstein gradient of
KL(q || p),

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) grad log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ],

so the ensemble drifts toward the posterior while the kernel-repulsion
term keeps it spread.

Each step is three (n, n) x (n, d) products: the pairwise squared
distances from one Gram product ``X @ X.T``, the attraction ``K @ G`` and
the repulsion ``diag(K 1) X - K X``, all ``torch.matmul`` in float32
whatever the particles' dtype (TF32 stays off).  The gradients are
``torch.func.vmap`` over ``torch.func.grad``.  The step loop is a host
loop over preallocated traces; the update is deterministic (the key only
draws the initial cloud), so chunked runs resume bit for bit by passing
``particles0=result.particles, init_aux=result.final_aux,
start_step=result.final_step``.  A non-finite update is skipped and
counted (``num_rejected``) with ``torch.where``, so no step waits on the
host and none raises.

The RBF bandwidth follows the median heuristic as in Liu & Wang's
reference implementation: the median of the full squared-distance matrix
(diagonal zeros included; with an even element count the mean of the two
middle elements, as ``jnp.median`` takes it, where ``torch.median`` would
return the lower one), divided by ``log(n + 1)``, recomputed every step.
A fixed ``bandwidth`` (an RBF lengthscale ``l``, kernel ``exp(-D2 /
(2 l^2))``) switches the heuristic off.  The optimizer is their AdaGrad
with momentum; global step 0 seeds the accumulator with ``phi**2``.

Tree parameters ravel once at entry and unravel once at exit.  The
initial cloud is ``theta0 + init_scale * N(0, I)`` with the normals from
a generator on ``theta0``'s device seeded by ``draw_seed(key, 0,
SVGD_STREAM)`` (``utils.rng``); ``_noise`` (a test hook) hands them in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .utils.convert import place_start
from .utils.pytree import is_param_tree, ravel_pytree_fn, unravel_last_axis_fn
from .utils.rng import SVGD_STREAM, stream_generator


@dataclasses.dataclass(frozen=True)
class SVGDConfig:
    """Static configuration for :func:`run_svgd`.

    ``bandwidth=None`` (default) re-estimates the RBF bandwidth every
    step with the median heuristic; a positive float fixes the RBF
    lengthscale instead.  ``step_size``/``adagrad_alpha``/``fudge`` are
    Liu & Wang's AdaGrad-with-momentum knobs; ``optimizer="sgd"``
    disables the accumulator (plain ``x += step_size * phi``).
    ``init_scale`` is the stddev of the initial cloud around ``theta0``.
    """

    num_steps: int
    step_size: float = 1e-1
    bandwidth: Optional[float] = None
    optimizer: str = "adagrad"  # "adagrad" | "sgd"
    adagrad_alpha: float = 0.9
    fudge: float = 1e-6
    init_scale: float = 0.1

    def __post_init__(self):
        if self.num_steps <= 0:
            raise ValueError("num_steps must be positive")
        if self.optimizer not in ("adagrad", "sgd"):
            raise ValueError(
                f"optimizer must be 'adagrad' or 'sgd', got {self.optimizer!r}"
            )
        if self.bandwidth is not None and not self.bandwidth > 0:
            raise ValueError("bandwidth must be positive (or None)")
        if not self.step_size > 0:
            raise ValueError("step_size must be positive")


class SVGDResult(NamedTuple):
    particles: object  # (n, ...) final cloud: flat (n, D) or tree leaves
    phi_norm_trace: torch.Tensor  # (num_steps,) mean per-particle |phi|
    bandwidth_trace: torch.Tensor  # (num_steps,) kernel scale h (= 2 l^2)
    num_rejected: torch.Tensor  # non-finite (skipped) steps, int32
    final_aux: torch.Tensor  # AdaGrad accumulator, flat (n, D) float32 (resume)
    final_step: torch.Tensor  # global step counter after the run, int32


def _pairwise_sq(x32):
    """(n, n) squared Euclidean distances from one Gram product."""
    sq = torch.sum(x32 * x32, dim=1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x32 @ x32.T), min=0.0)


def _median(d2):
    """``jnp.median`` of every element: the mean of the two middle elements
    of an even count (``torch.median`` would return the lower one)."""
    s = torch.sort(d2.reshape(-1)).values
    m = s.numel()
    return (s[(m - 1) // 2] + s[m // 2]) * 0.5


def _median_h(d2, n):
    """Liu & Wang's heuristic: exponent ``-d2 * log(n + 1) / median(d2)``
    (median over the FULL matrix, diagonal zeros included, matching their
    reference implementation)."""
    log_n1 = torch.log(torch.tensor(n + 1.0, dtype=d2.dtype, device=d2.device))
    return torch.clamp(_median(d2) / log_n1, min=1e-12)


def _svgd_phi(x32, g32, d2, h, n):
    """Stein direction: attraction ``K G`` + repulsion ``(2/h)(K1 . X - K X)``."""
    k = torch.exp(-d2 / h)
    attract = k @ g32
    repulse = (2.0 / h) * (torch.sum(k, dim=1, keepdim=True) * x32 - k @ x32)
    return (attract + repulse) / n


def _run_svgd(particles0, log_prob, config: SVGDConfig, data=None, init_aux=None,
              start_step: int = 0):
    """``config.num_steps`` SVGD steps from the (n, D) cloud ``particles0``.

    Returns ``(particles, phi_norm_trace, bandwidth_trace, num_rejected,
    final_aux, final_step)``, the JAX package's ``_run_svgd_jit`` outputs.
    """
    lp = log_prob if data is None else (lambda t: log_prob(t, data))
    grad_all = torch.func.vmap(torch.func.grad(lp))
    n = particles0.shape[0]
    device = particles0.device
    f32 = torch.float32
    fixed_h = None
    if config.bandwidth is not None:
        fixed_h = torch.tensor(2.0 * float(config.bandwidth) ** 2, dtype=f32, device=device)
    aux = (torch.zeros(particles0.shape, dtype=f32, device=device) if init_aux is None
           else torch.as_tensor(init_aux, device=device).to(f32))
    start_step = int(start_step)
    x = particles0
    rej = torch.zeros((), dtype=torch.int32, device=device)
    phi_tr = torch.empty((config.num_steps,), dtype=f32, device=device)
    h_tr = torch.empty((config.num_steps,), dtype=f32, device=device)
    alpha = config.adagrad_alpha
    for i in range(config.num_steps):
        x32 = x.to(f32)
        g32 = grad_all(x).to(f32)
        d2 = _pairwise_sq(x32)
        h = _median_h(d2, n) if fixed_h is None else fixed_h
        phi = _svgd_phi(x32, g32, d2, h, n)
        if config.optimizer == "adagrad":
            # global step 0 seeds the accumulator with phi^2 outright (Liu &
            # Wang's iter == 0 branch); resumed chunks start past it
            if start_step + i == 0:
                aux_new = phi * phi
            else:
                aux_new = alpha * aux + (1.0 - alpha) * phi * phi
            step = config.step_size * phi / (config.fudge + torch.sqrt(aux_new))
        else:
            aux_new = aux
            step = config.step_size * phi
        x_new = (x32 + step).to(x.dtype)
        ok = torch.all(torch.isfinite(x_new))
        x = torch.where(ok, x_new, x)
        aux = torch.where(ok, aux_new, aux)
        rej = rej + (~ok).to(torch.int32)
        phi_tr[i] = torch.mean(torch.sqrt(torch.sum(phi * phi, dim=1)))
        h_tr[i] = h
    last = torch.tensor(start_step + config.num_steps, dtype=torch.int32, device=device)
    return x, phi_tr, h_tr, rej, aux, last


def _flat_log_prob(log_prob, template, with_data: bool):
    """The flat-vector wrapper of a tree potential (``template``'s leaf order)."""
    unravel = unravel_last_axis_fn(template)
    if with_data:
        return lambda v, d: log_prob(unravel(v), d)
    return lambda v: log_prob(unravel(v))


def initial_cloud(key: int, flat0: torch.Tensor, config: SVGDConfig, num_particles: int,
                  _noise=None) -> torch.Tensor:
    """``flat0 + init_scale * N(0, I)``, (num_particles, D); the normals come
    from ``draw_seed(key, 0, SVGD_STREAM)`` on ``flat0``'s device, or are
    ``_noise``."""
    if _noise is None:
        gen = stream_generator(key, SVGD_STREAM, 0, flat0.device)
        noise = torch.randn((num_particles,) + tuple(flat0.shape), generator=gen,
                            dtype=flat0.dtype, device=gen.device)
    else:
        noise = torch.as_tensor(_noise)
    noise = noise.to(device=flat0.device, dtype=flat0.dtype)
    return flat0[None, :] + config.init_scale * noise


def check_num_particles(num_particles: int) -> None:
    if num_particles < 2:
        raise ValueError("num_particles must be >= 2 (the kernel-repulsion "
                         "term needs an interacting ensemble)")


def run_svgd(
    key,
    log_prob: Callable,
    theta0,
    config: SVGDConfig,
    num_particles: int = 100,
    *,
    data=None,
    particles0=None,
    init_aux=None,
    start_step=0,
    _noise=None,
) -> SVGDResult:
    """Transport ``num_particles`` particles toward ``log_prob``'s target.

    ``theta0`` may be a flat vector or any parameter tree (raveled at the
    boundary); the initial cloud is ``theta0 + init_scale * N(0, I)``
    unless ``particles0`` (a previous result's ``.particles``) resumes a
    run: pass ``init_aux=result.final_aux, start_step=result.final_step``
    with it for a bit-exact continuation.  ``data`` reaches the potential
    as ``log_prob(theta, data)``.  ``key`` is an integer seed; the
    particles live on the device of ``theta0`` (the card for a start that
    is not a tensor).  ``_noise``: the initial cloud's (n, D) unit normals
    (a test hook).
    """
    theta0 = place_start(theta0)
    is_tree = is_param_tree(theta0)
    if is_tree:
        flat0, unravel = ravel_pytree_fn(theta0)
    else:
        flat0, unravel = theta0.reshape(-1), None
    check_num_particles(num_particles)

    if particles0 is None:
        particles = initial_cloud(key, flat0, config, num_particles, _noise)
    else:
        if is_tree:
            particles = torch.func.vmap(lambda t: ravel_pytree_fn(t)[0])(particles0)
        else:
            particles = torch.as_tensor(particles0, device=flat0.device)
        if tuple(particles.shape) != (num_particles, flat0.shape[0]):
            raise ValueError(
                f"particles0 shape {tuple(particles.shape)} != "
                f"({num_particles}, {flat0.shape[0]})"
            )

    lp = _flat_log_prob(log_prob, theta0, data is not None) if is_tree else log_prob
    x, phi_tr, h_tr, rej, aux, last = _run_svgd(
        particles, lp, config, data=data, init_aux=init_aux, start_step=start_step)
    out = unravel(x) if is_tree else x
    return SVGDResult(out, phi_tr, h_tr, rej, aux, last)
