"""Riemannian metric pipeline and non-separable Hamiltonian.

Counterpart of ``hamiltorch_tpu/ops/metrics.py`` (the reference's
``fisher`` / ``cholesky_inverse`` / ``rm_hamiltonian``, reference:
hamiltorch/samplers.py:69-149, 677-736):

* HESSIAN metric:        G = -H[log p]
* JACOBIAN_DIAG metric:  G = diag(grad^2)
* SOFTABS:               eigh, lambda' = lambda*coth(alpha*lambda), reconstruct
* jitter:                G += diag(U(0,1)*jitter), the uniform drawn once per
                         transition and held along the trajectory
* H = -log p + D/2 log 2pi + 1/2 log|G| + 1/2 p^T G^-1 p

As in the JAX package, one Cholesky factor serves the quadratic form and the
log-determinant, and a metric that is not positive definite gives NaN, which
the driver's accept mask treats as a divergence.  ``torch.linalg.cholesky``
raises there instead (and checks with a host sync), so the factor comes from
``cholesky_ex(check_errors=False)`` and is set to NaN where ``info != 0``:
its partial factor is not NaN on its own.

The functions here act on ONE chain (theta (D,), p (D,), jitter_u (D,) or
None); the samplers ``torch.func.vmap`` them over chains.  ``grad_theta`` is
``torch.func.grad`` of a Hamiltonian that holds ``torch.func.hessian``
(jacfwd over jacrev) of the log-prob: third-order AD, as the JAX package's
``jax.grad`` over ``jax.hessian``.  ``dH/dp = G^{-1} p`` is two triangular
solves.

The softabs map is a ``torch.autograd.Function`` whose backward is the
transpose of the JAX package's custom JVP (the Daleckii-Krein formula):
``torch.linalg.eigh``'s own backward divides by eigenvalue differences and
is NaN where eigenvalues repeat, e.g. on the funnel's scaled-identity block.
``torch.linalg.eigh`` also raises (after a host sync) on a matrix with NaN
or inf entries, where JAX's returns NaN; the Function gives NaN there.
The metric is computed with float32 products at full precision (no TF32), as
the JAX package forces float32 precision there: a rounded G enters the
stationary density through its log-determinant, which the Metropolis test
cannot correct.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..enums import Metric
from ..utils.precision import full_float32


@dataclasses.dataclass(frozen=True)
class RMOptions:
    """RMHMC configuration (the JAX package's fields and defaults)."""

    metric: Metric = Metric.HESSIAN
    jitter: Optional[float] = None
    softabs_const: float = 1e6
    explicit_binding_const: float = 100.0
    fixed_point_threshold: float = 1e-5
    fixed_point_max_iterations: int = 1000


def softabs_eigenvalues(eigs: torch.Tensor, alpha: float) -> torch.Tensor:
    """lambda * coth(alpha * lambda), guarded at 0 (limit 1/alpha)."""
    x = alpha * eigs
    small = torch.abs(x) < 1e-8
    safe = torch.where(small, torch.ones_like(x), x)
    coth = 1.0 / torch.tanh(safe)
    return torch.where(small, torch.full_like(x, 1.0 / alpha), eigs * coth)


def _softabs_derivative(eigs: torch.Tensor, alpha: float) -> torch.Tensor:
    """d/dlambda [lambda*coth(alpha*lambda)] = coth(x) - x/sinh^2(x), x = alpha*lambda;
    ~ (2/3) x near 0, sign(x) for |x| > 20 (sinh overflows)."""
    x = alpha * eigs
    small = torch.abs(x) < 1e-4
    big = torch.abs(x) > 20.0
    xs = torch.where(small | big, torch.ones_like(x), x)
    core = 1.0 / torch.tanh(xs) - xs / torch.sinh(xs) ** 2
    return torch.where(small, 2.0 * x / 3.0, torch.where(big, torch.sign(x), core))


class _SoftAbs(torch.autograd.Function):
    """A -> (V f(L) V^T, f(L), L, V) with f = softabs; L and V are returned
    only so that the backward can reuse them (not differentiable)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, alpha):
        # torch.linalg.eigh raises where JAX's returns NaN (a NaN or inf
        # input, or one whose squared entries overflow, fails to converge):
        # such a matrix is factored as the identity and its outputs set to
        # NaN, a divergence for the driver.  jnp.linalg.eigh symmetrizes its
        # input; so does this.
        ok = torch.isfinite((a * a).sum((-2, -1)))
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        eigs, vecs = torch.linalg.eigh(torch.where(ok[..., None, None], 0.5 * (a + a.mT), eye))
        eigs = torch.where(ok[..., None], eigs, torch.full_like(eigs, torch.nan))
        vecs = torch.where(ok[..., None, None], vecs, torch.full_like(vecs, torch.nan))
        lam = softabs_eigenvalues(eigs, alpha)
        g = (vecs * lam[..., None, :]) @ vecs.mT
        return g, lam, eigs, vecs

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, lam, eigs, vecs = output
        ctx.alpha = inputs[1]
        ctx.mark_non_differentiable(eigs, vecs)
        ctx.save_for_backward(eigs, vecs, lam)

    @staticmethod
    def backward(ctx, g_bar, lam_bar, _eigs_bar, _vecs_bar):
        # the transpose of the JAX package's JVP
        #   dG = V (F o (V^T dA V)) V^T,  dlam = f'(L) o diag(V^T dA V),
        # F_ij = (f(l_i) - f(l_j)) / (l_i - l_j), f'((l_i + l_j) / 2) where
        # the two are close:  A_bar = V (F o (V^T G_bar V) + diag(f'(L) lam_bar)) V^T
        eigs, vecs, lam = ctx.saved_tensors
        alpha = ctx.alpha
        li, lj = eigs[..., :, None], eigs[..., None, :]
        fi, fj = lam[..., :, None], lam[..., None, :]
        denom = li - lj
        close = torch.abs(denom) < 1e-8 * (1.0 + torch.abs(li) + torch.abs(lj))
        fprime = _softabs_derivative(0.5 * (li + lj), alpha)
        fmat = torch.where(close, fprime, (fi - fj) / torch.where(close, torch.ones_like(denom),
                                                                  denom))
        inner = fmat * (vecs.mT @ g_bar @ vecs)
        inner = inner + torch.diag_embed(_softabs_derivative(eigs, alpha) * lam_bar)
        return vecs @ inner @ vecs.mT, None


def softabs_transform(a: torch.Tensor, alpha: float):
    """Spectral softabs: A -> (V f(L) V^T, f(L)) with f = softabs.

    Differentiable through its own backward (the transpose of the JAX
    package's Daleckii-Krein JVP), finite where eigenvalues repeat; works
    under ``torch.func.grad`` and ``torch.func.vmap``."""
    g, lam, _, _ = _SoftAbs.apply(a, alpha)
    return g, lam


def cholesky_or_nan(g: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of ``g``, NaN everywhere where ``g`` is not
    positive definite (no exception, no host sync)."""
    chol, info = torch.linalg.cholesky_ex(g, check_errors=False)
    return torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, torch.nan))


def _solve_lower(chol: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, p[..., None], upper=False)[..., 0]


class MetricResult(NamedTuple):
    g: torch.Tensor  # (D, D) metric tensor
    abs_eigs: Optional[torch.Tensor]  # softabs eigenvalues, else None


def make_metric_fn(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    opts: RMOptions,
) -> Callable[[torch.Tensor, Optional[torch.Tensor]], MetricResult]:
    """Build G(theta) for one chain; ``jitter_u`` is the per-transition
    U(0,1) vector (or None)."""

    def metric_fn(theta: torch.Tensor, jitter_u: Optional[torch.Tensor]) -> MetricResult:
        with full_float32():
            if opts.metric == Metric.JACOBIAN_DIAG:
                g_vec = torch.func.grad(log_prob_fn)(theta)
                fish = torch.diag(g_vec * g_vec)
            else:
                fish = -torch.func.hessian(log_prob_fn)(theta)
            if opts.jitter is not None and jitter_u is not None:
                fish = fish + torch.diag(jitter_u * opts.jitter)
            if opts.metric == Metric.SOFTABS:
                fish, abs_eigs = softabs_transform(fish, opts.softabs_const)
                return MetricResult(fish, abs_eigs)
            return MetricResult(fish, None)

    return metric_fn


class RMHamiltonian(NamedTuple):
    """Bundled Riemannian-Hamiltonian operations for one potential (one chain)."""

    ham: Callable  # (theta, p, jitter_u) -> H
    ham_and_logp: Callable  # (theta, p, jitter_u) -> (H, logp)
    grad_theta: Callable  # (theta, p, jitter_u) -> dH/dtheta
    grad_p: Callable  # (theta, p, jitter_u) -> G^-1 p
    metric: Callable  # (theta, jitter_u) -> MetricResult
    sample_momentum: Callable  # (z, theta, jitter_u) -> p = chol(G) z ~ N(0, G)


def make_rm_hamiltonian(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    opts: RMOptions,
    ham_func: Optional[Callable] = None,
    semi_separable: bool = False,
    custom_metric: Optional[Callable] = None,
) -> RMHamiltonian:
    """Assemble the RMHMC operation set for ``log_prob_fn``.

    ``semi_separable`` selects the reference's S3 Hamiltonian
    H = -logp + 1/2 p^T G^-1 p + ham_func(theta) (samplers.py:830-842).
    ``custom_metric``: an analytic ``theta -> (D, D)`` SPD metric, which
    replaces the Hessian / softabs pipeline (jitter and softabs do not apply).
    ``sample_momentum`` takes the standard normal ``z`` (D,) that the driver
    draws per chain, where the JAX package takes a key.
    """
    if custom_metric is not None:
        def metric_fn(theta, jitter_u):
            return MetricResult(custom_metric(theta), None)
    else:
        metric_fn = make_metric_fn(log_prob_fn, opts)

    def ham_and_logp(theta, p, jitter_u):
        logp = log_prob_fn(theta)
        g, abs_eigs = metric_fn(theta, jitter_u)
        chol = cholesky_or_nan(g)
        y = _solve_lower(chol, p)
        quad = torch.dot(y, y)
        if semi_separable:
            extra = ham_func(theta) if ham_func is not None else 0.0
            return -logp + 0.5 * quad + extra, logp
        if abs_eigs is not None:
            logdet = torch.sum(torch.log(abs_eigs))
        else:
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        d = theta.shape[0]
        h = -logp + 0.5 * d * math.log(2 * math.pi) + 0.5 * logdet + 0.5 * quad
        return h, logp

    def ham(theta, p, jitter_u):
        return ham_and_logp(theta, p, jitter_u)[0]

    grad_theta = torch.func.grad(ham, argnums=0)

    def grad_p(theta, p, jitter_u):
        chol = cholesky_or_nan(metric_fn(theta, jitter_u)[0])
        y = _solve_lower(chol, p)
        return torch.linalg.solve_triangular(chol.mT, y[..., None], upper=True)[..., 0]

    def sample_momentum(z, theta, jitter_u):
        chol = cholesky_or_nan(metric_fn(theta, jitter_u)[0])
        return chol @ z.to(chol.dtype)

    return RMHamiltonian(
        ham=ham,
        ham_and_logp=ham_and_logp,
        grad_theta=grad_theta,
        grad_p=grad_p,
        metric=metric_fn,
        sample_momentum=sample_momentum,
    )


def batched(rm: RMHamiltonian, jitter: bool) -> RMHamiltonian:
    """``rm`` with every operation ``torch.func.vmap``-ed over a leading
    chain axis; without jitter the ``jitter_u`` argument is None and not
    mapped."""
    jdim = 0 if jitter else None

    def over_chains(fn, n_args):
        return torch.func.vmap(fn, in_dims=(0,) * n_args + (jdim,))

    return RMHamiltonian(
        ham=over_chains(rm.ham, 2),
        ham_and_logp=over_chains(rm.ham_and_logp, 2),
        grad_theta=over_chains(rm.grad_theta, 2),
        grad_p=over_chains(rm.grad_p, 2),
        metric=over_chains(rm.metric, 1),
        sample_momentum=over_chains(rm.sample_momentum, 2),
    )
