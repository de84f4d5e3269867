"""Affine-invariant ensemble sampler (the parallel stretch move).

Counterpart of ``hamiltorch_tpu/samplers/stretch.py``: the Goodman & Weare
(2010) ensemble sampler as emcee runs it (Foreman-Mackey et al. 2013).  It
only EVALUATES the log-density, never differentiates it, so it samples
targets autodiff cannot touch (quantised likelihoods, black-box
simulators); affine invariance means a badly scaled or correlated
posterior needs no tuning.

The parallel ("red-black") move: the K walkers split into two fixed
halves; half A proposes through partners drawn from half B, then B through
the UPDATED A.  For walker x_k with partner x_j and z ~ g(z) ∝ 1/sqrt(z)
on [1/a, a]:

    y = x_j + z (x_k - x_j),   accept with min(1, z^(d-1) p(y) / p(x_k)).

Each half move evaluates its K/2 proposals as one batch through
``torch.func.vmap(log_prob_fn)`` under ``torch.no_grad()``.  A non-finite
proposal is rejected and flags ``stats.divergent``.  Walkers: K >= 2 d
is recommended, K even and >= 4 is required.

Random numbers: at global iteration n ONE generator seeded by
``draw_seed(key, 0, STRETCH_STREAM + n)`` (``utils.rng.stream_generator``)
draws both halves' z uniforms, partner indices and (float32) Metropolis
uniforms, so chunked runs reproduce the straight run bit for bit; the
start jitter of a (D,) centre comes from ``draw_seed(key, 1,
STRETCH_STREAM)``.  ``_noise`` (a test hook) hands in ``{"u_z": (S, 2,
K/2), "j": (S, 2, K/2) int64, "u_mh": (S, 2, K/2)}`` instead (S
iterations; row 0 is the first half's move); z comes from ``u_z`` by
``_sample_z``'s formula.  ``_margins`` (a test hook), when a list,
receives each iteration's least distance of a Metropolis decision from its
other outcome.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.potential import make_flat_potential, resolve_potential
from ..utils.convert import place_start
from ..utils.pytree import stack_param_tree, unravel_last_axis_fn
from ..utils.rng import STRETCH_STREAM, stream_generator
from .mclmc import _bind_data, _ravel_chains


@dataclasses.dataclass(frozen=True)
class StretchConfig:
    """Static configuration for :func:`run_stretch`.

    ``num_samples`` counts TOTAL iterations (each moves every walker once);
    with ``thin > 1`` every thin-th ensemble state is kept.  ``a`` is the
    stretch scale (emcee's default 2.0).
    """

    num_samples: int
    a: float = 2.0
    thin: int = 1

    def __post_init__(self):
        if self.num_samples < 1:
            raise ValueError(f"num_samples={self.num_samples}; must be >= 1")
        if not self.a > 1.0:
            raise ValueError(
                f"a={self.a}; the stretch scale must be > 1 (a=1 never moves)"
            )
        if self.thin < 1:
            raise ValueError("thin must be >= 1")
        if self.num_samples % self.thin:
            raise ValueError(
                f"num_samples={self.num_samples} must be divisible by "
                f"thin={self.thin}"
            )


class StretchStats(NamedTuple):
    """Per-kept-iteration diagnostics."""

    accept_frac: torch.Tensor  # fraction of walkers that moved (the window's last iteration)
    divergent: torch.Tensor  # any non-finite proposal logp in the window


class StretchResult(NamedTuple):
    samples: object  # (N_kept, K, D) or a tree of (N_kept, K, ...) leaves
    stats: StretchStats
    acc_rate: torch.Tensor  # mean walker acceptance over the run
    final_walkers: object  # (K, D) or a tree (resume)
    final_logp: torch.Tensor  # (K,) cached log-densities (resume)
    final_step: torch.Tensor  # global iteration counter after the run


def _sample_z(u, a: float):
    """z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] from unit uniforms u: ((a-1) u + 1)^2 / a."""
    return ((a - 1.0) * u + 1.0) ** 2 / a


def logp_dtype(walkers_dtype) -> torch.dtype:
    """The cached log-densities' dtype: at least float32 (a bfloat16
    ensemble keeps float32 log-densities, so a resumed run reads back what
    the straight run carries)."""
    return torch.promote_types(walkers_dtype, torch.float32)


def _run_stretch(key: int, walkers0, log_prob_fn, config: StretchConfig, num_walkers: int,
                 init_logp=None, start_step: int = 0, _noise=None, _margins=None
                 ) -> StretchResult:
    half = num_walkers // 2
    dims = walkers0.shape[-1]
    dtype, device = walkers0.dtype, walkers0.device
    a = float(config.a)
    n_kept = config.num_samples // config.thin
    lp_dtype = logp_dtype(dtype)
    vlp = torch.func.vmap(log_prob_fn)

    def lp(x):
        with torch.no_grad():
            return vlp(x).to(lp_dtype)

    x = walkers0
    lpx = lp(x) if init_logp is None else torch.as_tensor(init_logp, device=device).to(lp_dtype)
    neg_inf = torch.tensor(float("-inf"), dtype=lp_dtype, device=device)

    def half_move(x_move, lp_move, x_other, u, j, u_mh):
        """Stretch one half against the (fixed) other half."""
        z = _sample_z(u, a)
        partners = x_other[j]
        prop = partners + z[:, None] * (x_move - partners)
        lp_prop = lp(prop)
        finite = torch.isfinite(lp_prop)
        log_ratio = torch.where(finite, (dims - 1.0) * torch.log(z) + lp_prop - lp_move, neg_inf)
        log_u = torch.log(u_mh)
        accept = log_u < log_ratio
        if _margins is not None:
            inf = torch.full_like(log_ratio, float("inf"))
            _margins.append(torch.where(finite, (log_u - log_ratio).abs(), inf).min())
        return (torch.where(accept[:, None], prop, x_move), torch.where(accept, lp_prop, lp_move),
                accept, ~finite.all())

    samples = torch.empty((n_kept, num_walkers, dims), dtype=dtype, device=device)
    frac = torch.empty((n_kept,), dtype=torch.float32, device=device)
    divergent = torch.empty((n_kept,), dtype=torch.bool, device=device)
    for b in range(n_kept):
        div = torch.zeros((), dtype=torch.bool, device=device)
        for t in range(config.thin):
            i = b * config.thin + t
            if _noise is None:
                gen = stream_generator(key, STRETCH_STREAM, start_step + i, device)
                u = torch.rand((2, half), generator=gen, dtype=dtype, device=gen.device)
                j = torch.randint(0, half, (2, half), generator=gen, device=gen.device)
                u_mh = torch.rand((2, half), generator=gen, dtype=torch.float32,
                                  device=gen.device)
                u, j, u_mh = u.to(device), j.to(device), u_mh.to(device)
            else:
                u, j, u_mh = _noise["u_z"][i], _noise["j"][i], _noise["u_mh"][i]
            x0, lp0, acc0, div0 = half_move(x[:half], lpx[:half], x[half:], u[0], j[0], u_mh[0])
            x1, lp1, acc1, div1 = half_move(x[half:], lpx[half:], x0, u[1], j[1], u_mh[1])
            x, lpx = torch.cat([x0, x1]), torch.cat([lp0, lp1])
            div = div | div0 | div1
        samples[b] = x
        frac[b] = (acc0.sum() + acc1.sum()).to(torch.float32) / num_walkers
        divergent[b] = div
    return StretchResult(
        samples=samples, stats=StretchStats(accept_frac=frac, divergent=divergent),
        acc_rate=torch.mean(frac), final_walkers=x, final_logp=lpx,
        final_step=torch.tensor(start_step + config.num_samples, dtype=torch.int32,
                                device=device))


def _jitter(key: int, shape, dtype, device):
    """The start jitter's unit normals, from ``draw_seed(key, 1, STRETCH_STREAM)``."""
    gen = stream_generator(key, STRETCH_STREAM, 0, device, slot=1)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device).to(device)


def _prep_walkers(key: int, log_prob_fn, theta0, num_walkers: int, init_jitter: float,
                  pass_grad=None):
    """(walker matrix, flat potential, unravel or None).  ``theta0`` may be
    (K, D) explicit walkers, a flat (D,) centre (walkers = centre + jitter
    ball), or a parameter tree, single or with (K, ...) leaves.
    ``pass_grad`` is accepted as the JAX helper accepts it; the move never
    differentiates."""
    if num_walkers < 4 or num_walkers % 2:
        raise ValueError(
            f"num_walkers={num_walkers}; the parallel stretch move needs an "
            "EVEN ensemble of >= 4 (recommended: >= 2 * dim)"
        )
    theta0 = place_start(theta0)
    if isinstance(theta0, torch.Tensor):
        if theta0.ndim == 2:
            if theta0.shape[0] != num_walkers:
                raise ValueError(
                    f"theta0 has {theta0.shape[0]} rows but num_walkers={num_walkers}"
                )
            return theta0, resolve_potential(log_prob_fn, pass_grad), None
        if theta0.ndim == 1:
            noise = _jitter(key, (num_walkers,) + tuple(theta0.shape), theta0.dtype,
                            theta0.device)
            walkers = theta0[None, :] + init_jitter * noise
            return walkers, resolve_potential(log_prob_fn, pass_grad), None
        raise ValueError(
            f"theta0 must be (D,) or (num_walkers, D); got {tuple(theta0.shape)}"
        )
    template, stacked = stack_param_tree(theta0, num_walkers, stacked=None)
    flat = _ravel_chains(stacked)
    if bool(torch.all(flat[0] == flat)):  # one state copied to every walker: jitter
        flat = flat + init_jitter * _jitter(key, tuple(flat.shape), flat.dtype, flat.device)
    return flat, make_flat_potential(log_prob_fn, template), unravel_last_axis_fn(template)


def run_stretch(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config: StretchConfig,
    num_walkers: int = 64,
    data=None,
    init_jitter: float = 1e-2,
    init_logp=None,
    start_step: int = 0,
    _noise=None,
    _margins=None,
) -> StretchResult:
    """Affine-invariant ensemble sampling; see the module docstring.

    GRADIENT-FREE: ``log_prob_fn`` is only ever evaluated.  ``theta0`` may
    be an explicit ``(num_walkers, D)`` walker matrix, a flat (D,) centre
    (walkers start in an ``init_jitter`` Gaussian ball around it: distinct
    walkers are required), or a parameter tree (single state or (K,
    ...)-stacked leaves; samples keep leaf shapes with leading ``(kept,
    K)`` axes).  ``data=`` calls ``log_prob_fn(theta, data)``.  ``key`` is
    an integer seed; the walkers live on the device of ``theta0`` (the card
    for a start that is not a tensor).

    Chunked runs resume bit for bit: feed ``final_walkers`` /
    ``final_logp`` / ``final_step`` back with the same key and config.
    """
    walkers, fn, unravel = _prep_walkers(key, _bind_data(log_prob_fn, data), theta0,
                                         num_walkers, init_jitter)
    r = _run_stretch(key, walkers, fn, config, num_walkers, init_logp=init_logp,
                     start_step=int(start_step), _noise=_noise, _margins=_margins)
    if unravel is not None:
        r = r._replace(samples=unravel(r.samples), final_walkers=unravel(r.final_walkers))
    return r
