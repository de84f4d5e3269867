"""Fused multi-chain HMC for Gaussian targets.

Counterpart of ``hamiltorch_tpu/kernels/gaussian_hmc.py::gaussian_hmc``:
the whole HMC sampler for logp(theta) = -1/2 (theta - mean)^T P
(theta - mean) with P diagonal (a (D,) vector) or dense SPD (a (D, D)
matrix), identity mass, over C chains.  Per draw: standard-normal momenta,
a half kick, L drift+kick steps, half a kick pulled back, and the
Metropolis test ``(h0 - h1) >= log u``.  It returns every draw
``(C, num_samples, D)`` and each chain's acceptance rate.  These are the
reference's headline small-D targets (the 3-D Gaussian of BASELINE config 1).

Two versions of the same function live here:

* ``gaussian_hmc`` is the wrapper.  On CUDA tensors it launches the CUDA
  kernel of ``csrc/gaussian_hmc.cu`` (built for Hopper at first use) and
  nothing else; on CPU tensors it calls the plain version, and on any other
  device it raises.  The tensors' device takes the place of the JAX
  function's ``interpret`` flag.
* ``gaussian_hmc_reference`` is the plain PyTorch version, with the
  kernel's arithmetic (the gradient carried between draws; energies
  reduced in float64).  The CPU tests hold it against the Pallas kernel,
  and ``chip_smoke.py`` holds the CUDA kernel against it.

Both compute over the real D only; the JAX kernel pads D to 128 lanes and
masks the padding out, so the two agree at every D.

``_noise = (momenta (S, C, D), uniforms (S, C))`` makes either version use
the given numbers instead of its own (a test hook, off the main path).
Without it the CUDA kernel draws from Philox keyed on (seed, chain, draw)
and the plain version from one ``torch.Generator`` per draw seeded by
``utils.rng.draw_seed(seed, 0, draw)``; the two streams differ.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.rng import draw_seed
from .bnn_hmc import _check


def _grad(th, mu, precision):
    """-(theta - mean) P (dense) or -(theta - mean) * P (diagonal), per chain."""
    delta = th - mu
    if precision.ndim == 2:
        return -(delta @ precision)
    return -(delta * precision)


def _energy(th, mu, g, p):
    """-1/2 (theta - mean).g + 1/2 |p|^2 per chain, in float64."""
    pot = -0.5 * torch.sum((th - mu).double() * g.double(), dim=1)
    return pot + 0.5 * torch.sum(p.double() ** 2, dim=1)


def gaussian_hmc_reference(seed, theta0, precision, num_samples, num_steps=10, step_size=0.1,
                           chain_tile=8, mean=None, _noise=None):
    """Plain PyTorch version of ``gaussian_hmc``; same arguments and returns.

    ``chain_tile`` only matters to the CUDA kernel.
    """
    del chain_tile
    c, d = theta0.shape
    eps = step_size
    mu = torch.zeros(d, dtype=theta0.dtype, device=theta0.device) if mean is None else mean
    theta = theta0
    g_cur = _grad(theta, mu, precision)
    out = torch.empty((c, num_samples, d), dtype=theta0.dtype, device=theta0.device)
    accepted = torch.zeros(c, dtype=torch.float32, device=theta0.device)
    gen = None if _noise is not None else torch.Generator(device=theta0.device)
    for n in range(num_samples):
        if _noise is None:
            gen.manual_seed(draw_seed(seed, 0, n))
            p = torch.randn((c, d), generator=gen, dtype=theta0.dtype, device=theta0.device)
            u = torch.rand((c,), generator=gen, dtype=theta0.dtype, device=theta0.device)
        else:
            p, u = _noise[0][n], _noise[1][n]
        h0 = _energy(theta, mu, g_cur, p)
        p = p + (0.5 * eps) * g_cur
        th, g = theta, g_cur
        for _ in range(num_steps):
            th = th + eps * p
            g = _grad(th, mu, precision)
            p = p + eps * g
        p = p - (0.5 * eps) * g
        h1 = _energy(th, mu, g, p)
        accept = (h0 - h1) >= torch.log(u.double())
        theta = torch.where(accept[:, None], th, theta)
        g_cur = torch.where(accept[:, None], g, g_cur)
        out[:, n] = theta
        accepted += accept.to(torch.float32)
    return out, accepted / num_samples


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("gaussian_hmc")
    lib.gaussian_hmc_error_string.argtypes = [ctypes.c_int]
    lib.gaussian_hmc_error_string.restype = ctypes.c_char_p
    lib.gaussian_hmc_run.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int]
        + [ctypes.c_void_p] * 3
    )
    lib.gaussian_hmc_run.restype = ctypes.c_int
    return lib


def gaussian_hmc(seed, theta0, precision, num_samples, num_steps=10, step_size=0.1,
                 chain_tile=8, mean=None, _noise=None):
    """Sample C chains from N(mean, P^-1); returns (samples (C, N, D), acc (C,)).

    ``precision`` is (D,) for a diagonal P or (D, D) for a dense SPD one;
    ``mean`` is (D,) or None for zero.  On the card each chain is one warp
    whose state stays in registers, and ``chain_tile`` is the number of
    chains (warps) in one thread block: the block loads a dense P into its
    shared memory once for all its chains.  The kernel takes D <= 256,
    ``1 <= chain_tile <= 32`` and, for dense P, (D + chain_tile) * D floats
    of shared memory at most 232,448 bytes (D <= 220 at ``chain_tile`` 8);
    for other shapes it returns cudaErrorInvalidValue and this raises.
    ``gaussian_hmc.launches`` counts the runs of the CUDA kernel.
    """
    device = theta0.device
    if theta0.ndim != 2:
        raise ValueError(f"theta0 must be (C, D), got shape {tuple(theta0.shape)}")
    c, d = theta0.shape
    _check("theta0", theta0, (c, d), device)
    if precision.ndim not in (1, 2):
        raise ValueError(f"precision must be (D,) or (D, D), got shape {tuple(precision.shape)}")
    _check("precision", precision, (d,) * precision.ndim, device)
    if mean is not None:
        _check("mean", mean, (d,), device)
    if num_samples < 1 or num_steps < 1:
        raise ValueError("num_samples and num_steps must be >= 1")
    if _noise is not None:
        _check("momenta", _noise[0], (num_samples, c, d), device)
        _check("uniforms", _noise[1], (num_samples, c), device)

    if device.type == "cpu":
        return gaussian_hmc_reference(seed, theta0, precision, num_samples, num_steps,
                                      step_size, chain_tile, mean, _noise=_noise)
    if device.type != "cuda":
        raise ValueError(f"gaussian_hmc runs on CUDA or CPU tensors, not {device}")

    lib = _library()
    out = torch.empty((c, num_samples, d), dtype=torch.float32, device=device)
    acc = torch.empty((c,), dtype=torch.float32, device=device)
    momenta, uniforms = (None, None) if _noise is None else _noise
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.gaussian_hmc_run(
            theta0.data_ptr(), precision.data_ptr(),
            None if mean is None else mean.data_ptr(), out.data_ptr(), acc.data_ptr(),
            c, d, int(precision.ndim == 2), num_samples, num_steps,
            float(step_size), int(seed) & (2**64 - 1), int(chain_tile),
            None if momenta is None else momenta.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            stream,
        )
    if err != 0:
        msg = lib.gaussian_hmc_error_string(err).decode()
        raise RuntimeError(f"gaussian_hmc CUDA kernel failed: cudaError_t {err} ({msg}); "
                           "see the docstring for the shapes it takes")
    gaussian_hmc.launches += 1
    return out, acc


gaussian_hmc.launches = 0
