"""Fused frozen-(eps, L) MCLMC for one-hidden-layer tanh regression BNNs.

Counterpart of ``hamiltorch_tpu/kernels/bnn_mclmc.py::bnn_mclmc``: the
whole MCLMC sampler at a fixed step size and momentum-coherence length for
the model of ``kernels/bnn_hmc.py``,

    o = tanh(x @ W1 + b1) @ w2 + b2,
    logp = -tau/2 * sum((o - y)^2) - 1/2 * ||theta||^2,

over C chains.  Per draw: the minimal-norm step V(b1 eps) X(eps/2)
V((1 - 2 b1) eps) X(eps/2) V(b1 eps), where each V is an exact isokinetic
rotation of the unit velocity toward the gradient (the closed form of
``samplers/mclmc.py::_velocity_update``, in the kernel's arrangement
``u_new = g ce + 2 zeta u``), then the partial refresh
``u <- unit(u + nu z)`` with ``nu = sqrt(expm1(2 eps / L) / d)``.  It
returns the final (W1, b1, w2, b2) and each chain's realised
``var_e = sum(dE^2) / num_samples / d``, the tuner's target statistic.
Tune first with ``run_mclmc_chains`` and hand its tuned (eps, L), final
state and final velocity to this kernel.

Two versions of the same function live here:

* ``bnn_mclmc`` is the wrapper.  On CUDA tensors it launches the CUDA
  kernel of ``csrc/bnn_mclmc.cu`` (built for Hopper at first use) and
  nothing else; on CPU tensors it calls the plain version, and on any other
  device it raises.  The tensors' device takes the place of the JAX
  function's ``interpret`` flag.  The kernel's gradients run on the tensor
  cores in 3xTF32 (``csrc/bnn_grad.cuh``), which keeps float32 accuracy;
  the workspace size comes from the C side.
* ``bnn_mclmc_reference`` is the plain PyTorch version, with the kernel's
  arithmetic: norms, dots and logp reduced in float64, the rotation's
  scalars in float64 and applied in float32, parameters, velocities and
  gradients in float32.  The CPU tests hold it against the Pallas kernel,
  and ``chip_smoke.py`` holds the CUDA kernel against it.

Both compute over the REAL dimensions only; the JAX kernel pads W1's rows
and masks them out of every norm and the refresh, so the two agree at every
shape.  Neither guards against non-finite steps (``run_mclmc*`` does).

``_noise = normals (S, C, D)`` makes either version use the given refresh
normals instead of its own (a test hook, off the main path), in the flat
layout w1 (row-major), b1, w2, b2.  Without it the plain version draws
from ``utils.rng``'s per-(seed, chain, draw) streams and the CUDA kernel
from Philox keyed the same way; the two streams differ.  ``u`` and the
normals keep this flat layout although the kernel holds W1 transposed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import profiling
from ..utils.rng import draw_normals
from .bnn_grad import BACKWARD_PHASES, _check, _grads_and_logp, _grids

_B1 = 0.1931833275037836  # minimal-norm (McLachlan) velocity coefficient


def _refresh_weight(step_size, length, dims) -> float:
    """nu = sqrt(expm1(2 eps / L) / d), in float64 on the host."""
    return math.sqrt(math.expm1(2.0 * step_size / length) / dims)


def _unit(v):
    """v / |v| per chain, the norm reduced in float64 and applied in float32."""
    inv = 1.0 / torch.sqrt(torch.sum(v.double() ** 2, dim=1))
    return v * inv.float()[:, None]


def _rotate(u, g, coef, dims):
    """One isokinetic rotation of u toward g: (unit(u_new), dk) per chain."""
    gd = g.double()
    g_norm = torch.sqrt(torch.sum(gd * gd, dim=1))
    inv_g = 1.0 / torch.clamp(g_norm, min=1e-30)
    delta = coef * g_norm / (dims - 1.0)
    ue = torch.clamp(torch.sum(u.double() * gd, dim=1) * inv_g, -1.0, 1.0)
    zeta = torch.exp(-delta)
    ce = (1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) * inv_g
    u_new = g * ce.float()[:, None] + (2.0 * zeta).float()[:, None] * u
    dk = (dims - 1.0) * (
        delta - math.log(2.0)
        + torch.log(torch.clamp(1.0 + ue + (1.0 - ue) * zeta * zeta, min=1e-12))
    )
    return _unit(u_new), dk


def bnn_mclmc_reference(
    seed,
    x: torch.Tensor,  # (N, I) inputs
    y: torch.Tensor,  # (N, 1) targets
    w1: torch.Tensor,  # (C, I, H) per-chain initial weights
    b1: torch.Tensor,  # (C, H)
    w2: torch.Tensor,  # (C, H)
    b2: torch.Tensor,  # (C,)
    u: torch.Tensor,  # (C, D) initial velocities, D = I*H + 2H + 1
    num_samples: int,
    step_size: float,
    length: float,
    tau: float = 10.0,
    _noise=None,
):
    """Plain PyTorch version of ``bnn_mclmc``; same arguments and returns."""
    c, i_dim, h = w1.shape
    s0, s1 = i_dim * h, i_dim * h + h
    dims = s1 + h + 1
    eps = step_size
    nu = _refresh_weight(step_size, length, dims)

    def grad_flat(th):
        grads, logp = _grads_and_logp(
            x, y, th[:, :s0].reshape(c, i_dim, h), th[:, s0:s1], th[:, s1:s1 + h], th[:, -1], tau
        )
        return torch.cat([t.reshape(c, -1) for t in grads], dim=1), logp

    th = torch.cat([t.reshape(c, -1) for t in (w1, b1, w2, b2)], dim=1)
    u = _unit(u)
    g, logp = grad_flat(th)
    sum_de2 = torch.zeros(c, dtype=torch.float64, device=x.device)
    for n in range(num_samples):
        u, dk1 = _rotate(u, g, _B1 * eps, dims)
        th = th + (0.5 * eps) * u
        g, _ = grad_flat(th)
        u, dk2 = _rotate(u, g, (1.0 - 2.0 * _B1) * eps, dims)
        th = th + (0.5 * eps) * u
        g, logp2 = grad_flat(th)
        u, dk3 = _rotate(u, g, _B1 * eps, dims)
        de = dk1 + dk2 + dk3 + (logp - logp2)
        sum_de2 += de * de
        logp = logp2
        z = draw_normals(seed, n, c, dims, device=x.device) if _noise is None else _noise[n]
        u = _unit(u + nu * z)
    var_e = (sum_de2 / num_samples / dims).float()
    return (th[:, :s0].reshape(c, i_dim, h), th[:, s0:s1], th[:, s1:s1 + h], th[:, -1], var_e)


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("bnn_mclmc")
    lib.bnn_mclmc_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.bnn_mclmc_workspace_bytes.restype = ctypes.c_size_t
    lib.bnn_mclmc_error_string.argtypes = [ctypes.c_int]
    lib.bnn_mclmc_error_string.restype = ctypes.c_char_p
    lib.bnn_mclmc_run.argtypes = (
        [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 3
        + [ctypes.c_ulonglong]
        + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    )
    lib.bnn_mclmc_run.restype = ctypes.c_int
    return lib


def bnn_mclmc(
    seed,
    x: torch.Tensor,  # (N, I) inputs
    y: torch.Tensor,  # (N, 1) targets
    w1: torch.Tensor,  # (C, I, H) per-chain initial weights
    b1: torch.Tensor,  # (C, H)
    w2: torch.Tensor,  # (C, H)
    b2: torch.Tensor,  # (C,)
    u: torch.Tensor,  # (C, D) initial velocities, D = I*H + 2H + 1
    num_samples: int,
    step_size: float,
    length: float,
    tau: float = 10.0,
    _noise=None,
):
    """Fused frozen-scale MCLMC over C chains of the tanh-MLP BNN.

    Returns (w1_f, b1_f, w2_f, b2_f, var_e): final per-chain parameters and
    the realised per-dimension energy-error second moment.  ``u`` is the
    flat initial velocity in (w1, b1, w2, b2) order (a ``run_mclmc_chains``
    result's ``final_u``, or any nonzero vector; it is normalised first).
    On CUDA, H must be a multiple of 128 and C at most 65535 (the kernel
    rejects other shapes with cudaErrorInvalidValue, and this raises); N and
    I are free.  ``bnn_mclmc.launches`` counts the runs of the CUDA kernel.
    While the recorder (``utils/profiling.py``) records, a call is recorded
    as ``bnn_hmc``'s is, under the name ``bnn_mclmc``, and adds to the same
    ``bnn_backward`` counters.
    """
    with profiling.annotate("bnn_mclmc"):
        device = x.device
        with profiling.annotate("bnn_mclmc.prepare"):
            n, i_dim = x.shape
            c, _, h = w1.shape
            dim = i_dim * h + 2 * h + 1
            for name, t, shape in (
                ("x", x, (n, i_dim)), ("y", y, (n, 1)), ("w1", w1, (c, i_dim, h)),
                ("b1", b1, (c, h)), ("w2", w2, (c, h)), ("b2", b2, (c,)), ("u", u, (c, dim)),
            ):
                _check(name, t, shape, device)
            if num_samples < 1:
                raise ValueError("num_samples must be >= 1")
            if not (step_size > 0 and length > 0):
                raise ValueError("step_size and length must be positive")
            if _noise is not None:
                _check("normals", _noise, (num_samples, c, dim), device)
            if device.type == "cuda":
                lib = _library()
                outs = (torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2),
                        torch.empty_like(b2), torch.empty((c,), dtype=torch.float32,
                                                          device=device))
                workspace = torch.empty((lib.bnn_mclmc_workspace_bytes(n, i_dim, h, c),),
                                        dtype=torch.uint8, device=device)
                grids = _grids(n, i_dim, h, c, device)
                stats = profiling.launch_stats()
                phases = profiling.device_counters("bnn_backward", BACKWARD_PHASES, device)

        if device.type == "cpu":
            return bnn_mclmc_reference(seed, x, y, w1, b1, w2, b2, u, num_samples, step_size,
                                       length, tau, _noise=_noise)
        if device.type != "cuda":
            raise ValueError(f"bnn_mclmc runs on CUDA or CPU tensors, not {device}")

        with profiling.annotate("bnn_mclmc.enqueue"), torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.bnn_mclmc_run(
                x.data_ptr(), y.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), u.data_ptr(),
                *(o.data_ptr() for o in outs), workspace.data_ptr(),
                n, i_dim, h, c, num_samples,
                float(step_size), _refresh_weight(step_size, length, dim), float(tau),
                int(seed) & (2**64 - 1),
                None if _noise is None else _noise.data_ptr(),
                *grids, stream, stats, None if phases is None else phases.data_ptr(),
            )
        if err != 0:
            msg = lib.bnn_mclmc_error_string(err).decode()
            raise RuntimeError(f"bnn_mclmc CUDA kernel failed: cudaError_t {err} ({msg})")
        profiling.record_launch_stats("bnn_mclmc", stats)
        bnn_mclmc.launches += 1
        return outs


bnn_mclmc.launches = 0
