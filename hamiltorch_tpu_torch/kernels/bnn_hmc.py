"""Fused HMC for one-hidden-layer tanh regression BNNs.

Counterpart of ``hamiltorch_tpu/kernels/bnn_hmc.py::bnn_hmc``: the whole
sampler for the model

    o = tanh(x @ W1 + b1) @ w2 + b2,
    logp = -tau/2 * sum((o - y)^2) - 1/2 * ||theta||^2

over C chains: per draw, fresh momenta, a half kick, L drift+kick steps
with a hand-written backward pass, half a kick pulled back, and a
Metropolis test ``(h0 - h1) >= log u`` with one uniform per chain.  It
returns the final (W1, b1, w2, b2) and the acceptance rate of each chain.

Two versions of the same function live here:

* ``bnn_hmc`` is the wrapper.  On CUDA tensors it launches the CUDA kernel
  of ``csrc/bnn_hmc.cu`` (built for Hopper at first use) and nothing else;
  on CPU tensors it calls the plain version, and on any other device it
  raises.  The tensors' device takes the place of the JAX function's
  ``interpret`` flag.  The kernel's two GEMMs per step run on the tensor
  cores in 3xTF32 (``csrc/bnn_grad.cuh``: each float32 operand split into
  two tf32 parts, three products), which keeps float32 accuracy; the
  workspace size comes from the C side.
* ``bnn_hmc_reference`` is the plain PyTorch version.  The CPU tests hold
  it against the Pallas kernel and against autodiff, and ``chip_smoke.py``
  holds the CUDA kernel against it.

Both compute over the REAL dimensions only.  The JAX kernel pads W1's input
rows up to a multiple of 128 and then draws momenta for the padded rows,
counts them in the kinetic energy and the prior, and moves them under the
gradient -w1; on the flagship (784 -> 896 rows) it thereby samples the
posterior augmented by 14,336 independent N(0, 1) dimensions, which changes
its energy error and acceptance rate.  Here, as on the JAX scan path and in
``bnn_mclmc``, the padded rows do not exist.  At an input width that is a
multiple of 128 the two agree exactly.

Energies (kinetic energy, likelihood, prior) are reduced in float64 in both
versions: at the flagship each is a sum near 5e4, where float32 rounding
alone is about 1e-2, while the Metropolis test compares their difference
with log u.  Parameters, momenta and gradients stay float32.

``_noise = (momenta (S, C, D), uniforms (S, C))`` makes either version use
the given momenta and uniforms instead of its own random numbers (a test
hook, off the main path).  Momenta are in the flat layout w1 (row-major),
b1, w2, b2 of each chain, D = I*H + 2H + 1.  Without it the plain version
draws from ``utils.rng``'s per-(seed, chain, draw) streams and the CUDA
kernel from Philox keyed the same way; the two streams differ.  (The
kernel keeps W1 transposed in its own state; the given momenta and its
Philox counters stay keyed on this flat layout.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from ..utils.rng import draw_noise
from .bnn_grad import BACKWARD_PHASES, _check, _grads_and_logp, _grids, _sq_sum


def bnn_hmc_reference(
    seed,
    x: torch.Tensor,  # (N, I) inputs
    y: torch.Tensor,  # (N, 1) targets
    w1: torch.Tensor,  # (C, I, H) per-chain initial weights
    b1: torch.Tensor,  # (C, H)
    w2: torch.Tensor,  # (C, H)
    b2: torch.Tensor,  # (C,)
    num_samples: int,
    num_steps: int = 10,
    step_size: float = 1e-3,
    tau: float = 10.0,
    _noise=None,
):
    """Plain PyTorch version of ``bnn_hmc``; same arguments and returns."""
    c, i_dim, h = w1.shape
    dim = i_dim * h + 2 * h + 1
    eps = step_size
    theta = (w1, b1, w2, b2)
    grad, logp = _grads_and_logp(x, y, *theta, tau)
    acc = torch.zeros(c, dtype=torch.float32, device=x.device)

    def split(flat):
        s0, s1 = i_dim * h, i_dim * h + h
        return (flat[:, :s0].reshape(c, i_dim, h), flat[:, s0:s1],
                flat[:, s1:s1 + h], flat[:, s1 + h])

    for n in range(num_samples):
        if _noise is None:
            z, log_u = draw_noise(seed, n, c, dim, torch.float32, x.device)
            log_u = log_u.double()
        else:
            z, log_u = _noise[0][n], torch.log(_noise[1][n].double())
        p = split(z)
        h0 = -logp + 0.5 * _sq_sum(p)
        p = tuple(pi + 0.5 * eps * gi for pi, gi in zip(p, grad))
        th, g, logp_new = theta, grad, logp
        for _ in range(num_steps):
            th = tuple(ti + eps * pi for ti, pi in zip(th, p))
            g, logp_new = _grads_and_logp(x, y, *th, tau)
            p = tuple(pi + eps * gi for pi, gi in zip(p, g))
        p = tuple(pi - 0.5 * eps * gi for pi, gi in zip(p, g))
        h1 = -logp_new + 0.5 * _sq_sum(p)
        accept = (h0 - h1) >= log_u

        def pick(a, b):
            return torch.where(accept.reshape((c,) + (1,) * (a.ndim - 1)), a, b)

        theta = tuple(pick(a, b) for a, b in zip(th, theta))
        grad = tuple(pick(a, b) for a, b in zip(g, grad))
        logp = torch.where(accept, logp_new, logp)
        acc += accept.to(torch.float32)
    return (*theta, acc / num_samples)


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("bnn_hmc")
    lib.bnn_hmc_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.bnn_hmc_workspace_bytes.restype = ctypes.c_size_t
    lib.bnn_hmc_error_string.argtypes = [ctypes.c_int]
    lib.bnn_hmc_error_string.restype = ctypes.c_char_p
    lib.bnn_hmc_run.argtypes = (
        [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    )
    lib.bnn_hmc_run.restype = ctypes.c_int
    return lib


def bnn_hmc(
    seed,
    x: torch.Tensor,  # (N, I) inputs
    y: torch.Tensor,  # (N, 1) targets
    w1: torch.Tensor,  # (C, I, H) per-chain initial weights
    b1: torch.Tensor,  # (C, H)
    w2: torch.Tensor,  # (C, H)
    b2: torch.Tensor,  # (C,)
    num_samples: int,
    num_steps: int = 10,
    step_size: float = 1e-3,
    tau: float = 10.0,
    _noise=None,
):
    """Fused HMC over C chains of the tanh-MLP regression BNN.

    Returns (w1_f, b1_f, w2_f, b2_f, acc): final per-chain parameters and
    acceptance rates.  On CUDA, H must be a multiple of 128 and C at most
    65535 (the kernel rejects other shapes with cudaErrorInvalidValue, and
    this raises); N and I are free.  ``bnn_hmc.launches`` counts the runs of
    the CUDA kernel.  While the recorder (``utils/profiling.py``) records, a
    call is the span ``bnn_hmc`` with the children ``.prepare``,
    ``.enqueue`` and the C entry's ``.prologue``, and adds to the counters
    ``bnn_hmc.kernel_launches``, ``.launch_ns`` and ``.prologue_ns`` and to
    the backward GEMM's ``bnn_backward.<BACKWARD_PHASES>``.
    """
    with profiling.annotate("bnn_hmc"):
        device = x.device
        with profiling.annotate("bnn_hmc.prepare"):
            n, i_dim = x.shape
            c, _, h = w1.shape
            for name, t, shape in (
                ("x", x, (n, i_dim)), ("y", y, (n, 1)), ("w1", w1, (c, i_dim, h)),
                ("b1", b1, (c, h)), ("w2", w2, (c, h)), ("b2", b2, (c,)),
            ):
                _check(name, t, shape, device)
            if num_samples < 1 or num_steps < 1:
                raise ValueError("num_samples and num_steps must be >= 1")
            dim = i_dim * h + 2 * h + 1
            if _noise is not None:
                _check("momenta", _noise[0], (num_samples, c, dim), device)
                _check("uniforms", _noise[1], (num_samples, c), device)
            if device.type == "cuda":
                lib = _library()
                outs = (torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2),
                        torch.empty_like(b2), torch.empty((c,), dtype=torch.float32,
                                                          device=device))
                workspace = torch.empty((lib.bnn_hmc_workspace_bytes(n, i_dim, h, c),),
                                        dtype=torch.uint8, device=device)
                grids = _grids(n, i_dim, h, c, device)
                stats = profiling.launch_stats()
                phases = profiling.device_counters("bnn_backward", BACKWARD_PHASES, device)

        if device.type == "cpu":
            return bnn_hmc_reference(seed, x, y, w1, b1, w2, b2, num_samples,
                                     num_steps, step_size, tau, _noise=_noise)
        if device.type != "cuda":
            raise ValueError(f"bnn_hmc runs on CUDA or CPU tensors, not {device}")

        momenta, uniforms = (None, None) if _noise is None else _noise
        with profiling.annotate("bnn_hmc.enqueue"), torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.bnn_hmc_run(
                x.data_ptr(), y.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                *(o.data_ptr() for o in outs), workspace.data_ptr(),
                n, i_dim, h, c, num_samples, num_steps,
                float(step_size), float(tau), int(seed) & (2**64 - 1),
                None if momenta is None else momenta.data_ptr(),
                None if uniforms is None else uniforms.data_ptr(),
                *grids, stream, stats, None if phases is None else phases.data_ptr(),
            )
        if err != 0:
            msg = lib.bnn_hmc_error_string(err).decode()
            raise RuntimeError(f"bnn_hmc CUDA kernel failed: cudaError_t {err} ({msg})")
        profiling.record_launch_stats("bnn_hmc", stats)
        bnn_hmc.launches += 1
        return outs


bnn_hmc.launches = 0
