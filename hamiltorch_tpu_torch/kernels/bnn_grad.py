"""One gradient evaluation of the tanh-MLP regression BNN, alone (private).

``_bnn_gradient`` evaluates, for every chain, the gradient of

    logp = -tau/2 * sum((tanh(x @ W1 + b1) @ w2 + b2 - y)^2) - 1/2 * ||theta||^2

and logp itself, at flat parameters ``theta (C, D)`` in the layout w1
(row-major), b1, w2, b2.  On CUDA tensors it launches ``csrc/bnn_grad.cu``:
the same GEMM pair (forward ``x @ W1`` and backward ``x.T @ da``, wgmma
tiles in 3xTF32) and per-chain reduction that ``bnn_hmc`` and ``bnn_mclmc``
run at every step, so that tests can hold the pair against the plain
gradient at any shape and ``chip_smoke.py`` can time it against cuBLAS.  On
CPU tensors it calls ``_bnn_gradient_reference``, the plain PyTorch version
(``bnn_hmc._grads_and_logp``).  It is not exported and no sampler calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .bnn_hmc import _check, _grads_and_logp


def _hidden(theta, i_dim) -> int:
    """H from D = I*H + 2H + 1."""
    h, rest = divmod(theta.shape[1] - 1, i_dim + 2)
    if rest or h < 1:
        raise ValueError(f"theta has {theta.shape[1]} columns: not I*H + 2H + 1 for I = {i_dim}")
    return h


def _bnn_gradient_reference(x, y, theta, tau=10.0):
    """Plain PyTorch version of ``_bnn_gradient``; same arguments and returns."""
    c, i_dim = theta.shape[0], x.shape[1]
    h = _hidden(theta, i_dim)
    s0, s1 = i_dim * h, i_dim * h + h
    grads, logp = _grads_and_logp(x, y, theta[:, :s0].reshape(c, i_dim, h), theta[:, s0:s1],
                                  theta[:, s1:s1 + h], theta[:, -1], tau)
    return torch.cat([t.reshape(c, -1) for t in grads], dim=1), logp


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("bnn_grad")
    lib.bnn_grad_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.bnn_grad_workspace_bytes.restype = ctypes.c_size_t
    lib.bnn_grad_error_string.argtypes = [ctypes.c_int]
    lib.bnn_grad_error_string.restype = ctypes.c_char_p
    lib.bnn_grad_run.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.bnn_grad_run.restype = ctypes.c_int
    return lib


def _bnn_gradient(x, y, theta, tau: float = 10.0, repeats: int = 1):
    """(grad (C, D), logp (C,) float64) of the BNN at ``theta (C, D)``.

    ``x`` is (N, I), ``y`` (N, 1), D = I*H + 2H + 1 (H is read from D).  On
    CUDA, H must be a multiple of 128 and C at most 65535 (the kernel
    rejects other shapes with cudaErrorInvalidValue, and this raises).
    ``repeats`` > 1 evaluates the same gradient that many times in one call
    (for timing).  ``_bnn_gradient.launches`` counts the CUDA calls.
    """
    device = x.device
    n, i_dim = x.shape
    if not isinstance(theta, torch.Tensor) or theta.ndim != 2:
        raise ValueError("theta must be a (C, D) tensor")
    c, hidden = theta.shape[0], _hidden(theta, i_dim)
    for name, t, shape in (("x", x, (n, i_dim)), ("y", y, (n, 1)), ("theta", theta, theta.shape)):
        _check(name, t, shape, device)
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    if device.type == "cpu":
        return _bnn_gradient_reference(x, y, theta, tau)
    if device.type != "cuda":
        raise ValueError(f"_bnn_gradient runs on CUDA or CPU tensors, not {device}")

    lib = _library()
    grad = torch.empty_like(theta)
    logp = torch.empty((c,), dtype=torch.float64, device=device)
    workspace = torch.empty(
        (lib.bnn_grad_workspace_bytes(n, i_dim, hidden, c),), dtype=torch.uint8, device=device
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bnn_grad_run(
            x.data_ptr(), y.data_ptr(), theta.data_ptr(), grad.data_ptr(), logp.data_ptr(),
            workspace.data_ptr(), n, i_dim, hidden, c, int(repeats), float(tau), stream,
        )
    if err != 0:
        msg = lib.bnn_grad_error_string(err).decode()
        raise RuntimeError(f"bnn_grad CUDA kernel failed: cudaError_t {err} ({msg})")
    _bnn_gradient.launches += 1
    return grad, logp


_bnn_gradient.launches = 0
