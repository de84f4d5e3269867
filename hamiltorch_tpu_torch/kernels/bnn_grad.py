"""One gradient evaluation of the tanh-MLP regression BNN, alone (private).

``_bnn_gradient`` evaluates, for every chain, the gradient of

    logp = -tau/2 * sum((tanh(x @ W1 + b1) @ w2 + b2 - y)^2) - 1/2 * ||theta||^2

and logp itself, at flat parameters ``theta (C, D)`` in the layout w1
(row-major), b1, w2, b2.  On CUDA tensors it launches ``csrc/bnn_grad.cu``:
the same GEMM pair (forward ``W1.T @ x.T`` and backward ``da.T @ x``,
persistent wgmma tiles in 3xTF32) and per-chain reduction that ``bnn_hmc``
and ``bnn_mclmc`` run at every step, so that tests can hold the pair against
the plain gradient at any shape and ``chip_smoke.py`` can time it against
cuBLAS.  On CPU tensors it calls ``_bnn_gradient_reference``, the plain
PyTorch version (``_grads_and_logp``, which the plain versions of
``bnn_hmc`` and ``bnn_mclmc`` call too).  It is not exported and no sampler
calls it.

``_plan`` decides, for all three CUDA entries, how many blocks each GEMM's
persistent grid has; ``_walk`` is the tile list a block takes from it, and
in the backward each of its consumer warpgroups takes alternate tiles of
that list (``csrc/bnn_grad.cuh`` walks the same lists).

``BACKWARD_PHASES`` names the backward kernel's phase counters
(``csrc/bnn_grad.cuh``'s ``BwdPhase``), which ``bnn_hmc`` and
``bnn_mclmc`` pass down while the recorder (``utils/profiling.py``) records.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import NamedTuple

import torch

BACKWARD_PHASES = ("products_cycles", "epilogue_cycles")


def _grads_and_logp(x, y, w1, b1, w2, b2, tau):
    """Gradients of logp for every chain, and logp in float64."""
    a = torch.matmul(x, w1) + b1[:, None, :]  # (C, N, H)
    h = torch.tanh(a)
    o = torch.sum(h * w2[:, None, :], dim=-1) + b2[:, None]  # (C, N)
    resid = o - y[:, 0]
    d = -tau * resid  # dlogp/do
    g_w2 = torch.sum(h * d[..., None], dim=1) - w2
    g_b2 = torch.sum(d, dim=1) - b2
    da = d[..., None] * w2[:, None, :] * (1.0 - h * h)  # (C, N, H)
    g_w1 = torch.matmul(x.T, da) - w1
    g_b1 = torch.sum(da, dim=1) - b1
    ll = -0.5 * tau * torch.sum(resid.double() ** 2, dim=1)
    prior = -0.5 * _sq_sum((w1, b1, w2, b2))
    return (g_w1, g_b1, g_w2, g_b2), ll + prior


def _sq_sum(parts):
    """Per-chain sum of squares over (C, ...) tensors, in float64."""
    return sum(torch.sum(t.double().reshape(t.shape[0], -1) ** 2, dim=1) for t in parts)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _tiles() -> tuple:
    """The GEMM tiles as csrc/bnn_grad.cuh sets them, read from it: a forward
    tile is FNC rows of x of one chain, all its hidden units, shared by a
    block's consumer warpgroups; a backward tile is HB = BWD_MB x BM hidden
    units by BNB inputs of one chain, and the CONSUMERS take alternate ones."""
    text = (Path(__file__).parent / "csrc" / "bnn_grad.cuh").read_text()
    c = {name: int(re.search(rf"^constexpr int {name} = (\d+);", text, re.M).group(1))
         for name in ("FNC", "BM", "BWD_MB", "BNB", "CONSUMERS")}
    return c["FNC"], c["BWD_MB"] * c["BM"], c["BNB"], c["CONSUMERS"]


FWD_ROWS, BWD_HIDDEN, BWD_INPUTS, CONSUMERS = _tiles()  # 128, 64, 112, 2


class GemmPlan(NamedTuple):
    fwd_tiles: int  # chains x ceil(N / 128)
    bwd_tiles: int  # chains x H / 64 x ceil(I / 112)
    fwd_grid: int  # blocks of the forward GEMM
    bwd_grid: int  # blocks of the backward GEMM


def _grid(tiles: int, sm_count: int) -> int:
    """Blocks of a persistent walk over ``tiles``: at most one an SM, and
    the fewest that keep the longest walk as short (0 without tiles)."""
    if tiles < 1:
        return 0
    per_block = -(-tiles // sm_count)
    return -(-tiles // per_block)


def _plan(n: int, i_dim: int, hidden: int, chains: int, sm_count: int) -> GemmPlan:
    """Each GEMM's tiles and blocks for these shapes on a card of ``sm_count``
    SMs.  Tile t of a GEMM is chain t // (tiles / chains), so the list is
    ordered by chain; block b walks tiles b, b + grid, b + 2 grid, ..."""
    fwd = chains * -(-n // FWD_ROWS)
    bwd = chains * (hidden // BWD_HIDDEN) * -(-i_dim // BWD_INPUTS)
    return GemmPlan(fwd, bwd, _grid(fwd, sm_count), _grid(bwd, sm_count))


def _walk(tiles: int, grid: int, block: int, consumer=None) -> list:
    """The tiles that block ``block`` takes, in its order; with
    ``consumer``, those that consumer warpgroup takes of them in the
    backward: every CONSUMERS-th from its own index."""
    walk = list(range(block, tiles, grid))
    return walk if consumer is None else walk[consumer::CONSUMERS]


def _grids(n, i_dim, hidden, chains, device) -> tuple:
    """(forward, backward) blocks for the CUDA entries on ``device``."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    plan = _plan(n, i_dim, hidden, chains, sm_count)
    return plan.fwd_grid, plan.bwd_grid


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("bnn_grad")
    lib.bnn_grad_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.bnn_grad_workspace_bytes.restype = ctypes.c_size_t
    lib.bnn_grad_error_string.argtypes = [ctypes.c_int]
    lib.bnn_grad_error_string.restype = ctypes.c_char_p
    lib.bnn_grad_run.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
            workspace.data_ptr(), n, i_dim, hidden, c, int(repeats), float(tau),
            *_grids(n, i_dim, hidden, c, device), stream,
        )
    if err != 0:
        msg = lib.bnn_grad_error_string(err).decode()
        raise RuntimeError(f"bnn_grad CUDA kernel failed: cudaError_t {err} ({msg})")
    _bnn_gradient.launches += 1
    return grad, logp


_bnn_gradient.launches = 0
