"""Filter response normalisation with its thresholded linear unit (FRN with TLU).

``frn_tlu(x, gamma, beta, tau, eps)`` computes, per (image, channel) plane
of an NCHW tensor ``x`` and per channel parameters ``gamma``, ``beta`` and
``tau`` (any shape of C elements, as ``(1, C, 1, 1)``),

    z = max(gamma x / sqrt(mean_hw x^2 + eps) + beta, tau).

For a CPU tensor it is ``frn_tlu_reference``, the plain formula that
autograd differentiates.  For a CUDA tensor (float32 or float64) it is
``_FrnTlu``, a ``torch.autograd.Function`` over the hand-written kernels of
``csrc/frn_tlu.cu``: one forward kernel, and a backward kernel with a
kernel that sums the per-plane parameter gradients over the images.  It
composes with ``torch.func.grad``; under ``vmap`` it runs the batch's
entries one after another through the kernels.  First derivatives only:
double backward and forward-mode AD raise.  On a CPU tensor ``_FrnTlu``
runs ``_backward_reference``, the kernels' backward in plain PyTorch, so
that tests can hold its algebra against autograd's.

``frn_tlu.launches`` counts the kernels queued (1 forward, 2 backward);
while the recorder (``utils/profiling.py``) records, the counter
``frn_tlu.launches`` counts them too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling

_DTYPES = {torch.float32: 0, torch.float64: 1}


def frn_tlu_reference(x, gamma, beta, tau, eps: float):
    """Plain PyTorch version: the formula, differentiated by autograd."""
    nu2 = torch.mean(x * x, dim=(2, 3), keepdim=True)
    return torch.maximum(gamma * x * torch.rsqrt(nu2 + eps) + beta, tau)


def _backward_reference(dz, x, gamma, beta, tau, eps: float):
    """The kernels' backward in plain PyTorch: (dx, dgamma, dbeta, dtau).

    y is recomputed as ``frn_tlu_reference`` computes it; dy is dz where
    y > tau, half of it where y == tau (``torch.maximum``'s tie rule) and 0
    below, and tau takes the rest."""
    r = torch.rsqrt(torch.mean(x * x, dim=(2, 3), keepdim=True) + eps)
    y = gamma * x * r + beta
    dy = torch.where(y > tau, dz, torch.where(y == tau, 0.5 * dz, torch.zeros_like(dz)))
    sdyx = torch.sum(dy * x, dim=(2, 3), keepdim=True)
    s = gamma * r
    dx = s * dy - s * r * r * x * sdyx / (x.shape[2] * x.shape[3])
    dgamma = torch.sum(r * sdyx, dim=0, keepdim=True)
    dbeta = torch.sum(dy, dim=(0, 2, 3), keepdim=True)
    dtau = torch.sum(dz - dy, dim=(0, 2, 3), keepdim=True)
    return dx, dgamma.reshape(gamma.shape), dbeta.reshape(beta.shape), dtau.reshape(tau.shape)


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("frn_tlu")
    lib.frn_tlu_error_string.argtypes = [ctypes.c_int]
    lib.frn_tlu_error_string.restype = ctypes.c_char_p
    tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p]
    lib.frn_tlu_forward.argtypes = [ctypes.c_void_p] * 5 + tail
    lib.frn_tlu_forward.restype = ctypes.c_int
    lib.frn_tlu_backward.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.frn_tlu_backward.restype = ctypes.c_int
    return lib


def _checked(x, *params):
    """The kernels' operands: x contiguous NCHW, the parameters as (C,)
    vectors of x's dtype on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"the FRN kernels run on CUDA tensors, not {x.device}")
    if x.ndim != 4:
        raise ValueError(f"FRN takes an NCHW tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the FRN kernels take float32 or float64, got {x.dtype}")
    c = x.shape[1]
    out = []
    for p in params:
        if p.device != x.device or p.dtype != x.dtype or p.numel() != c:
            raise ValueError(f"an FRN parameter is {p.dtype} {tuple(p.shape)} on {p.device}; "
                             f"x is {x.dtype} with {c} channels on {x.device}")
        out.append(p.reshape(c).contiguous())
    return (x.contiguous(), *out)


def _aligned(t):
    """``t`` contiguous and 16-byte aligned: the kernels choose their path
    by x's alignment, the same forward and backward, and the register path
    loads 16 bytes at once."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launched(n: int):
    frn_tlu.launches += n
    profiling.count("frn_tlu.launches", n)


def _raise_on(err: int):
    if err != 0:
        msg = _library().frn_tlu_error_string(err).decode()
        raise RuntimeError(f"frn_tlu CUDA kernel failed: cudaError_t {err} ({msg})")


def _forward_cuda(x, gamma, beta, tau, eps: float):
    x, gamma, beta, tau = _checked(x, gamma, beta, tau)
    z = torch.empty_like(x)
    n, c, h, w = x.shape
    if z.numel() == 0:
        return z
    with torch.cuda.device(x.device):
        err = _library().frn_tlu_forward(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), tau.data_ptr(), z.data_ptr(), n, c,
            h * w, float(eps), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err)
    _launched(1)
    return z


def _backward_cuda(dz, x, gamma, beta, tau, eps: float):
    shapes = gamma.shape, beta.shape, tau.shape
    x, gamma, beta, tau = _checked(x, gamma, beta, tau)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device:
        raise ValueError(f"dz is {dz.dtype} {tuple(dz.shape)}, x {x.dtype} {tuple(x.shape)}")
    dz = _aligned(dz)
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    grads = torch.zeros((3, c), dtype=x.dtype, device=x.device)  # beta, gamma, tau
    if x.numel() > 0:
        part = torch.empty((n, c, 3), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            err = _library().frn_tlu_backward(
                dz.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), tau.data_ptr(),
                dx.data_ptr(), part.data_ptr(), grads.data_ptr(), n, c, h * w, float(eps),
                _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err)
        _launched(2)
    return (dx, grads[1].reshape(shapes[0]), grads[0].reshape(shapes[1]),
            grads[2].reshape(shapes[2]))


def _unbatched(info, in_dims, args):
    """The batch's entries, one argument tuple each, of a ``vmap`` rule's
    tensor arguments."""
    return [tuple(a if d is None else a.select(d, i) for a, d in zip(args, in_dims))
            for i in range(info.batch_size)]


_FORWARD_MODE = ("FRN with TLU (kernels/frn_tlu.py) has no forward-mode derivative: it gives "
                 "first derivatives in reverse mode only, so no jvp, jacfwd or Hessian")


class _FrnTlu(torch.autograd.Function):
    """z = FRN with TLU of x; the forward keeps x and the parameters only."""

    @staticmethod
    def forward(x, gamma, beta, tau, eps):
        if x.device.type == "cpu":
            return frn_tlu_reference(x, gamma, beta, tau, eps)
        return _forward_cuda(x, gamma, beta, tau, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, tau, eps = inputs
        ctx.eps = eps
        ctx.save_for_backward(x, gamma, beta, tau)

    @staticmethod
    def backward(ctx, dz):
        return (*_FrnTluBackward.apply(dz, *ctx.saved_tensors, ctx.eps), None)

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, tau, eps):
        outs = [_FrnTlu.apply(*args, eps)
                for args in _unbatched(info, in_dims[:4], (x, gamma, beta, tau))]
        return torch.stack(outs), 0

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_FORWARD_MODE)


class _FrnTluBackward(torch.autograd.Function):
    """(dx, dgamma, dbeta, dtau) of ``_FrnTlu`` at upstream gradient dz; a
    Function of its own so that ``vmap`` over a gradient can run it, and so
    that differentiating it again raises."""

    @staticmethod
    def forward(dz, x, gamma, beta, tau, eps):
        if x.device.type == "cpu":
            return _backward_reference(dz, x, gamma, beta, tau, eps)
        return _backward_cuda(dz, x, gamma, beta, tau, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("FRN with TLU (kernels/frn_tlu.py) has first derivatives only: its "
                           "backward cannot be differentiated again (double backward)")

    @staticmethod
    def vmap(info, in_dims, dz, x, gamma, beta, tau, eps):
        outs = [_FrnTluBackward.apply(*args, eps)
                for args in _unbatched(info, in_dims[:5], (dz, x, gamma, beta, tau))]
        return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0, 0)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_FORWARD_MODE)


def frn_tlu(x, gamma, beta, tau, eps: float):
    """FRN with TLU of the NCHW tensor ``x``: the plain formula on the CPU,
    the kernels (``_FrnTlu``) on CUDA."""
    if x.device.type == "cpu":
        return frn_tlu_reference(x, gamma, beta, tau, eps)
    return _FrnTlu.apply(x, gamma, beta, tau, eps)


frn_tlu.launches = 0
