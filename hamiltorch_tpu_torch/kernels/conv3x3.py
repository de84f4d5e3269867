"""A 3x3 convolution of stride 1 and padding 1, as many channels out as in.

``conv3x3(x, weight, bias)`` is ``F.conv2d(x, weight, bias, padding=1)`` for
an NCHW tensor ``x`` of C channels, a (C, C, 3, 3) ``weight`` and a (C,)
``bias``: ResNet-20-FRN's same-width convolutions (``models/resnet_frn.py``).

For a CPU tensor it is ``conv3x3_reference``, which autograd
differentiates.  For a CUDA tensor (float32 or float64) it is ``_Conv3x3``,
a ``torch.autograd.Function`` over the hand-written kernels of
``csrc/conv3x3.cu``: a forward kernel that adds the bias as it stores; an
input-gradient kernel, the same convolution of the upstream gradient with
the weight turned 180 degrees and its channel axes swapped (read at that
index); and a weight-and-bias-gradient kernel that writes a partial sum a
block, with a kernel that sums the partials in a fixed order (the same
inputs give the same bits).  Float32 at (C, H = W) = (16, 32), (32, 16) and
(64, 8) runs on the tensor cores in 3xTF32 with float32 sums; any other
shape, or float64, takes the kernels' generic variant (fused multiply-adds
in the tensor's type).  Other dtypes, and weights of other shapes, raise.
The input gradient is skipped where ``x`` needs none.  It composes with
``torch.func.grad``; under ``vmap`` it runs the batch's entries one after
another.  First derivatives only: double backward and forward-mode AD
raise.  On a CPU tensor ``_Conv3x3`` runs ``_backward_reference``, the
kernels' backward algebra in plain PyTorch, so that tests can hold it
against autograd's.

``conv3x3.launches`` counts the kernels queued (1 forward; 3 backward, 2
without the input gradient); while the recorder (``utils/profiling.py``)
records, the counter ``conv3x3.launches`` counts them too.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import profiling
from .frn_tlu import _unbatched

_DTYPES = {torch.float32: 0, torch.float64: 1}


def conv3x3_reference(x, weight, bias):
    """Plain PyTorch version: ``F.conv2d`` at stride 1 and padding 1."""
    return F.conv2d(x, weight, bias, padding=1)


def _backward_reference(dy, x, weight, need_dx: bool = True):
    """The kernels' backward in plain PyTorch: (dx or None, dweight, dbias).

    dx is the convolution of dy with the weight turned 180 degrees and its
    channel axes swapped; dweight[o, i, ky, kx] sums dy[n, o, y, x] times
    x[n, i, y + ky - 1, x + kx - 1] (zero outside the image) over n, y and
    x; dbias sums dy over n, y and x."""
    c, s = x.shape[1], x.shape[2]
    dx = F.conv2d(dy, weight.flip(2, 3).transpose(0, 1), padding=1) if need_dx else None
    shifted = F.pad(x, (1, 1, 1, 1)).unfold(2, s, 1).unfold(3, s, 1)  # (N, C, 3, 3, S, S)
    dw = torch.einsum("nohw,nikjhw->oikj", dy, shifted).reshape(c, c, 3, 3)
    return dx, dw, dy.sum(dim=(0, 2, 3))


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("conv3x3")
    lib.conv3x3_error_string.argtypes = [ctypes.c_int]
    lib.conv3x3_error_string.restype = ctypes.c_char_p
    shape = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.conv3x3_forward.argtypes = [ctypes.c_void_p] * 4 + shape
    lib.conv3x3_dgrad.argtypes = [ctypes.c_void_p] * 3 + shape
    lib.conv3x3_wgrad.argtypes = [ctypes.c_void_p] * 5 + shape
    lib.conv3x3_wgrad_scratch.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.conv3x3_wgrad_scratch.restype = ctypes.c_longlong
    for fn in (lib.conv3x3_forward, lib.conv3x3_dgrad, lib.conv3x3_wgrad):
        fn.restype = ctypes.c_int
    return lib


def _checked(x):
    """x as the kernels take it: an NCHW tensor of square planes on a CUDA
    device, float32 or float64, contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"the conv3x3 kernels run on CUDA tensors, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the conv3x3 kernels take float32 or float64, got {x.dtype}")
    if x.ndim != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes an NCHW tensor of square planes, got {tuple(x.shape)}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _like(t, x, shape, name):
    """t, of the given shape and of x's dtype and device, contiguous."""
    if t.shape != shape or t.dtype != x.dtype or t.device != x.device:
        raise ValueError(f"conv3x3 takes a {tuple(shape)} {name} of {x.dtype} on {x.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _launched(n: int):
    conv3x3.launches += n
    profiling.count("conv3x3.launches", n)


def _raise_on(err: int):
    if err != 0:
        msg = _library().conv3x3_error_string(err).decode()
        raise RuntimeError(f"conv3x3 CUDA kernel failed: cudaError_t {err} ({msg})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_cuda(x, weight, bias):
    x = _checked(x)
    c = x.shape[1]
    weight, bias = _like(weight, x, (c, c, 3, 3), "weight"), _like(bias, x, (c,), "bias")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().conv3x3_forward(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                         out.data_ptr(), x.shape[0], c, x.shape[2],
                                         _DTYPES[x.dtype], _stream(x))
    _raise_on(err)
    _launched(1)
    return out


def _dgrad_cuda(dy, weight):
    dy = _checked(dy)
    weight = _like(weight, dy, (dy.shape[1], dy.shape[1], 3, 3), "weight")
    dx = torch.empty_like(dy)
    if dy.numel() == 0:
        return dx
    with torch.cuda.device(dy.device):
        err = _library().conv3x3_dgrad(dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
                                       dy.shape[0], dy.shape[1], dy.shape[2],
                                       _DTYPES[dy.dtype], _stream(dy))
    _raise_on(err)
    _launched(1)
    return dx


def _wgrad_cuda(dy, x):
    """(dweight, dbias) at input x and upstream gradient dy."""
    x = _checked(x)
    dy = _checked(_like(dy, x, x.shape, "upstream gradient"))
    n, c, s, _ = x.shape
    if x.numel() == 0:
        return x.new_zeros((c, c, 3, 3)), x.new_zeros((c,))
    dw, db = x.new_empty((c, c, 3, 3)), x.new_empty((c,))
    lib = _library()
    part = torch.empty((lib.conv3x3_wgrad_scratch(n, c),), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_wgrad(dy.data_ptr(), x.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), n, c, s, _DTYPES[x.dtype], _stream(x))
    _raise_on(err)
    _launched(2)
    return dw, db


_FORWARD_MODE = ("conv3x3 (kernels/conv3x3.py) has no forward-mode derivative: it gives first "
                 "derivatives in reverse mode only, so no jvp, jacfwd or Hessian")


class _Conv3x3(torch.autograd.Function):
    """out = conv3x3 of x; the forward keeps x and the weight."""

    @staticmethod
    def forward(x, weight, bias):
        if x.device.type == "cpu":
            return conv3x3_reference(x, weight, bias)
        return _forward_cuda(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _ = inputs
        ctx.save_for_backward(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = _Conv3x3Backward.apply(dy, x, weight, ctx.needs_input_grad[0])
        return dx, dw, db

    @staticmethod
    def vmap(info, in_dims, x, weight, bias):
        outs = [_Conv3x3.apply(*args) for args in _unbatched(info, in_dims, (x, weight, bias))]
        return torch.stack(outs), 0

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_FORWARD_MODE)


class _Conv3x3Backward(torch.autograd.Function):
    """(dx, dweight, dbias) of ``_Conv3x3`` at upstream gradient dy, dx None
    unless ``need_dx``; a Function of its own so that ``vmap`` over a
    gradient can run it, and so that differentiating it again raises."""

    @staticmethod
    def forward(dy, x, weight, need_dx):
        if x.device.type == "cpu":
            return _backward_reference(dy, x, weight, need_dx)
        return (_dgrad_cuda(dy, weight) if need_dx else None, *_wgrad_cuda(dy, x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("conv3x3 (kernels/conv3x3.py) has first derivatives only: its "
                           "backward cannot be differentiated again (double backward)")

    @staticmethod
    def vmap(info, in_dims, dy, x, weight, need_dx):
        outs = [_Conv3x3Backward.apply(*args, need_dx)
                for args in _unbatched(info, in_dims[:3], (dy, x, weight))]
        dxs, dws, dbs = zip(*outs)
        return ((torch.stack(dxs) if need_dx else None), torch.stack(dws), torch.stack(dbs)), \
            (0 if need_dx else None, 0, 0)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_FORWARD_MODE)


def conv3x3(x, weight, bias):
    """``F.conv2d(x, weight, bias, padding=1)`` for a (C, C, 3, 3) weight:
    the plain version on the CPU, the kernels (``_Conv3x3``) on CUDA.  Both
    take float32 or float64 NCHW tensors of square planes, a (C, C, 3, 3)
    weight and a (C,) bias, and raise on anything else."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 takes float32 or float64, got {x.dtype}")
    if x.ndim != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes an NCHW tensor of square planes, got {tuple(x.shape)}")
    c = x.shape[1]
    _like(weight, x, (c, c, 3, 3), "weight")
    _like(bias, x, (c,), "bias")
    if x.device.type == "cpu":
        return conv3x3_reference(x, weight, bias)
    return _Conv3x3.apply(x, weight, bias)


conv3x3.launches = 0
