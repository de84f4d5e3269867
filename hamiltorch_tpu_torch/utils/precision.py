"""Float32 products in full float32.

On an NVIDIA card PyTorch may run float32 convolutions (cuDNN, on by
default) and matrix products (cuBLAS, off by default) on the tensor cores
in TF32, which keeps 10 of float32's 23 mantissa bits.  Code whose result
is only right in float32 (an HMC potential, whose energies decide the
Metropolis test; a Hessian) holds both switches off while it computes:

    with full_float32():
        ...

The switches are restored when the block ends, on an exception too.  On
the CPU the switches change nothing but what they read.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """cuBLAS's and cuDNN's TF32 switches off inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
