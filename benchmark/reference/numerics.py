"""The precisions the plain references run in.

``float64``: every tensor float64; this is the reference that decides
``correct``.  ``tf32``: every tensor float32 and the operands of every
matrix product rounded to TF32 (10 explicit mantissa bits, to nearest)
before a float32 product, which is what a product on the tensor cores in
TF32 computes; this is the control, the step below the float32 that the
configurations state, and it has to come out not correct.  The rounding is
done here, not by ``torch.backends.cuda.matmul.allow_tf32``, so that the
control computes the same on the card and on the CPU; that flag is held
off while a reference runs.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "tf32")


def dtype(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {prec!r}")
    return torch.float64 if prec == "float64" else torch.float32


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32, to nearest with ties away from zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return torch.matmul(to_tf32(a), to_tf32(b))
    return torch.matmul(a, b)


@contextlib.contextmanager
def exact_products():
    """Hold PyTorch's own TF32 switches off (a reference sets its precision itself)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
