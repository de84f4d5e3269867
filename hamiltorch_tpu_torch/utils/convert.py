"""Hand the JAX package's parameters and data to the port.

The JAX package keeps the flagship's flat parameters in the layout w1
(row-major, in x hidden), b1, w2, b2, and its tree parameters as
``{w1, b1, w2, b2}``.  The port uses the same layouts, so conversion is a
copy into tensors on the chosen device; both packages then compute the
same thing on the same numbers.  The arrays may be numpy arrays or anything
``numpy.asarray`` accepts (JAX arrays included), so this module imports no
JAX.

Entry points that make tensors (this module's, the flagship factories) put
them on the card unless the caller names another device: ``device=None``
means ``torch.device("cuda")``, and without a card they raise rather than
fall back to the CPU.  The samplers' entry points place a start that is not
a tensor the same way (``place_start``); a tensor start keeps its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .pytree import is_param_tree, tree_map


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None (raises without one)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def place_start(theta):
    """A sampler's start as tensors.  A tensor keeps its device: that is the
    caller's request.  Anything else (a numpy array, a list, a scalar) is no
    request for a device and goes to the card (``resolve_device(None)``;
    raises without one).  A parameter tree converts leaf by leaf."""
    if is_param_tree(theta):
        return tree_map(place_start, theta)
    if isinstance(theta, torch.Tensor):
        return theta
    return torch.as_tensor(theta, device=resolve_device(None))


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a, copy=True), device=device).to(dtype)


def from_jax_params(theta, x=None, y=None, device=None, dtype=torch.float32):
    """``(theta, x, y)`` as tensors on ``device`` (the card when None).

    ``theta`` is a flat (D,) array or a parameter tree of arrays (dicts,
    lists and tuples convert leafwise); ``x`` (N, I) and ``y`` (N, 1) are
    optional and come back as None when not given.
    """
    device = resolve_device(device)
    if is_param_tree(theta):
        theta_t = tree_map(lambda a: _tensor(a, device, dtype), theta)
    else:
        theta_t = _tensor(theta, device, dtype)
    x_t = None if x is None else _tensor(x, device, dtype)
    y_t = None if y is None else _tensor(y, device, dtype).reshape(-1, 1)
    return theta_t, x_t, y_t
