"""Hand the JAX package's parameters and data to the port.

The JAX package keeps the flagship's flat parameters in the layout w1
(row-major, in x hidden), b1, w2, b2, and its tree parameters as
``{w1, b1, w2, b2}``.  The port uses the same layouts, so conversion is a
copy into tensors on the chosen device; both packages then compute the
same thing on the same numbers.  The arrays may be numpy arrays or anything
``numpy.asarray`` accepts (JAX arrays included), so this module imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a, copy=True), device=device).to(dtype)


def from_jax_params(theta, x=None, y=None, device="cpu", dtype=torch.float32):
    """``(theta, x, y)`` as tensors on ``device``.

    ``theta`` is a flat (D,) array or a dict of arrays (a nested dict
    converts leafwise); ``x`` (N, I) and ``y`` (N, 1) are optional and come
    back as None when not given.
    """
    if isinstance(theta, dict):
        theta_t = {k: from_jax_params(v, device=device, dtype=dtype)[0] for k, v in theta.items()}
    else:
        theta_t = _tensor(theta, device, dtype)
    x_t = None if x is None else _tensor(x, device, dtype)
    y_t = None if y is None else _tensor(y, device, dtype).reshape(-1, 1)
    return theta_t, x_t, y_t
