"""``hamiltorch_tpu_torch.util``: the ``hamiltorch.util`` namespace.

Counterpart of ``hamiltorch_tpu/util.py``: the reference's notebooks call
``hamiltorch.util.flatten``, ``hamiltorch.util.setup_chain`` and so on
(reference: hamiltorch/util.py); this module re-exports the port's
equivalents so those call sites port unchanged.
"""

from .parallel.chains import multi_chain, setup_chain
from .utils.compat import (
    LogProbError,
    eval_print,
    flatten,
    gradient,
    has_nan_or_inf,
    hessian,
    jacobian,
    make_functional,
    unflatten,
)
from .utils.progress import ProgressBar
from .utils.pytree import ravel_pytree_fn
from .utils.rng import set_random_seed

__all__ = [
    "flatten",
    "unflatten",
    "make_functional",
    "gradient",
    "hessian",
    "jacobian",
    "has_nan_or_inf",
    "LogProbError",
    "eval_print",
    "set_random_seed",
    "setup_chain",
    "multi_chain",
    "ProgressBar",
    "ravel_pytree_fn",
]
