from .compat import (
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
from .progress import ProgressBar
from .pytree import param_shapes, param_sizes, ravel_pytree_fn
from .rng import next_key, set_random_seed

__all__ = [
    "set_random_seed",
    "next_key",
    "ravel_pytree_fn",
    "param_sizes",
    "param_shapes",
    "flatten",
    "unflatten",
    "make_functional",
    "gradient",
    "hessian",
    "jacobian",
    "has_nan_or_inf",
    "LogProbError",
    "eval_print",
    "ProgressBar",
]
