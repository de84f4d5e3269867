"""The reference's ``hamiltorch.util`` helpers.

Counterpart of ``hamiltorch_tpu/utils/compat.py`` (reference:
hamiltorch/util.py), on ``torch.func``:

* ``flatten`` / ``unflatten`` (util.py:121-136): parameters <-> one flat
  vector, for a ``torch.nn.Module`` (``torch.cat`` of ``p.reshape(-1)``
  over ``model.parameters()``, as upstream) or a parameter tree;
* ``gradient`` / ``hessian`` / ``jacobian`` (util.py:145-234):
  ``torch.func.grad`` / ``hessian`` / ``jacrev`` at a flat vector;
* ``has_nan_or_inf`` / ``LogProbError`` (util.py:92-104), kept for user
  code that catches it; the samplers never raise it (divergences are data);
* ``make_functional`` (util.py:253-359): a module as a pure
  ``fmodel(x, params)`` over ``torch.func.functional_call``;
* ``eval_print`` (util.py:236-247): a debug printer.
"""

from __future__ import annotations

import inspect
import sys

import torch

from .pytree import ravel_pytree_fn


class LogProbError(Exception):
    """Kept for user code; the samplers signal divergences as data
    (``stats.divergent``) instead of raising."""


def has_nan_or_inf(value) -> bool:
    value = torch.as_tensor(value)
    return bool(torch.isnan(value).any() | torch.isinf(value).any())


def _params_of(model):
    if isinstance(model, torch.nn.Module):
        return [p.detach() for p in model.parameters()]
    return model  # a parameter tree


def flatten(model) -> torch.Tensor:
    """Parameters of ``model`` (a module or a parameter tree) as one flat vector."""
    flat, _ = ravel_pytree_fn(_params_of(model))
    return flat


def unflatten(model, flattened_params):
    """Flat vector -> list (or tree) of parameter tensors shaped like ``model``'s."""
    flattened_params = torch.as_tensor(flattened_params)
    if flattened_params.ndim != 1:
        raise ValueError("Expecting a 1d flattened_params")
    _, unravel = ravel_pytree_fn(_params_of(model))
    return unravel(flattened_params)


def make_functional(model):
    """A module as ``fmodel(x, params)`` with ``params`` a list in
    ``model.parameters()`` order (the reference's calling convention), on
    the module's own device; as ``models.bnn.build_model``, it runs a copy in
    ``eval()`` mode with BatchNorm on batch statistics.  Anything else is
    returned as it is."""
    if isinstance(model, torch.nn.Module):
        from ..models.bnn import build_model

        first = next(model.parameters(), None)
        device = first.device if first is not None else torch.device("cpu")
        apply_fn, _ = build_model(model, device=device)

        def fmodel(x, params):
            return apply_fn(params, x)

        return fmodel
    return model


def gradient(output_fn, inputs):
    """Gradient of a scalar function at ``inputs`` (a flat vector)."""
    return torch.func.grad(output_fn)(torch.as_tensor(inputs))


def hessian(output_fn, inputs):
    return torch.func.hessian(output_fn)(torch.as_tensor(inputs))


def jacobian(output_fn, inputs):
    return torch.func.jacrev(output_fn)(torch.as_tensor(inputs))


def eval_print(*expressions):
    """Evaluate expression strings in the caller's frame and print them
    (reference: hamiltorch/util.py:236-247)."""
    frame = sys._getframe(1)
    print("\n" + inspect.stack()[1][3])
    width = max((len(e) for e in expressions), default=0)
    for expression in expressions:
        val = eval(expression, frame.f_globals, frame.f_locals)
        print(f"  {expression.ljust(width)} = {val!r}")
