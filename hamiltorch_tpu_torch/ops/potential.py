"""Log-probability ("potential") plumbing.

Counterpart of ``hamiltorch_tpu/ops/potential.py``.  Gradients come from
``torch.func.grad_and_value``, which composes with ``torch.func.vmap`` over
chains.  A user-supplied gradient (``pass_grad``) is attached with a
``torch.autograd.Function``, the counterpart of the JAX package's
``custom_vjp``, so the same ``value_and_grad`` call picks it up.

Divergences are data: a non-finite log-probability flows through as NaN or
inf and the driver's Metropolis mask rejects it.

The JAX module's identity caches and its ``_raw_fn``/``_data`` operand
protocol exist because ``jit`` takes the potential as a static argument;
eager PyTorch has neither problem, so neither is ported.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..utils.pytree import unravel_last_axis_fn

LogProbFn = Callable[[torch.Tensor], torch.Tensor]


def make_log_prob(log_prob_fn: LogProbFn, pass_grad=None) -> LogProbFn:
    """Wrap ``log_prob_fn`` so autodiff uses ``pass_grad`` when given.

    ``pass_grad`` is a callable ``theta -> gradient`` or a constant gradient
    tensor, the reference's ``pass_grad`` contract.  Returns a scalar-valued
    function whose ``torch.func.grad`` is the user gradient.
    """
    if pass_grad is None:
        return log_prob_fn

    if callable(pass_grad):
        grad_fn = pass_grad
    else:
        const_grad = torch.as_tensor(pass_grad)

        def grad_fn(theta):
            return const_grad.to(device=theta.device, dtype=theta.dtype)

    class _PassGrad(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(theta):
            return log_prob_fn(theta)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0])

        @staticmethod
        def backward(ctx, g):
            (theta,) = ctx.saved_tensors
            return g * grad_fn(theta)

    return _PassGrad.apply


def value_and_grad(log_prob_fn: LogProbFn) -> Callable[
    [torch.Tensor], Tuple[torch.Tensor, torch.Tensor]
]:
    """(theta) -> (logp, dlogp/dtheta), one forward and one backward.

    ``theta`` may be a tensor or a parameter tree (dict of tensors); the
    gradient has the same structure.
    """
    gv = torch.func.grad_and_value(log_prob_fn)

    def vg(theta):
        grad, logp = gv(theta)
        return logp, grad

    return vg


def make_flat_potential(log_prob_fn, template) -> LogProbFn:
    """Flat-theta wrapper of a tree potential.

    ``template`` is the (unstacked) parameter tree; the wrapper unravels its
    flat (D,) argument back to the tree (``utils.pytree`` leaf order) before
    calling ``log_prob_fn``.  Eager PyTorch needs no identity-stable cache
    of these wrappers, so unlike the JAX package's this builds a new one on
    every call.
    """
    unravel = unravel_last_axis_fn(template)

    def lp_flat(theta):
        return log_prob_fn(unravel(theta))

    return lp_flat


def resolve_potential(log_prob_fn: LogProbFn, pass_grad=None) -> LogProbFn:
    """The sampler entry's potential: ``log_prob_fn`` with ``pass_grad``.

    The JAX counterpart also unpacks the ``_raw_fn``/``_data`` operand
    protocol and returns ``(fn, data)``; with no operand protocol to honour
    this returns the function alone.
    """
    if not callable(log_prob_fn):
        raise TypeError(f"log_prob_fn must be callable, got {type(log_prob_fn)}")
    return make_log_prob(log_prob_fn, pass_grad)
