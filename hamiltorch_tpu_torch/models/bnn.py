"""Bayesian-neural-network layer: ``torch.nn.Module`` -> flat-vector log-probability.

Counterpart of ``hamiltorch_tpu/models/bnn.py`` (the reference's
``define_model_log_prob``, ``define_split_model_log_prob``,
``sample_model``, ``sample_split_model``, ``predict_model``; reference:
hamiltorch/samplers.py:1093-1562).  The JAX package translates a torch
module into jnp operations (``models/interop.py``); here the module runs
itself, through ``torch.func.functional_call``, as upstream hamiltorch's
``make_functional`` did.  The layer is then: ravel/unravel between the
sampler's flat (D,) vector and the module's parameters, per-leaf Gaussian
priors from ``tau_list``, and the likelihood zoo (reference:
samplers.py:1170-1190).

Models come in two forms:

* a ``torch.nn.Module``: its parameters are a list in
  ``module.parameters()`` order, each tensor row-major in its own layout
  (``nn.Linear``'s weight is (out, in)), so the flat vector is
  ``torch.cat`` of ``p.reshape(-1)``, the reference's and the JAX bridge's
  layout;
* a plain callable ``apply_fn(params, x)`` with a ``params_template``.

A module runs as a deep copy in ``eval()`` mode (dropout is the identity;
recurrent layers run in training mode with their dropout at 0, the same
function, so that cuDNN's fused RNN gives a backward pass) whose BatchNorm
layers always normalise with the batch's moments and never
update running statistics (``torch.func.replace_all_batch_norm_modules_``
on the copy), the reference's batch-norm patch (hamiltorch/util.py:370-376)
and the JAX bridge's rule; the caller's module is never changed.

Every entry point that makes or moves tensors takes ``device``: the CUDA
card when it is None (raising without one), another device only when the
caller names it.  ``predict_model`` evaluates every sample at once with
``torch.func.vmap``; streamed results come back as CPU tensors.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from ..api import _kept_samples
from ..api import sample as _sample
from ..enums import Integrator, Metric, Sampler
from ..samplers.driver import MCMCConfig
from ..samplers.splitting import run_split_hmc_stacked
from ..utils import profiling
from ..utils.convert import resolve_device
from ..utils.precision import full_float32
from ..utils.pytree import (
    is_param_tree,
    ravel_pytree_fn,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)
from ..utils.rng import next_key

# ---------------------------------------------------------------------------
# model normalisation


def _private_copy(module: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of ``module`` on ``device`` that computes what the module
    computes in ``eval()`` mode: every submodule in eval mode but the
    recurrent ones (``nn.RNNBase``: RNN, LSTM, GRU), which are in training
    mode with their dropout at 0, the same function, since cuDNN's fused
    RNN gives no backward pass for a forward taken in eval mode; BatchNorm
    on batch statistics."""
    module = copy.deepcopy(module).to(device).eval()
    for sub in module.modules():
        if isinstance(sub, torch.nn.RNNBase):
            sub.train()
            sub.dropout = 0.0
    torch.func.replace_all_batch_norm_modules_(module)
    return module


def _module_apply(module: torch.nn.Module, device):
    """(apply_fn(params, x), template) of a module: its private copy
    (``_private_copy``) called through ``functional_call`` with its buffers
    passed through."""
    module = _private_copy(module, device)
    names = [name for name, _ in module.named_parameters()]
    buffers = dict(module.named_buffers())
    template = [p.detach().clone() for p in module.parameters()]

    def apply_fn(params, x):
        return torch.func.functional_call(module, ({**dict(zip(names, params)), **buffers}), (x,))

    return apply_fn, template


def build_model(model, x_example=None, params_template=None, rng=None,
                bridge_method="auto", device=None):
    """Normalise ``model`` to ``(apply_fn(params, x), params_template)``.

    * ``torch.nn.Module``: run through ``functional_call`` on a copy on
      ``device`` (the card when None); the template lists its parameters;
    * callable: used as it is, ``params_template`` required (moved to
      ``device``).

    ``x_example``, ``rng`` and ``bridge_method`` are accepted for the JAX
    package's signature and unused: there is no module to initialise and
    no bridge to choose.
    """
    device = resolve_device(device)
    if isinstance(model, torch.nn.Module):
        return _module_apply(model, device)
    if callable(model):
        if params_template is None:
            raise ValueError("params_template required when model is a plain callable")
        return model, tree_map(lambda t: torch.as_tensor(t, device=device), params_template)
    raise TypeError(f"Unsupported model type: {type(model)}")


def _remat(apply_fn):
    """``apply_fn`` that keeps no activations for the backward pass and
    recomputes them there.  ``torch.utils.checkpoint`` cannot serve: its
    saved-tensor hooks are refused under ``torch.func.grad``, which the
    samplers differentiate with."""

    class _Remat(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(fn, x, *leaves):
            return fn(x, *leaves)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.fn = inputs[0]
            ctx.save_for_backward(*inputs[1:])

        @staticmethod
        def backward(ctx, g):
            _, pull = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            return (None,) + tuple(pull(g))

    def remat_fn(params, x):
        def fn(xx, *leaves):
            return apply_fn(tree_unflatten_like(params, leaves), xx)

        return _Remat.apply(fn, x, *tree_leaves(params))

    return remat_fn


class _HoldEdge(torch.autograd.Function):
    """Identity on tensors whose backward starts the float32 hold ``held``
    (on the module's output) or ends it (on the parameters).  The module's
    backward runs after the potential has returned, between the two."""

    generate_vmap_rule = True

    @staticmethod
    def forward(held, start, *ts):
        return tuple(t.clone() for t in ts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.held, ctx.start = inputs[:2]

    @staticmethod
    def backward(ctx, *grads):
        if ctx.start:
            ctx.held.append(full_float32())
            ctx.held[-1].__enter__()
        elif ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return (None, None) + grads

    @staticmethod
    def jvp(ctx, held_t, start_t, *tangents):
        return tuple(t.clone() for t in tangents)


class _BlockedLikelihood(torch.autograd.Function):
    """The likelihood summed over blocks of ``rows`` rows of the data.

    The forward runs each block's forward and backward with plain
    autograd, so that one block's activations are live at a time and the
    backward keeps none of its own (``torch.func.grad`` would keep them, to
    differentiate again), and keeps the summed gradient; the backward
    scales it.  Under ``vmap`` the chains are evaluated one after another.
    Outputs: the value, then the gradient of every leaf (not
    differentiable).  First derivatives only: forward-mode AD (a Hessian)
    is refused."""

    @staticmethod
    def forward(block_fn, x, y, rows, *leaves):
        value, grads = 0.0, None
        with profiling.annotate("potential"), full_float32(), torch.enable_grad():
            leaves = tuple(leaf.detach().requires_grad_(True) for leaf in leaves)
            for start in range(0, x.shape[0], rows):
                with profiling.annotate("potential.block"):
                    v = block_fn(leaves, x[start:start + rows], y[start:start + rows])
                    g = torch.autograd.grad(v, leaves)
                    value = value + v.detach()
                    grads = g if grads is None else tuple(a + b for a, b in zip(grads, g))
                profiling.count("potential.blocks")
                profiling.count("potential.rows", min(rows, x.shape[0] - start))
        return (value,) + grads

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        return (None, None, None, None) + tuple(g * t for t in ctx.saved_tensors)

    @staticmethod
    def vmap(info, in_dims, block_fn, x, y, rows, *leaves):
        if in_dims[1] is not None or in_dims[2] is not None:
            raise NotImplementedError("the blocked likelihood takes one data set for all chains")
        outs = [_BlockedLikelihood.apply(block_fn, x, y, rows, *(
            leaf if dim is None else leaf.select(dim, i) for leaf, dim in zip(leaves, in_dims[4:])))
            for i in range(info.batch_size)]
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])


# ---------------------------------------------------------------------------
# priors and likelihoods


def _normal_log_prob(w: torch.Tensor, tau) -> torch.Tensor:
    """Sum of N(0, tau^-1) log-pdfs, constants included (the reference
    keeps them through torch.distributions.Normal, samplers.py:1141-1156).
    A number ``tau`` stays a host scalar: a tensor made of it on the card
    would be a blocking copy, which stalls the host until the card has run
    everything queued before it."""
    n = w.numel()
    if isinstance(tau, torch.Tensor):
        tau = tau.to(dtype=w.dtype, device=w.device)
        log_tau = torch.log(tau)
    else:
        tau = float(tau)
        log_tau = math.log(tau)
    return 0.5 * n * log_tau - 0.5 * n * math.log(2 * math.pi) - 0.5 * tau * torch.sum(w * w)


def _resolve_taus(num_leaves: int, tau_list) -> list:
    """One prior precision per parameter leaf: ``tau_list`` may be None
    (tau=1 everywhere), a scalar, or one entry per leaf in leaf order."""
    if tau_list is None:
        return [1.0] * num_leaves
    if isinstance(tau_list, (int, float)) or getattr(tau_list, "ndim", 1) == 0:
        return [tau_list] * num_leaves
    taus = list(tau_list)
    if len(taus) != num_leaves:
        raise ValueError(
            f"tau_list has {len(taus)} entries but the model has {num_leaves} parameter leaves"
        )
    return taus


def gaussian_prior_log_prob(params, tau_list) -> torch.Tensor:
    """Per-leaf Gaussian prior; ``tau_list`` is one precision per leaf (in
    leaf order) or a scalar applied to every leaf."""
    leaves = tree_leaves(params)
    taus = _resolve_taus(len(leaves), tau_list)
    lp = torch.zeros((), dtype=leaves[0].dtype if leaves else torch.float32,
                     device=leaves[0].device if leaves else None)
    for w, tau in zip(leaves, taus):
        lp = lp + _normal_log_prob(w, tau)
    return lp


def log_likelihood(output, y, model_loss, tau_out=1.0):
    """The reference's likelihood switch (samplers.py:1170-1190).  Class
    labels may come as floats, as in the reference's tests."""
    if model_loss == "binary_class_linear_output":
        # BCE with logits, summed, in the stable softplus form
        z, t = output, y
        bce = torch.sum(torch.clamp_min(z, 0.0) - z * t + torch.log1p(torch.exp(-torch.abs(z))))
        return -tau_out * bce
    if model_loss == "multi_class_linear_output":
        logits = torch.log_softmax(output, dim=-1)
        labels = y.reshape(-1).to(torch.int64)
        return -tau_out * (-torch.sum(torch.gather(logits, -1, labels[:, None])))
    if model_loss == "multi_class_log_softmax_output":
        # the reference's F.nll_loss keeps its default reduction='mean'
        # (samplers.py:1180), unlike its summed CrossEntropyLoss branch
        labels = y.reshape(-1).to(torch.int64)
        return -tau_out * (-torch.mean(torch.gather(output, -1, labels[:, None])))
    if model_loss == "regression":
        return -0.5 * tau_out * torch.sum((output - y) ** 2)
    if callable(model_loss):
        return -torch.sum(model_loss(output, y))
    raise NotImplementedError(f"Unknown model_loss: {model_loss!r}")


# ---------------------------------------------------------------------------
# log-prob factories


def _as_data(a, device, dtype):
    """``a`` as a tensor on ``device``; floating data in the model's dtype,
    integer data (labels, indices) as they are."""
    if a is None:
        return None
    a = torch.as_tensor(a, device=device)
    return a.to(dtype) if a.is_floating_point() else a


def _potential(model, model_loss, tau_list, tau_out, predict, prior_scale, params_template,
               remat, device, flat, block_rows=None):
    """(raw_fn(theta, data), template, device): the potential at ``theta``
    (flat or a tree) on ``data = (x, y)``, or the prior alone for None.

    It computes under ``full_float32()``, its backward too.  With
    ``block_rows`` the likelihood is a sum over blocks of that many rows
    (``_BlockedLikelihood``)."""
    device = resolve_device(device)
    apply_fn, template = build_model(model, params_template=params_template, device=device)
    if remat:
        apply_fn = _remat(apply_fn)
    if block_rows is not None and (predict or int(block_rows) < 1):
        raise ValueError("block_rows takes a positive number of rows and no predict=True: "
                         "the blocked potential returns the log-probability only")
    unravel = ravel_pytree_fn(template)[1] if flat else None

    def params_of(theta, leaves):
        return unravel(leaves[0]) if flat else tree_unflatten_like(theta, leaves)

    def raw_fn(theta, data):
        leaves = (theta,) if flat else tuple(tree_leaves(theta))
        if data is None:
            return gaussian_prior_log_prob(params_of(theta, leaves), tau_list) / prior_scale
        x_, y_ = data
        if block_rows is not None:
            def block_ll(ls, xb, yb):
                return log_likelihood(apply_fn(params_of(theta, ls), xb), yb, model_loss,
                                      tau_out)

            ll = _BlockedLikelihood.apply(block_ll, x_, y_, int(block_rows), *leaves)[0]
            return ll + gaussian_prior_log_prob(params_of(theta, leaves), tau_list) / prior_scale
        held = []
        with full_float32():
            leaves = _HoldEdge.apply(held, False, *leaves)
            params = params_of(theta, leaves)
            l_prior = gaussian_prior_log_prob(params, tau_list) / prior_scale
            (output,) = _HoldEdge.apply(held, True, apply_fn(params, x_))
            ll = log_likelihood(output, y_, model_loss, tau_out)
        if predict:
            return ll + l_prior, output
        return ll + l_prior

    return raw_fn, template, device


def _bind(raw_fn, x, y, device, dtype):
    data = None if x is None else (_as_data(x, device, dtype), _as_data(y, device, dtype))

    def log_prob_func(theta):
        return raw_fn(theta, data)

    return log_prob_func


def define_model_log_prob(
    model,
    model_loss,
    x,
    y,
    tau_list=None,
    tau_out: float = 1.0,
    predict: bool = False,
    prior_scale: float = 1.0,
    x_example=None,
    params_template=None,
    remat: bool = False,
    bridge_method: str = "auto",
    device=None,
    block_rows: Optional[int] = None,
):
    """Build ``log_prob_func(flat_theta)`` for a model and a dataset
    (reference: samplers.py:1093-1201).  Returns
    ``(log_prob_func, flat_init, unravel)``; ``flat_init`` is the model's
    parameters as one flat vector on ``device``.

    ``predict=True`` makes the function return ``(logp, output)``.
    ``remat=True`` recomputes the forward's activations in the backward pass
    instead of keeping them, trading operations for memory.
    ``block_rows=n`` makes the likelihood a sum over blocks of n rows (the
    last one shorter where n does not divide N): each evaluation runs every
    block's forward and backward in turn, so only one block's activations
    are live, whatever N is.  It gives values and first derivatives (under
    ``torch.func.grad`` and ``vmap``, as the samplers take them), not
    Hessians, and no ``predict=True``; under ``vmap`` the chains are
    evaluated in turn.  The recorder holds a span ``potential`` a chain's
    evaluation, a child ``potential.block`` a block and the counters
    ``potential.blocks`` and ``potential.rows``.

    The potential computes with cuDNN's and cuBLAS's TF32 switches off
    (``utils.precision.full_float32``), its backward pass too: float32 data
    are computed in float32.

    A module with a recurrent layer (``nn.RNN``, ``nn.LSTM``, ``nn.GRU``)
    takes ``block_rows`` on a CUDA device: there it runs cuDNN's fused RNN,
    which ``torch.func`` cannot differentiate, and the blocked potential
    takes its gradient with plain autograd (``block_rows=len(x)`` is one
    block of every row).

    The JAX package's function carries ``_raw_fn`` / ``_data`` attributes
    so that its jitted samplers take the data as an operand; eager PyTorch
    needs no such protocol and the port's samplers read none.
    """
    if (block_rows is None and not predict and isinstance(model, torch.nn.Module)
            and resolve_device(device).type == "cuda"
            and any(isinstance(m, torch.nn.RNNBase) for m in model.modules())):
        raise ValueError("a module with a recurrent layer takes block_rows on a CUDA device: "
                         "torch.func cannot differentiate cuDNN's fused RNN, and the blocked "
                         "potential differentiates it with autograd (block_rows=len(x) is one "
                         "block of every row)")
    raw_fn, template, device = _potential(model, model_loss, tau_list, tau_out, predict,
                                          prior_scale, params_template, remat, device, True,
                                          block_rows)
    flat_init, unravel = ravel_pytree_fn(template)
    return _bind(raw_fn, x, y, device, flat_init.dtype), flat_init, unravel


def define_model_prior_and_lik(
    model,
    model_loss,
    x,
    y,
    tau_list=None,
    tau_out: float = 1.0,
    x_example=None,
    params_template=None,
    bridge_method: str = "auto",
    device=None,
):
    """``(log_prior_fn, log_lik_fn, prior_sample_fn, template)``: the
    prior / likelihood split that evidence estimators need.

    The likelihood is the normalised per-observation density summed
    (``model_comparison.pointwise_log_lik_from_predictions``): the
    sampling-time forms may drop theta-constants, which cancel inside one
    model's MCMC but shift log Z between models.  ``log_lik_fn(params,
    data=None)`` takes the data ``(x, y)`` or uses the factory's.
    ``prior_sample_fn(key, n)`` draws (n, ...) leaf stacks from the exact
    prior; ``key`` is an integer seed or a ``torch.Generator``.  All three
    take and give the parameter tree ``template`` (a list for a module).
    """
    from ..model_comparison import pointwise_log_lik_from_predictions

    device = resolve_device(device)
    apply_fn, template = build_model(model, params_template=params_template, device=device)
    dtype = tree_leaves(template)[0].dtype
    x = _as_data(x, device, dtype)
    y = _as_data(y, device, dtype)

    def log_prior_fn(params):
        return gaussian_prior_log_prob(params, tau_list)

    def log_lik_fn(params, data=None):
        x_, y_ = (x, y) if data is None else data
        out = apply_fn(params, x_)
        return torch.sum(
            pointwise_log_lik_from_predictions(out[None], y_, model_loss, tau_out)[0]
        )

    leaves = tree_leaves(template)
    taus = _resolve_taus(len(leaves), tau_list)

    def prior_sample_fn(key, n):
        gen = key if isinstance(key, torch.Generator) else (
            torch.Generator(device=device).manual_seed(int(key)))
        outs = [
            torch.randn((n,) + tuple(leaf.shape), generator=gen, dtype=leaf.dtype,
                        device=gen.device).to(device)
            / math.sqrt(float(t))
            for leaf, t in zip(leaves, taus)
        ]
        it = iter(outs)
        return tree_map(lambda _: next(it), template)

    return log_prior_fn, log_lik_fn, prior_sample_fn, template


def define_model_tree_log_prob(
    model,
    model_loss,
    x,
    y,
    tau_list=None,
    tau_out: float = 1.0,
    predict: bool = False,
    prior_scale: float = 1.0,
    x_example=None,
    params_template=None,
    remat: bool = False,
    bridge_method: str = "auto",
    device=None,
):
    """Tree variant of :func:`define_model_log_prob`: the potential takes
    the parameter tree itself (a list for a module), with no ravel/unravel
    in the gradient path; samplers take the returned template as
    ``theta0``.  Values match ``define_model_log_prob``'s.

    Returns ``(log_prob_func, params_template)``.
    """
    raw_fn, template, device = _potential(model, model_loss, tau_list, tau_out, predict,
                                          prior_scale, params_template, remat, device, False)
    return _bind(raw_fn, x, y, device, tree_leaves(template)[0].dtype), template


def _as_batches(train_loader, num_splits: Optional[int] = None, keep_tail: bool = False):
    """(x, y) batches from a ``torch.utils.data.DataLoader`` or any iterable
    of pairs, as CPU tensors.

    Default (training, splitting): equal-size batches stacked, ragged ones
    dropped (the reference wants equal batches for split training,
    samplers.py:1221-1222).  ``keep_tail=True`` (prediction): returns
    ``(xs, ys, tail)``, the leading run of equal-size batches stacked and
    the remaining batches in loader order, so that prediction covers the
    whole test set, ragged last batch included.
    """
    xs, ys = [], []
    for i, (bx, by) in enumerate(train_loader):
        if num_splits is not None and i >= num_splits:
            break
        xs.append(torch.as_tensor(bx).detach().cpu())
        ys.append(torch.as_tensor(by).detach().cpu())
    if not xs:
        raise ValueError("train_loader yielded no batches")
    n0 = xs[0].shape[0]
    if keep_tail:
        cut = next((i for i, b in enumerate(xs) if b.shape[0] != n0), len(xs))
        tail = list(zip(xs[cut:], ys[cut:]))
        return torch.stack(xs[:cut]), torch.stack(ys[:cut]), tail
    keep = [i for i in range(len(xs)) if xs[i].shape[0] == n0]
    return torch.stack([xs[i] for i in keep]), torch.stack([ys[i] for i in keep])


def _split_potential(model, model_loss, train_loader, num_splits, tau_list, tau_out,
                     predict, verbose, params_template, device, flat):
    """(term_fn(theta, m, data), M, template, data): the stacked batches on
    ``device`` and each term's potential on batch ``m``, the prior counted
    as prior / M in every term, so that the terms sum to the full-data
    potential."""
    xs, ys = _as_batches(train_loader, num_splits)
    m_terms = int(xs.shape[0])
    raw_fn, template, device = _potential(model, model_loss, tau_list, tau_out, predict,
                                          m_terms, params_template, False, device, flat)
    dtype = tree_leaves(template)[0].dtype
    data = (_as_data(xs, device, dtype), _as_data(ys, device, dtype))
    if verbose:
        print(f"Number of splits: {m_terms} , each of batch size {xs.shape[1]}\n")

    def term_fn(theta, m, data):
        xs_, ys_ = data
        return raw_fn(theta, (xs_[m], ys_[m]))

    return term_fn, m_terms, template, data


def define_split_model_log_prob(
    model,
    model_loss,
    train_loader,
    num_splits: int,
    tau_list=None,
    tau_out: float = 1.0,
    predict: bool = False,
    verbose: bool = True,
    params_template=None,
    device=None,
):
    """Stacked-data split likelihood (reference: samplers.py:1203-1258).

    The loader's first ``num_splits`` equal-size batches (ragged ones
    dropped) are stacked to (M, B, ...) tensors on ``device`` (the card when
    None), and ``term_fn(theta, m, data)`` is the potential of batch ``m``
    at the flat ``theta``, the prior divided by M so that it counts once in
    the sum.  Returns ``(term_fn, num_terms, flat_init, unravel, (xs, ys))``;
    pass the last as ``data`` to the split samplers.
    """
    term_fn, m_terms, template, data = _split_potential(
        model, model_loss, train_loader, num_splits, tau_list, tau_out, predict, verbose,
        params_template, device, True)
    flat_init, unravel = ravel_pytree_fn(template)
    return term_fn, m_terms, flat_init, unravel, data


def define_split_model_tree_log_prob(
    model,
    model_loss,
    train_loader,
    num_splits: int,
    tau_list=None,
    tau_out: float = 1.0,
    predict: bool = False,
    verbose: bool = True,
    params_template=None,
    device=None,
):
    """Tree variant of :func:`define_split_model_log_prob`: ``term_fn(params,
    m, data)`` takes the parameter tree (a list for a module), with no
    ravel/unravel in the per-term gradient path; the split samplers take the
    returned template as ``theta0``.  Values match the flat factory's.

    Returns ``(term_fn, num_terms, params_template, (xs, ys))``.
    """
    return _split_potential(model, model_loss, train_loader, num_splits, tau_list, tau_out,
                            predict, verbose, params_template, device, False)


# ---------------------------------------------------------------------------
# user-facing entry points


def sample_model(
    model,
    x,
    y,
    params_init=None,
    model_loss="multi_class_linear_output",
    num_samples: int = 10,
    num_steps_per_sample: int = 10,
    step_size: float = 0.1,
    burn: int = 0,
    inv_mass=None,
    jitter=None,
    normalizing_const: float = 1.0,
    softabs_const=None,
    explicit_binding_const: float = 100.0,
    fixed_point_threshold: float = 1e-5,
    fixed_point_max_iterations: int = 1000,
    jitter_max_tries: int = 10,
    sampler: Sampler = Sampler.HMC,
    integrator: Integrator = Integrator.IMPLICIT,
    metric: Metric = Metric.HESSIAN,
    debug: int = 0,
    tau_out: float = 1.0,
    tau_list=None,
    store_on_GPU: bool = True,
    desired_accept_rate: float = 0.8,
    verbose: bool = True,
    key=None,
    params_template=None,
    bridge_method: str = "auto",
    progress_every: int = 0,
    device=None,
    block_rows: Optional[int] = None,
):
    """Sample BNN weights (reference: samplers.py:1261-1362): the module's
    potential from :func:`define_model_log_prob` through ``sample``, with
    the same return convention.  The chain runs on ``device`` (the card
    when None); ``params_init`` defaults to the module's own parameters.
    ``store_on_GPU=False`` returns the samples as a CPU tensor.
    ``block_rows`` evaluates the likelihood in blocks of that many rows
    (:func:`define_model_log_prob`)."""
    log_prob_func, flat_init, _ = define_model_log_prob(
        model, model_loss, x, y, tau_list=tau_list, tau_out=tau_out,
        params_template=params_template, device=device, block_rows=block_rows,
    )
    if params_init is None:
        params_init = flat_init
    params_init = torch.as_tensor(params_init, dtype=flat_init.dtype, device=flat_init.device)
    return _sample(
        log_prob_func, params_init,
        num_samples=num_samples, num_steps_per_sample=num_steps_per_sample,
        step_size=step_size, burn=burn, jitter=jitter, inv_mass=inv_mass,
        normalizing_const=normalizing_const, softabs_const=softabs_const,
        explicit_binding_const=explicit_binding_const,
        fixed_point_threshold=fixed_point_threshold,
        fixed_point_max_iterations=fixed_point_max_iterations,
        jitter_max_tries=jitter_max_tries, sampler=sampler,
        integrator=integrator, metric=metric, debug=debug,
        desired_accept_rate=desired_accept_rate, store_on_GPU=store_on_GPU,
        verbose=verbose, key=key, progress_every=progress_every,
    )


def sample_split_model(
    model,
    train_loader,
    params_init=None,
    num_splits: int = 2,
    model_loss="multi_class_linear_output",
    num_samples: int = 10,
    num_steps_per_sample: int = 10,
    step_size: float = 0.1,
    burn: int = 0,
    inv_mass=None,
    jitter=None,
    normalizing_const: float = 1.0,
    softabs_const=None,
    explicit_binding_const: float = 100.0,
    fixed_point_threshold: float = 1e-5,
    fixed_point_max_iterations: int = 1000,
    jitter_max_tries: int = 10,
    sampler: Sampler = Sampler.HMC,
    integrator: Integrator = Integrator.SPLITTING,
    metric: Metric = Metric.HESSIAN,
    debug: int = 0,
    tau_out: float = 1.0,
    tau_list=None,
    store_on_GPU: bool = True,
    desired_accept_rate: float = 0.8,
    verbose: bool = True,
    key=None,
    params_template=None,
    device=None,
):
    """Symmetric-split minibatch HMC on a BNN (reference:
    samplers.py:1364-1466): the terms of :func:`define_split_model_log_prob`
    through ``run_split_hmc_stacked``, with ``sample``'s return convention.
    The chain and the stacked batches live on ``device`` (the card when
    None); ``params_init`` defaults to the module's own parameters.  As in
    the JAX package, the RMHMC and jitter arguments are accepted and unused,
    and the trace stays on the device."""
    term_fn, m_terms, flat_init, _, data = define_split_model_log_prob(
        model, model_loss, train_loader, num_splits, tau_list=tau_list, tau_out=tau_out,
        verbose=verbose, params_template=params_template, device=device,
    )
    if params_init is None:
        params_init = flat_init
    params_init = torch.as_tensor(params_init, dtype=flat_init.dtype, device=flat_init.device)
    if params_init.ndim != 1:
        raise RuntimeError("params_init must be a 1d array.")
    if burn >= num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    if sampler == Sampler.HMC_NUTS and burn <= 0:
        raise RuntimeError("burn must be greater than 0 for NUTS.")
    if key is None:
        key = next_key()
    config = MCMCConfig(
        num_samples=num_samples, num_steps_per_sample=num_steps_per_sample,
        step_size=step_size, burn=burn, adapt_step_size=sampler == Sampler.HMC_NUTS,
        desired_accept_rate=desired_accept_rate,
    )
    result = run_split_hmc_stacked(key, term_fn, m_terms, params_init, config,
                                   integrator=integrator, inv_mass=inv_mass, data=data)
    samples = _kept_samples(params_init, result, burn)
    if verbose:
        print(f"Acceptance Rate {float(result.acc_rate):.2f}")
    if debug == 2:
        return samples, float(result.acc_rate)
    return samples


def predict_model(
    model,
    samples,
    x=None,
    y=None,
    test_loader=None,
    model_loss="multi_class_linear_output",
    tau_out: float = 1.0,
    tau_list=None,
    verbose: bool = False,
    params_template=None,
    stream_batches: Optional[int] = None,
    bridge_method: str = "auto",
    device=None,
):
    """Posterior predictive over weight samples (reference: samplers.py:1468-1562).

    Returns ``(predictions (S, N, O), log_probs (S,))`` on ``device`` (the
    card when None).  Every sample is evaluated at once
    (``torch.func.vmap`` over ``functional_call``).  With a ``test_loader``
    the evaluation goes batch by batch, ragged last batch included, so only
    one (S, batch) block of activations is live at a time; each batch's
    log-prob counts the prior, which is then taken out all but once.

    ``stream_batches=k`` also bounds the memory the data take: the loader
    is consumed lazily, at most k batches are on the device at a time, and
    each chunk's predictions move to the host before the next loads; the
    results are CPU tensors.

    ``samples`` may be a flat (S, D) stack (a tensor or a list of 1-d
    tensors) or a parameter-tree trace with (S, ...) leaves, evaluated on
    the tree path (``params_template`` then defaults to its first draw);
    ``stream_batches`` takes a flat stack only.
    """
    device = resolve_device(device)
    tree_samples = is_param_tree(samples)
    if tree_samples:
        if stream_batches:
            raise TypeError(
                "stream_batches takes a flat (S, D) sample stack: ravel the "
                "trace (utils.pytree.ravel_pytree_fn per draw) or drop "
                "stream_batches for the tree path."
            )
        samples = tree_map(lambda leaf: torch.as_tensor(leaf, device=device), samples)
        if params_template is None:
            params_template = tree_map(lambda leaf: leaf[0], samples)
    else:
        if not isinstance(samples, torch.Tensor):
            samples = torch.stack([torch.as_tensor(s) for s in samples])
        samples = samples.to(device)

    raw, template, _ = _potential(model, model_loss, tau_list, tau_out, True, 1.0,
                                  params_template, False, device, not tree_samples)
    dtype = tree_leaves(template)[0].dtype

    def on_batch(bx, by):
        data = (_as_data(bx, device, dtype), _as_data(by, device, dtype))
        return torch.func.vmap(lambda t: raw(t, data))(samples)

    def priors():
        return torch.func.vmap(lambda t: raw(t, None))(samples)

    if test_loader is not None and stream_batches:
        return _predict_streaming(samples, test_loader, on_batch, priors, int(stream_batches))

    if test_loader is not None:
        xs, ys, tail = _as_batches(test_loader, None, keep_tail=True)
        lls = None
        parts = []
        for bx, by in list(zip(xs, ys)) + tail:
            lp_b, out_b = on_batch(bx, by)
            lls = lp_b if lls is None else lls + lp_b
            parts.append(out_b)
        lps = lls - (len(parts) - 1) * priors()
        return torch.cat(parts, dim=1), lps

    if x is None or y is None:
        raise RuntimeError("Val data not defined (pass x,y or test_loader)")
    lps, preds = on_batch(x, y)
    return preds, lps


def _predict_streaming(samples, test_loader, on_batch, priors, stream_batches: int):
    """Lazy chunked posterior predictive: consume ``test_loader`` with at
    most ``stream_batches`` equal-size batches staged at a time; each
    chunk's predictions move to the host before the next chunk loads.

    Each batch's log-prob counts the prior once; after n batches the sum
    over-counts it n - 1 times, which is taken out at the end.
    """
    host_preds, lls = [], None
    n_batches = 0
    buf, buf_n = [], None

    def flush():
        nonlocal lls, n_batches
        if not buf:
            return
        acc = torch.zeros(samples.shape[:1], dtype=samples.dtype, device=samples.device)
        outs = []
        for bx, by in buf:
            lp_b, out_b = on_batch(bx, by)
            acc = acc + lp_b
            outs.append(out_b)
        host_preds.append(torch.cat(outs, dim=1).cpu())
        lls = acc if lls is None else lls + acc
        n_batches += len(buf)
        buf.clear()

    for bx, by in test_loader:
        bx = torch.as_tensor(bx)
        if buf_n is not None and bx.shape[0] != buf_n:
            flush()  # a size change (the ragged tail) ends the current run
            buf_n = None
        if buf_n is None:
            buf_n = bx.shape[0]
        buf.append((bx, by))
        if len(buf) >= stream_batches:
            flush()
    flush()
    if n_batches == 0:
        raise ValueError("test_loader yielded no batches")
    lps = lls - (n_batches - 1) * priors()
    return torch.cat(host_preds, dim=1), lps.cpu()
