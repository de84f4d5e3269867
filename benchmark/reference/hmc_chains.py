"""Plain reference of HMC over the posterior of a ``torch.nn.Module``.

The posterior of a configuration whose inputs hand over a module, data
(x, y) and chains' parameters theta (C, D):

    logp(theta) = loglik(module(x; theta), y)
                  + sum over leaves [n/2 log tau - n/2 log 2 pi - tau/2 |w|^2],

with theta the module's parameters in ``parameters()`` order, each
row-major, and tau the leaf's prior precision (``prior_precision``: one
number, or one a leaf).  The likelihoods (``model_loss``, scaled by
``tau_out``): ``multi_class_linear_output``, tau_out times the summed log
softmax of each row's label; ``regression``, -tau_out/2 times the summed
squared residuals.  The module runs on a copy through
``torch.func.functional_call``, one chain at a time, over blocks of
``reference_rows`` rows (every row when the configuration gives none),
with the gradient by autograd.

The sampler follows the definition of the port's ``run_hmc_chains`` with
an identity mass, written from the equations: per draw, momenta z and a
uniform u from the chain's stream (``streams.py``, in the configuration's
dtype), h0 = -logp + |z|^2 / 2, a half kick, L drift and kick steps, half
a kick pulled back, h1 = -logp' + |p|^2 / 2, and the proposal accepted
when (h0 - h1) >= log u.  Energies are reduced in float64.

Precisions (``numerics.py``): ``float64``, a float64 copy of the module;
``tf32``, float32 with both operands of every convolution, linear layer
and matrix product rounded to TF32 before the product, in the backward's
products too, under PyTorch's own TF32 switches held off.
"""

from __future__ import annotations

import contextlib
import copy
import math

import torch
import torch.nn.functional as F

from . import streams
from .bnn import _take
from .numerics import dtype, exact_products, to_tf32


def _conv_args(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if isinstance(padding, str):
        raise NotImplementedError("the TF32 control takes numeric padding only")
    return input, weight, bias, stride, padding, dilation, groups


def _linear_args(input, weight, bias=None):
    return input, weight, bias


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        xr, wr = to_tf32(x), to_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf, ctx.bias = (stride, padding, dilation, groups), b is not None
        return F.conv2d(xr, wr, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = to_tf32(g)
        gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, *ctx.conf)
        gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, *ctx.conf)
        return gx, gw, g.sum((0, 2, 3)) if ctx.bias else None, None, None, None, None


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = to_tf32(x), to_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.bias = b is not None
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = to_tf32(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.bias else None
        return gx, gw, gb


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        if a.ndim < 2 or b.ndim < 2:
            raise NotImplementedError("the TF32 control takes products of matrices only")
        ar, br = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = to_tf32(g)
        return ((gr @ br.transpose(-1, -2)).sum_to_size(ar.shape),
                (ar.transpose(-1, -2) @ gr).sum_to_size(br.shape))


_MATMULS = (torch.matmul, torch.mm, torch.bmm, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.mm, torch.Tensor.bmm)
_REFUSED = (torch.conv1d, torch.conv3d, torch.conv_transpose1d, torch.conv_transpose2d,
            torch.conv_transpose3d, torch.einsum, torch.addmm, torch.baddbmm, torch.tensordot,
            torch.Tensor.addmm)


class TF32Products(torch.overrides.TorchFunctionMode):
    """Inside, every convolution, linear layer and matrix product rounds
    both operands to TF32 before a float32 product; a product it does not
    know is refused rather than computed in float32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            return _Conv2d.apply(*_conv_args(*args, **kwargs))
        if func is F.linear:
            return _Linear.apply(*_linear_args(*args, **kwargs))
        if func in _MATMULS:
            return _MatMul.apply(*args, **kwargs)
        if func in _REFUSED:
            raise NotImplementedError(f"the TF32 control has no rule for {func}")
        return func(*args, **kwargs)


def loglik(out: torch.Tensor, y: torch.Tensor, model_loss: str, tau_out: float) -> torch.Tensor:
    """The log likelihood of a block of rows, summed in float64."""
    if model_loss == "multi_class_linear_output":
        logsm = out - torch.logsumexp(out, dim=-1, keepdim=True)
        picked = torch.gather(logsm, -1, y.reshape(-1, 1).to(torch.int64))
        return tau_out * torch.sum(picked.double())
    if model_loss == "regression":
        return -0.5 * tau_out * torch.sum(((out - y) ** 2).double())
    raise NotImplementedError(f"no reference for model_loss {model_loss!r}")


class Posterior:
    """logp (float64) and its gradient for chains' flat parameters (L, D)."""

    def __init__(self, module: torch.nn.Module, x, y, cfg: dict, prec: str = "float64"):
        self.prec, self.dt = prec, dtype(prec)
        self.module = copy.deepcopy(module).to(device=x.device, dtype=self.dt).eval()
        named = list(self.module.named_parameters())
        self.names = [name for name, _ in named]
        self.shapes = [p.shape for _, p in named]
        self.sizes = [p.numel() for _, p in named]
        self.buffers = dict(self.module.named_buffers())
        self.x = x.to(self.dt)
        self.y = y.to(self.dt) if y.is_floating_point() else y
        self.model_loss, self.tau_out = cfg["model_loss"], float(cfg["tau_out"])
        taus = cfg["prior_precision"]
        taus = [float(taus)] * len(named) if isinstance(taus, (int, float)) else taus
        if len(taus) != len(named):
            raise ValueError(f"{len(taus)} prior precisions for {len(named)} parameter leaves")
        self.tau = torch.cat([torch.full((n,), float(t), dtype=torch.float64, device=x.device)
                              for n, t in zip(self.sizes, taus)])
        self.log_norm = sum(0.5 * n * (math.log(t) - math.log(2 * math.pi))
                            for n, t in zip(self.sizes, taus))
        self.rows = int(cfg.get("reference_rows") or len(x))

    def _products(self):
        return TF32Products() if self.prec == "tf32" else contextlib.nullcontext()

    def __call__(self, theta: torch.Tensor):
        logp = torch.empty(theta.shape[0], dtype=torch.float64, device=theta.device)
        grad = torch.empty(theta.shape, dtype=self.dt, device=theta.device)
        with exact_products():
            for lane in range(theta.shape[0]):
                th = theta[lane].detach().to(self.dt).requires_grad_(True)
                params = dict(zip(self.names, (t.view(s) for t, s in
                                               zip(th.split(self.sizes), self.shapes))))
                ll, g = 0.0, torch.zeros_like(th)
                for start in range(0, len(self.x), self.rows):
                    rows = slice(start, start + self.rows)
                    with self._products():
                        out = torch.func.functional_call(self.module, {**params, **self.buffers},
                                                         (self.x[rows],))
                        part = loglik(out, self.y[rows], self.model_loss, self.tau_out)
                    g += torch.autograd.grad(part, th)[0]
                    ll += float(part.detach())
                w = th.detach()
                logp[lane] = ll + self.log_norm - 0.5 * torch.sum(self.tau * w.double() ** 2)
                grad[lane] = g - (self.tau * w.double()).to(self.dt)
        return logp, grad


def hmc(seed, post: Posterior, theta, draws: int, steps: int, eps: float, noise_dtype,
        margin: float = 0.0, max_lanes: int = 4):
    """HMC over the chains of ``theta`` (C, D) under the run key ``seed``.

    The noise is drawn in ``noise_dtype`` on ``theta``'s device, as the
    program draws it.  A decision whose margin |(h0 - h1) - log u| is
    below ``margin`` may go either way under rounding: there the chain's
    lane is doubled, one copy accepting and one rejecting (at most
    ``max_lanes`` lanes a chain).  Returns (chain (L,), final parameters
    (L, D), accepted draws (L,), h0 (L, draws), h1 (L, draws)), the last
    three in float64.
    """
    c, d = theta.shape
    dev = theta.device
    chain = torch.arange(c, device=dev)
    cur = theta.to(post.dt)
    logp, grad = post(cur)
    count = torch.zeros(c, dtype=torch.float64, device=dev)
    h0s = torch.zeros((c, draws), dtype=torch.float64, device=dev)
    h1s = torch.zeros_like(h0s)
    for n in range(draws):
        z, log_u = streams.draw_noise(seed, n, c, d, noise_dtype, dev)
        z, log_u = z[chain].to(post.dt), log_u[chain].double()
        h0 = -logp + 0.5 * torch.sum(z.double() ** 2, dim=1)
        p = z + (0.5 * eps) * grad
        th = cur
        for _ in range(steps):
            th = th + eps * p
            logp_new, g_new = post(th)
            p = p + eps * g_new
        p = p - (0.5 * eps) * g_new
        h1 = -logp_new + 0.5 * torch.sum(p.double() ** 2, dim=1)
        h0s[:, n], h1s[:, n] = h0, h1
        m = (h0 - h1) - log_u
        accept = m >= 0
        if margin > 0:
            lanes = torch.bincount(chain, minlength=c)[chain]
            idx = torch.nonzero((m.abs() < margin) & (lanes < max_lanes)).flatten()
            if idx.numel():
                cur, grad, th, g_new, logp, logp_new, count, chain, h0s, h1s = _take(
                    [cur, grad, th, g_new, logp, logp_new, count, chain, h0s, h1s], idx)
                accept = torch.cat((accept, ~accept[idx]))
        cur = torch.where(accept[:, None], th, cur)
        grad = torch.where(accept[:, None], g_new, grad)
        logp = torch.where(accept, logp_new, logp)
        count = count + accept.double()
    return chain, cur, count, h0s, h1s
