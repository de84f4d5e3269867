#!/usr/bin/env python3
"""Host cost of RMHMC's metric pipeline on the card: two designs.

    python3 scripts/rmhmc_designs_torch.py

Times one call of every chain's dH/dtheta (third-order AD through the
Hessian, softabs and Cholesky), dH/dp and H on the D=64 quartic Gaussian
of ``chip_smoke.py``'s ``rmhmc`` phase and on the 2-D banana, at 64 chains:

* the package's design (``ops.metrics``): one chain's functions under
  ``torch.func`` (``grad`` over ``hessian`` = jacfwd over jacrev, the
  softabs ``autograd.Function``), ``vmap``-ed over chains;
* the autograd engine's: the log-prob ``vmap``-ed forward, the Hessian's
  rows by ``torch.autograd.grad(..., is_grads_batched=True,
  create_graph=True)``, batched eigh / Cholesky, one backward of the summed
  H (the chains are independent, so its gradient is every chain's).

Each time is the median of 5 calls after a warm one (host clock around
``torch.cuda.synchronize()``), with the count of ATen ops in one call
(``torch.profiler``).  Both must agree; the script fails otherwise.  Needs a
CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hamiltorch_tpu_torch.enums import Metric
    from hamiltorch_tpu_torch.ops import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)

    def quartic(d):
        gen = torch.Generator().manual_seed(0)
        q, _ = torch.linalg.qr(torch.randn(d, d, generator=gen, dtype=torch.float64))
        prec = ((q / torch.logspace(-1, 1, d, dtype=torch.float64)) @ q.T).float().to(dev)

        def lp(t):
            return -0.5 * t @ prec @ t - 0.025 * torch.sum(t ** 4)
        return lp

    def banana(t):
        return -0.5 * (t[0] ** 2 / 4.0) - 0.5 * ((t[1] - 0.1 * (t[0] ** 2 - 4.0)) ** 2) / 0.5

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
        return statistics.median(ts) * 1e3, ops

    def engine_grad_theta(lp, alpha, theta, p):
        d = theta.shape[-1]
        t = theta.detach().requires_grad_()
        logp = torch.func.vmap(lp)(t)
        g, = torch.autograd.grad(logp.sum(), t, create_graph=True)
        eye = torch.eye(d, device=t.device, dtype=t.dtype)[:, None].expand(d, t.shape[0], d)
        h, = torch.autograd.grad(g, t, grad_outputs=eye, is_grads_batched=True, create_graph=True)
        gm, lam = metrics.softabs_transform(-h.transpose(0, 1), alpha)
        chol = metrics.cholesky_or_nan(gm)
        y = torch.linalg.solve_triangular(chol, p[..., None], upper=False)[..., 0]
        ham = (-logp + 0.5 * d * math.log(2 * math.pi) + 0.5 * torch.log(lam).sum(-1)
               + 0.5 * (y * y).sum(-1))
        return torch.autograd.grad(ham.sum(), t)[0]

    ok = True
    for name, lp, d, alpha in (("quartic D=64", quartic(64), 64, 1e3), ("banana", banana, 2, 1e2)):
        gen = torch.Generator().manual_seed(1)
        theta = (0.3 * torch.randn(64, d, generator=gen)).to(dev)
        p = torch.randn(64, d, generator=gen).to(dev)
        rm = metrics.batched(metrics.make_rm_hamiltonian(
            lp, metrics.RMOptions(metric=Metric.SOFTABS, softabs_const=alpha)), False)
        for what, fn in (("grad_theta", lambda: rm.grad_theta(theta, p, None)),
                         ("grad_p", lambda: rm.grad_p(theta, p, None)),
                         ("ham", lambda: rm.ham(theta, p, None)),
                         ("grad_theta, autograd engine",
                          lambda: engine_grad_theta(lp, alpha, theta, p))):
            ms, ops = timed(fn)
            print(f"{name}, 64 chains, {what}: {ms:.3f} ms a call, {ops} ATen ops [{card}]")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            rm.grad_p(theta, p, None)
            torch.cuda.synchronize()
        print(f"{name}: grad_p's ops by device time")
        print(prof.key_averages().table(sort_by="device_time_total", row_limit=8))
        g = -torch.func.vmap(torch.func.hessian(lp))(theta)
        for what, fn in (("the Hessians alone", lambda: torch.func.vmap(torch.func.hessian(lp))(theta)),
                         ("batched eigh alone", lambda: torch.linalg.eigh(g)),
                         ("batched cholesky_ex alone", lambda: torch.linalg.cholesky_ex(
                             g @ g.mT + torch.eye(d, device=dev)))):
            ms, ops = timed(fn)
            print(f"{name}, 64 chains, {what}: {ms:.3f} ms a call, {ops} ATen ops [{card}]")
        for lib in ("cusolver", "magma"):
            torch.backends.cuda.preferred_linalg_library(lib)
            ms, _ = timed(lambda: torch.linalg.eigh(g))
            print(f"{name}, 64 chains, batched eigh with {lib}: {ms:.3f} ms [{card}]")
        torch.backends.cuda.preferred_linalg_library("default")
        a = rm.grad_theta(theta, p, None)
        b = engine_grad_theta(lp, alpha, theta, p)
        err = float((a - b).abs().max() / a.abs().max())
        print(f"{name}: the two designs' dH/dtheta differ by {err:.3e} of max |g|")
        ok &= err < 1e-4
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
