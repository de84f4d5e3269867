#!/usr/bin/env python3
"""How far float32 dense-Gaussian HMC runs drift from float64, by the order
in which the gradient's product -(theta - mean) P sums the rows of P.

    python3 scripts/gaussian_sum_order_torch.py [--d 4096 4099 2048] [--chains 5 3 24]

Runs on the CPU.  Each case is a card test's (``tests/test_torch_gpu.py::
gaussian_case``: RandomState(D) data, 10 draws x 6 steps, eps 0.3) run four
ways: float64 (the yardstick), float32 through ``torch.matmul``, and
float32 summing P's rows one at a time in blocks of B rows (each block into
its own partial, the partials added in order): B = D is one sum over all
rows, as variant 5 of ``kernels/csrc/gaussian_hmc.cuh`` did before it took
blocks of 64 (now the dense kernel's ``DT_CHUNK``).  It prints each run's
largest distance from float64 and from the float32 matmul.  The row-by-row sums round each
product before adding (no fused multiply-add), so they are an emulation.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hamiltorch_tpu_torch.kernels.gaussian_hmc import _energy  # noqa: E402

DRAWS, STEPS, EPS = 10, 6, 0.3


def case(d, chains):
    """The card test's dense case: (theta0, P, mean, (momenta, uniforms))."""
    rng = np.random.RandomState(d)
    a = np.random.RandomState(d).randn(d, d)
    prec = (a @ a.T / d + np.eye(d)).astype(np.float32)
    mean = rng.randn(d).astype(np.float32)
    noise = (torch.as_tensor(rng.randn(DRAWS, chains, d).astype(np.float32)),
             torch.as_tensor(rng.rand(DRAWS, chains).astype(np.float32)))
    theta0 = rng.randn(chains, d).astype(np.float32)
    return torch.as_tensor(theta0), torch.as_tensor(prec), torch.as_tensor(mean), noise


def blocked_matvec(delta, prec, block):
    """delta (C, D) @ P (D, D), P's rows added one at a time in blocks."""
    total = None
    for b0 in range(0, prec.shape[0], block):
        part = torch.zeros_like(delta)
        for i in range(b0, min(b0 + block, prec.shape[0])):
            part = part + delta[:, i:i + 1] * prec[i]
        total = part if total is None else total + part
    return total


def run(theta0, prec, mean, noise, matvec, dtype):
    """The plain sampler's draw loop with the given product; every draw."""
    theta0, prec, mean = theta0.to(dtype), prec.to(dtype), mean.to(dtype)

    def grad(th):
        return -matvec(th - mean, prec)

    theta, g_cur, out = theta0, grad(theta0), []
    for z, u in zip(*noise):
        z = z.to(dtype)
        h0 = _energy(theta, mean, g_cur, z)
        p = z + (0.5 * EPS) * g_cur
        th, g = theta, g_cur
        for _ in range(STEPS):
            th = th + EPS * p
            g = grad(th)
            p = p + EPS * g
        p = p - (0.5 * EPS) * g
        ok = (h0 - _energy(th, mean, g, p)) >= torch.log(u.double())
        theta = torch.where(ok[:, None], th, theta)
        g_cur = torch.where(ok[:, None], g, g_cur)
        out.append(theta)
    return torch.stack(out, 1).double()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, nargs="+", default=[4096, 4099, 2048])
    ap.add_argument("--chains", type=int, nargs="+", default=[5, 3, 24])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for d, chains in zip(args.d, args.chains):
        data = case(d, chains)
        ref = run(*data, torch.matmul, torch.float64)
        mm = run(*data, torch.matmul, torch.float32)
        print(f"dense D={d}, {chains} chains, {DRAWS} draws x {STEPS} steps, eps {EPS}: "
              f"max |x - x64|: float32 matmul {float((mm - ref).abs().max()):.3e}", flush=True)
        for block in (d, 64, 16):
            got = run(*data, lambda a, b: blocked_matvec(a, b, block), torch.float32)
            print(f"  rows summed in blocks of {block}: {float((got - ref).abs().max()):.3e} "
                  f"from float64, {float((got - mm).abs().max()):.3e} from the float32 matmul",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
