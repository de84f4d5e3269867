#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hamiltorch_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a).  It

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one ``nvcc`` per source, all started together) and prints the time;
3. holds each kernel against its plain PyTorch version on the same inputs
   and the same injected noise, at the flagship shape and at a small
   ragged one, and fails above the stated tolerance, on any differing
   accept decision, or where the gradient's part of the move is too small
   beside the tolerance for the comparison to see a wrong gradient;
4. times each kernel and its plain version at the flagship shape (CUDA
   events, median of 3, in turns);
5. drives the main path with every launch count set to 0 first: the fused
   flagship sampler ``kernels.bnn_hmc`` and ``run_hmc_chains`` on the
   flagship BNN (64 chains, 10 draws x 50 steps, step 2e-4), plus
   ``sample()`` on the 3-D Gaussian, then reads the counts and fails if a
   kernel was not launched;
6. prints one JSON line per kernel summary and, last, the device line.

There is no CPU path: without a CUDA device it exits non-zero and prints
no result.  TF32 is off for every float32 matmul (cuBLAS and cuDNN).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (name, route, source, the TPU kernel it replaces)
KERNELS = [
    ("bnn_hmc", "cuda", "hamiltorch_tpu_torch/kernels/csrc/bnn_hmc.cu",
     "hamiltorch_tpu/kernels/bnn_hmc.py:143"),
]
# Kernel vs plain: parameters after a few draws differ only by float32
# rounding of differently ordered sums (expected ~1e-7); 1e-5 leaves 100x.
ATOL = 1e-5
# The comparison must see the gradient: on chains that accepted every draw,
# the part of the move that the gradient makes (final theta less the
# drift-only theta0 + eps * L * sum(momenta)) must reach SIGNAL in every
# parameter block and in every 64-row tile of W1 (the backward kernel's
# I-tiles, the ragged last one included), so that a gradient wrong by more
# than ATOL / SIGNAL = 1% fails.
SIGNAL = 100 * ATOL
W1_ROW_TILE = 64
FLAGSHIP = dict(n=1024, i=784, h=128, c=64)


class SmokeError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bnn_inputs(torch, n, i, h, c, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, i, generator=gen)
    y = torch.tanh(x @ (torch.randn(i, generator=gen) / i**0.5))[:, None]
    w1 = 0.01 * torch.randn(c, i, h, generator=gen)
    b1 = torch.zeros(c, h)
    w2 = 0.01 * torch.randn(c, h, generator=gen)
    b2 = torch.zeros(c)
    return [t.to(device).contiguous() for t in (x, y, w1, b1, w2, b2)]


def gradient_signal(torch, args, want, momenta, steps, eps):
    """Smallest gradient part of the move over W1's row tiles and b1, w2, b2.

    Only chains that accepted every draw count: their drift-only position
    is theta0 + eps * L * (sum of the draws' momenta).
    """
    w1, b1, w2, b2 = args[2:]
    c, i_dim, h = w1.shape
    full = want[4] == 1.0
    if not bool(full.any()):
        raise SmokeError("no chain accepted every draw: the gradient check sees nothing")
    theta0 = torch.cat([t.reshape(c, -1) for t in (w1, b1, w2, b2)], dim=1)
    theta1 = torch.cat([t.reshape(c, -1) for t in want[:4]], dim=1)
    grad_part = (theta1 - theta0 - eps * steps * momenta.sum(dim=0))[full].abs()
    s0, s1 = i_dim * h, i_dim * h + h
    w1_part = grad_part[:, :s0].reshape(-1, i_dim, h)
    blocks = [w1_part[:, r:r + W1_ROW_TILE] for r in range(0, i_dim, W1_ROW_TILE)]
    blocks += [grad_part[:, s0:s1], grad_part[:, s1:s1 + h], grad_part[:, s1 + h:]]
    return min(float(b.max()) for b in blocks)


def compare_bnn_hmc(torch, shape, draws, steps, eps, seed, device):
    """Max abs error of kernel vs plain on injected noise; accepts must match,
    and the move the gradient makes must be large beside the tolerance."""
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc, bnn_hmc_reference

    args = bnn_inputs(torch, shape["n"], shape["i"], shape["h"], shape["c"], seed, device)
    dim = shape["i"] * shape["h"] + 2 * shape["h"] + 1
    gen = torch.Generator().manual_seed(seed + 1)
    noise = (torch.randn(draws, shape["c"], dim, generator=gen).to(device),
             torch.rand(draws, shape["c"], generator=gen).to(device))
    kw = dict(num_samples=draws, num_steps=steps, step_size=eps, tau=10.0, _noise=noise)
    got = bnn_hmc(seed, *args, **kw)
    want = bnn_hmc_reference(seed, *args, **kw)
    torch.cuda.synchronize()
    for t in got:
        if not bool(torch.all(torch.isfinite(t))):
            raise SmokeError("bnn_hmc returned non-finite values")
    if not torch.equal(got[4], want[4]):
        raise SmokeError(f"accept rates differ: kernel {got[4].tolist()} plain {want[4].tolist()}")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    scale = max(float(b.abs().max()) for b in want[:4])
    signal = gradient_signal(torch, args, want, noise[0], steps, eps)
    print(f"bnn_hmc vs plain {shape} {draws}x{steps} eps={eps}: max_abs_err={err:.3e} "
          f"max_rel_err={err / scale:.3e} acc_mean={float(want[4].mean()):.4f} "
          f"min_gradient_move={signal:.3e}")
    if not err <= ATOL:
        raise SmokeError(f"bnn_hmc disagrees with its plain version: {err:.3e} > {ATOL}")
    if not signal >= SIGNAL:
        raise SmokeError(f"the gradient moves the parameters by {signal:.3e} < {SIGNAL}: "
                         "the comparison could not see a wrong gradient")
    return err, float(want[4].mean())


def cuda_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_bnn_hmc(torch, device, draws, steps, eps):
    """Kernel and plain times (ms) on Philox / torch noise, in turns."""
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc, bnn_hmc_reference

    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    kw = dict(num_samples=draws, num_steps=steps, step_size=eps, tau=10.0)
    times = {bnn_hmc: [], bnn_hmc_reference: []}
    for fn in times:  # warm up
        fn(0, *args, **kw)
    torch.cuda.synchronize()
    for rep in range(3):
        order = list(times) if rep % 2 == 0 else list(times)[::-1]
        for fn in order:
            times[fn].append(cuda_ms(torch, lambda: fn(rep + 1, *args, **kw)))
    k_ms, p_ms = times[bnn_hmc], times[bnn_hmc_reference]
    return statistics.median(k_ms), statistics.median(p_ms), k_ms, p_ms


def main() -> int:
    if not (REPO / "hamiltorch_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    t_all = time.perf_counter()

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build every kernel from the checkout's sources
    from hamiltorch_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all([name for name, *_ in KERNELS])
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  [{name}] {line.strip()}")

    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc

    # 3. kernel vs plain, injected noise
    # both shapes reject a few draws, so accept decisions are tested too
    small = dict(n=100, i=50, h=128, c=3)
    _, small_acc = compare_bnn_hmc(torch, small, draws=4, steps=4, eps=0.02, seed=3, device=device)
    err, flagship_acc = compare_bnn_hmc(torch, FLAGSHIP, draws=3, steps=5, eps=0.01, seed=5,
                                        device=device)
    if not (0.0 < small_acc < 1.0 and 0.0 < flagship_acc < 1.0):
        raise SmokeError(f"acceptance {small_acc}, {flagship_acc}: a Metropolis outcome never occurred")

    # 4. kernel alone on Philox, and the plain version, at the flagship
    draws, steps, eps = 10, 50, 2e-4
    k_ms, p_ms, k_all, p_all = time_bnn_hmc(torch, device, draws, steps, eps)
    grad_steps = FLAGSHIP["c"] * draws * steps
    print(f"bnn_hmc {FLAGSHIP} {draws}x{steps}: kernel {k_ms:.3f} ms "
          f"({grad_steps / k_ms * 1e3:.1f} grad-steps/s), plain {p_ms:.3f} ms "
          f"({grad_steps / p_ms * 1e3:.1f} grad-steps/s); runs kernel {k_all} plain {p_all} "
          f"[{card}]")

    # 5. the main path, counted
    from hamiltorch_tpu_torch import MCMCConfig, Sampler, run_hmc_chains, sample
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    bnn_hmc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fused = bnn_hmc(11, *bnn_inputs(torch, **FLAGSHIP, seed=11, device=device),
                    num_samples=draws, num_steps=steps, step_size=eps, tau=10.0)
    torch.cuda.synchronize()
    if not all(bool(torch.all(torch.isfinite(t))) for t in fused):
        raise SmokeError("fused sampler returned non-finite values")
    print(f"fused sampler: acc mean {float(fused[4].mean()):.4f}")

    log_prob_fn, params0 = make_flagship_potential_tree(device=device)
    config = MCMCConfig(num_samples=draws, num_steps_per_sample=steps, step_size=eps)
    run_hmc_chains(0, log_prob_fn, params0, config, num_chains=FLAGSHIP["c"])  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_hmc_chains(1, log_prob_fn, params0, config, num_chains=FLAGSHIP["c"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, leaf in res.samples.items():
        want = (FLAGSHIP["c"], draws) + tuple(params0[name].shape)
        if tuple(leaf.shape) != want or not bool(torch.all(torch.isfinite(leaf))):
            raise SmokeError(f"run_hmc_chains sample {name}: shape {tuple(leaf.shape)}, want {want}")
    acc = float(res.acc_rate.mean())
    print(f"run_hmc_chains flagship tree 64 chains {draws}x{steps}: {dt:.3f} s, "
          f"{grad_steps / dt:.1f} grad-steps/s, acceptance {acc:.4f}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]")

    stds = torch.tensor([0.5, 1.0, 2.0], device=device)
    draws_g = sample(lambda t: -0.5 * torch.sum((t / stds) ** 2), torch.zeros(3, device=device),
                     num_samples=400, num_steps_per_sample=5, step_size=0.3,
                     sampler=Sampler.HMC, key=0, verbose=False)
    emp = draws_g[1:].std(dim=0)
    print(f"sample() 3-D Gaussian 400 draws: std {emp.tolist()} (target [0.5, 1, 2])")
    # the std-0.5 dim is not checked: a trajectory of 5 x 0.3 sits on its
    # t ~ pi * sigma resonance, where each draw nearly negates it and its
    # spread grows slowly from the start at 0 (the JAX package reads
    # 0.15-0.45 there too); the other two dims mix
    if draws_g.shape != (400, 3) or not bool(torch.all((emp / stds - 1)[1:].abs() < 0.35)):
        raise SmokeError(f"sample(): shape {tuple(draws_g.shape)}, std {emp.tolist()}")

    launches = {"bnn_hmc": bnn_hmc.launches}
    for name, count in launches.items():
        if count < 1:
            raise SmokeError(f"kernel {name} was not launched on the main path")

    # the port's tensor path is the same on the card as on the CPU
    lp_c, p_c = make_flagship_potential_tree(in_dim=8, hidden=4, n_data=16, device=device)
    lp_h, p_h = make_flagship_potential_tree(in_dim=8, hidden=4, n_data=16)
    gen = torch.Generator().manual_seed(2)
    z, u = torch.randn(5, 4, 41, generator=gen), torch.rand(5, 4, generator=gen)
    cfg = MCMCConfig(num_samples=5, num_steps_per_sample=5, step_size=0.05)
    on_card = run_hmc_chains(0, lp_c, p_c, cfg, 4, _noise=(z.to(device), u.log().to(device)))
    on_host = run_hmc_chains(0, lp_h, p_h, cfg, 4, _noise=(z, u.log()))
    path_err = max(float((on_card.samples[k].cpu() - on_host.samples[k]).abs().max())
                   for k in on_host.samples)
    print(f"run_hmc_chains tiny flagship, card vs CPU: max_abs_err {path_err:.3e}")
    if not path_err <= ATOL:
        raise SmokeError(f"run_hmc_chains on the card disagrees with the CPU: {path_err:.3e}")

    print(f"total {time.perf_counter() - t_all:.1f} s")
    summary = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
               for name, route, source, replaces in KERNELS]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
