#!/usr/bin/env python3
"""Where the data-summed potential's time goes, on one rank on the card.

    python3 scripts/psum_overhead_torch.py

Times one batched value and gradient of 64 flagship chains (the main
path's ``torch.func.vmap(value_and_grad(...))``) on a one-rank NCCL mesh,
in turns, for:

* ``plain``: the full-batch potential (``models.flagship``);
* ``psum``: ``parallel.sharding.make_psum_log_prob`` as the package has it
  (the local gradient from the autograd engine inside the
  ``autograd.Function``, one all-reduce of the batch's values and
  gradients);
* ``psum, no all-reduce``: the same with the collective replaced by
  nothing, which leaves the ``autograd.Function``'s own cost;
* ``psum, nested torch.func``: the former design, whose forward took the
  local value and gradient with ``torch.func.vmap(grad_and_value(...))``.

Each figure is the median of 5 rounds of 20 calls after a warm one: the
host time to enqueue the calls and the time until the card is done
(host clock around ``torch.cuda.synchronize()``).  Then ``torch.profiler``
over 10 calls of the package's design gives the device time and the
``autograd.Function``'s own host time.  All designs must return the same
values and gradients.  Last, each design inside the sampler:
``run_hmc_chains`` at 64 chains x 2 draws x 50 steps (the main path's
step 2e-4), ms a gradient step in turns, and the CUDA runtime calls of one
draw of the package's design (``torch.profiler``).  Needs a CUDA card;
prints its name and power limit.
"""

from __future__ import annotations

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
    import torch.distributed as dist

    import chip_smoke
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential
    from hamiltorch_tpu_torch.ops.potential import value_and_grad
    from hamiltorch_tpu_torch.parallel import sharding as sh

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda:0")
    mesh = sh.make_mesh()
    group = mesh.get_group("data")
    loglik, prior, x, y, theta0 = chip_smoke.flagship_shards(torch, dev)
    plain, _ = make_flagship_potential(device=dev)
    thetas = theta0.expand(64, -1).contiguous()

    class Nested(torch.autograd.Function):
        """The former design: the local value and gradient by a nested
        ``torch.func`` transform."""

        @staticmethod
        def forward(theta, local, grp, nbatch):
            flat = theta.reshape(-1, theta.shape[-1])
            grads, vals = torch.func.vmap(torch.func.grad_and_value(local))(flat)
            buf = torch.cat([vals.reshape(-1, 1), grads], dim=1)
            dist.all_reduce(buf, group=grp)
            lead = tuple(theta.shape[:nbatch])
            return buf[:, 0].reshape(lead), buf[:, 1:].reshape(theta.shape)

        setup_context = staticmethod(sh._SummedLoglik.setup_context)
        backward = staticmethod(sh._SummedLoglik.backward)

        @staticmethod
        def vmap(info, in_dims, theta, local, grp, nbatch):
            return Nested.apply(theta.movedim(in_dims[0], 0), local, grp, nbatch + 1), (0, 0)

    def nested(t):
        return prior(t) + Nested.apply(t, lambda v: loglik(v, x, y), group, 0)[0]

    real_all_reduce = dist.all_reduce

    def skipped(t):
        dist.all_reduce = lambda *a, **k: None
        try:
            return psum(t)
        finally:
            dist.all_reduce = real_all_reduce

    psum = sh.make_psum_log_prob(loglik, prior, x, y, group)
    designs = {"plain": plain, "psum": psum, "psum, no all-reduce": skipped,
               "psum, nested torch.func": nested}
    vgs = {name: torch.func.vmap(value_and_grad(fn)) for name, fn in designs.items()}
    want = vgs["plain"](thetas)
    for name, vg in vgs.items():
        got = vg(thetas)
        err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        if not err <= 1e-6:
            print(f"{name} disagrees with plain: {err:.3e}", file=sys.stderr)
            return 1
    times = {name: ([], []) for name in vgs}
    for _ in range(5):
        for name, vg in vgs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                vg(thetas)
            enq = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            times[name][0].append(enq)
            times[name][1].append((time.perf_counter() - t0) / 20 * 1e3)
    for name, (enq, tot) in times.items():
        print(f"{name}: {statistics.median(tot):.3f} ms a batched evaluation of 64 chains "
              f"(host enqueue {statistics.median(enq):.3f} ms) [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            vgs["psum"](thetas)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 10
    fn_us = sum(e.self_cpu_time_total for e in prof.key_averages()
                if e.key == "_SummedLoglik") / 10
    print(f"psum under torch.profiler: device time {device_us / 1e3:.3f} ms a call; the "
          f"autograd.Function's own host time {fn_us / 1e3:.3f} ms a call [{card}]")

    from hamiltorch_tpu_torch import MCMCConfig, run_hmc_chains

    cfg = MCMCConfig(num_samples=2, num_steps_per_sample=50, step_size=2e-4)
    walls = {name: [] for name in designs}
    for _ in range(3):
        for name, fn in designs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_hmc_chains(1, fn, theta0, cfg, 64)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / (2 * 50) * 1e3)
    for name, w in walls.items():
        print(f"{name} inside run_hmc_chains: {statistics.median(w):.3f} ms a gradient step of "
              f"64 chains (median of 3 runs of 2 x 50) [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_hmc_chains(1, psum, theta0, cfg, 64)
        torch.cuda.synchronize()
    calls = {}
    for e in prof.key_averages():
        if e.key.startswith("cuda") and not e.key.startswith("cudaLaunch"):
            calls[e.key] = (e.count, e.self_cpu_time_total / 1e3)
    print("psum inside run_hmc_chains, 2 draws: CUDA runtime calls (count, host ms) "
          + ", ".join(f"{k} {c} {t:.1f}" for k, (c, t) in sorted(calls.items(),
                                                                   key=lambda kv: -kv[1][1])))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
