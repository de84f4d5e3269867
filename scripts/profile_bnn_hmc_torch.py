"""Where the device time of the port's flagship samplers goes (one GPU).

Profiles, with ``torch.profiler``, 2 draws x 50 leapfrog steps over 64
chains of the flagship BNN (784 -> 128 -> 1 tanh, N = 1024, step 2e-4) on
three paths of ``hamiltorch_tpu_torch``:

  - ``kernel``: the fused CUDA sampler ``kernels.bnn_hmc``;
  - ``plain``: its plain PyTorch version ``bnn_hmc_reference`` (cuBLAS
    float32, TF32 off);
  - ``run_hmc_chains``: the unfused path on ``make_flagship_potential_tree``.

For each it prints the device time (the sum of the device kernels' own
times), the wall time of the profiled call, their ratio (the device's busy
share), and the ops and kernels with the most device time.  Each path runs
once unprofiled first, so the build and first-call costs stay out.

Run from the root of a checkout, on a CUDA card (the kernel is built for
sm_90a at first use):

    python3 scripts/profile_bnn_hmc_torch.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import FLAGSHIP, bnn_inputs, card_line  # noqa: E402
from hamiltorch_tpu_torch import MCMCConfig, run_hmc_chains  # noqa: E402
from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc, bnn_hmc_reference  # noqa: E402
from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree  # noqa: E402

DRAWS, STEPS, EPS = 2, 50, 2e-4


# the name of an event's own device time (older releases say "cuda")
SELF_DEVICE = "self_device_time_total"
if not hasattr(torch.autograd.profiler_util.FunctionEventAvg(), SELF_DEVICE):
    SELF_DEVICE = "self_cuda_time_total"


HMC_RUN = f"{DRAWS} draws x {STEPS} steps x {FLAGSHIP['c']} chains"


def profile_path(name: str, fn, what: str = HMC_RUN):
    """Profile one call of fn after a warm-up; prints and returns its
    ``key_averages()``."""
    fn()  # warm up: build, first-call allocations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(getattr(e, SELF_DEVICE) for e in kernels) / 1e3
    print(f"== {name}: device time {device_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"(busy {device_ms / wall_ms:.1%}) for {what}")
    print(events.table(sort_by=SELF_DEVICE, row_limit=12, max_name_column_width=60))
    return events


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    print(card_line())
    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    kw = dict(num_samples=DRAWS, num_steps=STEPS, step_size=EPS, tau=10.0)
    profile_path("kernel", lambda: bnn_hmc(0, *args, **kw))
    profile_path("plain", lambda: bnn_hmc_reference(0, *args, **kw))
    log_prob_fn, params0 = make_flagship_potential_tree(device=device)
    config = MCMCConfig(num_samples=DRAWS, num_steps_per_sample=STEPS, step_size=EPS)
    profile_path("run_hmc_chains",
                 lambda: run_hmc_chains(0, log_prob_fn, params0, config, num_chains=FLAGSHIP["c"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
