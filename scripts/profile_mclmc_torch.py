"""Where the device time of the port's flagship MCLMC samplers goes (one GPU).

Profiles, with ``torch.profiler``, 20 MCLMC draws (two gradients each) over
64 chains of the flagship BNN (784 -> 128 -> 1 tanh, N = 1024) at a fixed
(eps, L) = (2e-3, 10) on three paths of ``hamiltorch_tpu_torch``:

  - ``kernel``: the fused CUDA sampler ``kernels.bnn_mclmc``;
  - ``plain``: its plain PyTorch version ``bnn_mclmc_reference`` (cuBLAS
    float32, TF32 off);
  - ``run_mclmc_chains``: the unfused path on ``make_flagship_potential``
    with ``tune_steps=0`` (the frozen chunk of the MCLMC path).

For each it prints the device time, the wall time of the profiled call,
their ratio (the device's busy share) and the ops and kernels with the
most device time, as ``scripts/profile_bnn_hmc_torch.py`` does for HMC;
for the kernel also the velocity passes' share of the device time (every
kernel but the gradient's forward, backward and per-chain kernels and the
set-up: x staged, the state packed and unpacked).

    python3 scripts/profile_mclmc_torch.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from chip_smoke import FLAGSHIP, bnn_inputs, card_line  # noqa: E402
from hamiltorch_tpu_torch import MCLMCConfig, run_mclmc_chains  # noqa: E402
from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc, bnn_mclmc_reference  # noqa: E402
from hamiltorch_tpu_torch.models.flagship import make_flagship_potential  # noqa: E402
from profile_bnn_hmc_torch import SELF_DEVICE, profile_path  # noqa: E402

DRAWS, EPS, LENGTH = 20, 2e-3, 10.0
NOT_VELOCITY = ("forward_kernel", "backward_kernel", "small_kernel", "stage_x_kernel",
                "pack_kernel", "pack_flat_kernel", "unpack_kernel", "Memset", "Memcpy")


def velocity_share(name, events, card):
    """Print the share of the device time that the velocity passes take."""
    kernels = [e for e in events
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, SELF_DEVICE) for e in kernels)
    passes = sum(getattr(e, SELF_DEVICE) for e in kernels
                 if not any(k in e.key for k in NOT_VELOCITY))
    print(f"== {name}: velocity passes {passes / 1e3:.3f} ms of {total / 1e3:.3f} ms device "
          f"time ({passes / total:.1%}) [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(card)
    x, y, w1, b1, w2, b2 = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    u = torch.randn(FLAGSHIP["c"], w1[0].numel() + 2 * FLAGSHIP["h"] + 1, device=device)
    kw = dict(num_samples=DRAWS, step_size=EPS, length=LENGTH, tau=10.0)
    what = f"{DRAWS} draws x {FLAGSHIP['c']} chains"
    velocity_share("kernel", profile_path(
        "kernel", lambda: bnn_mclmc(0, x, y, w1, b1, w2, b2, u, **kw), what), card)
    profile_path("plain", lambda: bnn_mclmc_reference(0, x, y, w1, b1, w2, b2, u, **kw), what)
    log_prob_fn, theta0 = make_flagship_potential(device=device)
    config = MCLMCConfig(num_samples=DRAWS, tune_steps=0, step_size=EPS, trajectory_length=LENGTH)
    profile_path("run_mclmc_chains",
                 lambda: run_mclmc_chains(0, log_prob_fn, theta0, config, FLAGSHIP["c"]), what)
    return 0


if __name__ == "__main__":
    sys.exit(main())
