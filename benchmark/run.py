"""Run one cell of the benchmark of hamiltorch_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.
With --trace 0 the metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a torch.profiler trace of the
window kept in memory.  Exits with a code other than 0, and prints no
result, without a CUDA card (or with fewer than the cell asks for), when
the port is not in the checkout, or when a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    cell = core.Cell.find(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if args.trace:  # the rooflines are against the data sheet's 700 W peaks
        try:
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            card = "nvidia-smi gave nothing"
        print(f"card and power limit: {card}", file=sys.stderr)
    result = core.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                      started=STARTED)
    found = core.banned_modules()
    if found:
        print(f"modules the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
