"""Where a ResNet-20-FRN full-batch gradient spends its time, by convolution, on one GPU.

The network and sizes of the ``resnet20_frn.hmc_c1`` cell: 50,000 rows of
3x32x32 images in blocks of 10,000, float32 with cuDNN's and cuBLAS's TF32
off (``utils.precision.full_float32``, as the potential runs).  Two readings:

1. Every distinct convolution of the network, alone, at a block's 10,000
   rows, in each direction a gradient runs it: forward, input gradient (not
   the stem's: its input is the data) and weight-and-bias gradient.  An
   ``nn.Conv2d`` runs through cuDNN (``aten.convolution`` and
   ``aten.convolution_backward`` with one output mask a direction), with
   ``torch.backends.cudnn.benchmark`` off (as the potential runs) and on; a
   ``Conv3x3`` runs through its kernels (``kernels/conv3x3.py``).  CUDA
   events around REPS calls, median of 3 runs, after one warm-up.  A
   gradient's share: that time x the convolution's count in the network x
   the 5 blocks.
2. One gradient of the blocked potential (``define_model_log_prob(...,
   block_rows=10000)``, ``torch.func.grad``): the host's time to return from
   the call and to the card's end of it, profiler off, median of 3 (the
   prior's blocking copies make the host wait for the card); the host's
   time inside the likelihood (the recorder's span ``potential``: the five
   blocks' forward and backward queued) and ``conv3x3.launches``, with the
   recorder on and the profiler off, median of 3; then
   under ``torch.profiler``: the device time of the convolution kernels (the
   name pattern of ``benchmark/metrics/conv_roofline_pct.resnet20.py``) and
   of the rest, and the top kernels.

Run from the root of a checkout on a CUDA card:

    python3 scripts/resnet20_conv_split_torch.py [--out conv_split.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ROWS, BLOCKS, REPS = 10_000, 5, 5
CONV_NAMES = re.compile(r"(?i)conv|gemm|xmma|cudnn|cutlass|winograd|fft|wgrad|dgrad|fprop|"
                        r"flip_filter|nchwtonhwc|nhwctonchw|splitkreduce")


def cuda_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(torch, lambda: [fn() for _ in range(REPS)])
                             for _ in range(3)) / REPS


def convolutions(torch, model):
    """[(module, input shape of one image, count in the network)], one entry
    a distinct (kind, channels, kernel, stride, side), in network order."""
    from torch import nn

    seen, order = {}, []

    def hook(module, args):
        w = module.weight
        key = (type(module).__name__, tuple(w.shape), getattr(module, "stride", (1, 1)),
               tuple(args[0].shape[1:]))
        if key not in seen:
            seen[key] = [module, tuple(args[0].shape[1:]), 0, module is model[0]]
            order.append(key)
        seen[key][2] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d) or type(m).__name__ == "Conv3x3"]
    with torch.no_grad():
        model(torch.zeros((1, 3, 32, 32), device=model[0].weight.device))
    for h in handles:
        h.remove()
    return [seen[k] for k in order]


def directions(torch, module, x, dy, benchmark: bool):
    """{direction: fn} of one convolution at input x and output gradient dy."""
    from torch import nn

    w, b = module.weight.detach(), module.bias.detach()
    if type(module) is not nn.Conv2d:
        from hamiltorch_tpu_torch.kernels import conv3x3 as cv

        return {"forward": lambda: cv._forward_cuda(x, w, b),
                "input_grad": lambda: cv._dgrad_cuda(dy, w),
                "weight_grad": lambda: cv._wgrad_cuda(dy, x)}
    conv_bwd = torch.ops.aten.convolution_backward
    args = (list(module.stride), list(module.padding), list(module.dilation), False, [0, 0], 1)

    def on(fn):
        def run():
            torch.backends.cudnn.benchmark = benchmark
            return fn()
        return run

    return {"forward": on(lambda: torch.ops.aten.convolution(x, w, b, *args)),
            "input_grad": on(lambda: conv_bwd(dy, x, w, [w.shape[0]], *args, [True, False, False])),
            "weight_grad": on(lambda: conv_bwd(dy, x, w, [w.shape[0]], *args, [False, True, True]))}


def conv_split(torch, model) -> list:
    from hamiltorch_tpu_torch.utils.precision import full_float32

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for module, shape, count, stem in convolutions(torch, model):
        x = torch.randn((ROWS, *shape), generator=gen, device="cuda")
        with torch.no_grad():
            dy = torch.randn_like(module(x[:1]).expand(ROWS, -1, -1, -1).contiguous())
        row = {"kind": type(module).__name__, "weight": list(module.weight.shape),
               "stride": list(getattr(module, "stride", (1, 1))), "input": list(shape),
               "count": count, "ms": {}, "ms_cudnn_benchmark": {}}
        with full_float32():
            for bench, key in ((False, "ms"), (True, "ms_cudnn_benchmark")):
                if key == "ms_cudnn_benchmark" and row["kind"] != "Conv2d":
                    continue
                for name, fn in directions(torch, module, x, dy, bench).items():
                    if not (stem and name == "input_grad"):
                        row[key][name] = median_ms(torch, fn)
        torch.backends.cudnn.benchmark = False
        row["gradient_ms"] = sum(row["ms"].values()) * count * BLOCKS
        rows.append(row)
        print(f"{row['kind']:>7} w{tuple(row['weight'])} stride {row['stride'][0]} in "
              f"{tuple(shape)} x{count}: " + ", ".join(f"{k} {v:.3f}" for k, v in row["ms"].items())
              + " ms a block" + ("; cudnn.benchmark on: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in row["ms_cudnn_benchmark"].items())
                  if row["ms_cudnn_benchmark"] else "")
              + f"; {row['gradient_ms']:.1f} ms a gradient", flush=True)
        del x, dy
    return rows


def gradient(torch, model) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob
    from hamiltorch_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((ROWS * BLOCKS, 3, 32, 32), generator=gen, device="cuda")
    y = torch.randint(0, 10, (ROWS * BLOCKS,), generator=gen, device="cuda")
    lp, init, _ = define_model_log_prob(model, "multi_class_linear_output", x, y, tau_list=5.0,
                                        device=x.device, block_rows=ROWS)
    theta = init + 0.01 * torch.randn(init.shape, generator=gen, device="cuda")
    grad = torch.func.grad(lp)
    for _ in range(2):
        grad(theta)
    torch.cuda.synchronize()
    returned, finished = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        grad(theta)
        returned.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        finished.append(time.perf_counter() - t0)
    profiling.reset()
    with profiling.recording():
        for _ in range(3):
            grad(theta)
            torch.cuda.synchronize()
    enqueue = statistics.median((sp.end_ns - sp.start_ns) / 1e9 for sp in profiling.spans()
                                if sp.name == "potential")
    launches = profiling.counters().get("conv3x3.launches", 0) / 3
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad(theta)
        torch.cuda.synchronize()
    by_kernel, ops = collections.Counter(), 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        by_kernel[e.key] += dev / 1e6
        ops += e.count
    conv = sum(v for k, v in by_kernel.items() if CONV_NAMES.search(k))
    out = {"host_return_s": statistics.median(returned), "host_finish_s": statistics.median(finished),
           "likelihood_enqueue_s": enqueue, "conv3x3_launches": launches,
           "device_s": sum(by_kernel.values()), "conv_device_s": conv, "device_ops": ops,
           "top": [[k[:90], v] for k, v in by_kernel.most_common(15)]}
    print(f"one gradient (50,000 rows, 5 blocks): host returns after {out['host_return_s']:.4f} s, "
          f"the card ends at {out['host_finish_s']:.4f} s (profiler off, median of 3); the "
          f"likelihood's enqueue {enqueue:.4f} s, {launches:g} conv3x3 launches (recorder on); traced: "
          f"device {out['device_s']:.4f} s in {ops} operations, convolutions {conv:.4f} s")
    for k, v in out["top"]:
        print(f"  {v:.4f} s  {k}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hamiltorch_tpu_torch.models import resnet20_frn_swish

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    model = resnet20_frn_swish().cuda()
    rows = conv_split(torch, model)
    total = sum(r["gradient_ms"] for r in rows)
    print(f"all convolutions, each alone: {total:.1f} ms a gradient")
    result = {"card": card, "torch": torch.__version__, "convolutions": rows,
              "convolutions_gradient_ms": total, "gradient": gradient(torch, model)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
