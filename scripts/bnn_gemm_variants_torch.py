"""A/B probes of the BNN gradient's GEMM design on one GPU.

Builds ``hamiltorch_tpu_torch/kernels/csrc/bnn_grad.cu`` as it is and in a
few variants, each made by a stated text change of ``bnn_grad.cuh`` in a
copy of the sources (the checkout is not touched), and runs each through
``kernels/bnn_grad._bnn_gradient`` on the flagship (64 chains, N=1024,
I=784, H=128):

  - ``as_is``: the sources as they are;
  - ``one_warpgroup``: GEMM blocks of one warpgroup (64 A rows) instead of
    two sharing each B slice;
  - ``one_accumulator``: the two small 3xTF32 products accumulate into the
    big product's registers instead of their own;
  - ``no_split`` (timing only, wrong results): the forward skips the
    shared-memory split of its W1^T slices.

For each it prints the time of one gradient ((21 evaluations - 1) / 20 in
one call each, median of 3, variants in turns), the forward and backward
kernels' device times (``torch.profiler``), and the error against the
plain gradient in float64: max abs error over max |g|, and logp's relative
error.  Run from the root of a checkout on a CUDA card (sm_90a):

    python3 scripts/bnn_gemm_variants_torch.py
"""

from __future__ import annotations

import importlib
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import FLAGSHIP, bnn_inputs, card_line, cuda_ms, flat  # noqa: E402
from hamiltorch_tpu_torch.kernels import _build  # noqa: E402

bnn_grad = importlib.import_module("hamiltorch_tpu_torch.kernels.bnn_grad")

# name -> [(text in bnn_grad.cuh, replacement)], each text found exactly once
VARIANTS = {
    "as_is": [],
    "one_warpgroup": [
        ("constexpr int WGS = 2;", "constexpr int WGS = 1;"),
    ],
    "one_accumulator": [
        ("wgmma_n128(acc_s, a_big + 2 * kk, b_small + 2 * kk);",
         "wgmma_n128(acc, a_big + 2 * kk, b_small + 2 * kk);"),
        ("wgmma_n128(acc_s, a_small + 2 * kk, b_big + 2 * kk);",
         "wgmma_n128(acc, a_small + 2 * kk, b_big + 2 * kk);"),
        ("wgmma_n112(acc_s, a_big + 2 * kk, b_small + 2 * kk);",
         "wgmma_n112(acc, a_big + 2 * kk, b_small + 2 * kk);"),
        ("wgmma_n112(acc_s, a_small + 2 * kk, b_big + 2 * kk);",
         "wgmma_n112(acc, a_small + 2 * kk, b_big + 2 * kk);"),
    ],
    "no_split": [
        ("for (int e = 0; e < FWD_B_TILE / 16 / NT; ++e) {", "for (int e = 0; e < 0; ++e) {"),
    ],
}


def make_sources(root: Path, name: str) -> Path:
    """A copy of csrc/ with the variant's changes applied."""
    src = root / name
    shutil.copytree(_build.CSRC, src)
    header = src / "bnn_grad.cuh"
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    header.write_text(text)
    return src


def use(csrc: Path, build: Path) -> None:
    """Point the build (and the wrapper's library) at these sources."""
    _build.CSRC, _build.BUILD_DIR = csrc, build
    _build.load.cache_clear()
    bnn_grad._library.cache_clear()


def device_us(x, y, theta) -> dict:
    """Device time per call (us) of the forward and backward GEMM kernels."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bnn_grad._bnn_gradient(x, y, theta, repeats=10)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for kernel in ("forward_kernel", "backward_kernel"):
            if kernel in e.key and e.count:
                out[kernel] = e.device_time_total / e.count
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(card)
    x, y, *parts = bnn_inputs(torch, **FLAGSHIP, seed=5, device=device)
    theta = flat(torch, parts).contiguous()
    want_g, want_logp = bnn_grad._bnn_gradient_reference(x.double(), y.double(), theta.double())
    csrc, build = _build.CSRC, _build.BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:  # inside the git-ignored build/
        root = Path(tmp)
        dirs = {name: make_sources(root, name) for name in VARIANTS}
        for name, src in dirs.items():  # build every variant first
            use(src, src / "build")
            _build.build_all(["bnn_grad"])
        times = {name: [] for name in VARIANTS}
        for rep in range(3):
            order = list(VARIANTS) if rep % 2 == 0 else list(VARIANTS)[::-1]
            for name in order:
                use(dirs[name], dirs[name] / "build")
                bnn_grad._bnn_gradient(x, y, theta)  # warm up: load, first call
                torch.cuda.synchronize()
                one = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=1))
                many = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=21))
                times[name].append((many - one) / 20)
        for name in VARIANTS:
            use(dirs[name], dirs[name] / "build")
            g, logp = bnn_grad._bnn_gradient(x, y, theta)
            err = float((g.double() - want_g).abs().max() / want_g.abs().max())
            lerr = float(((logp - want_logp) / want_logp).abs().max())
            us = device_us(x, y, theta)
            print(f"{name}: {statistics.median(times[name]):.4f} ms per gradient "
                  f"(runs {[round(t, 4) for t in times[name]]}); forward "
                  f"{us.get('forward_kernel', 0.0):.1f} us, backward "
                  f"{us.get('backward_kernel', 0.0):.1f} us; vs float64: max_abs_err / max|g| "
                  f"{err:.3e}, logp rel {lerr:.3e} [{card}]")
        use(csrc, build)
    g32, logp32 = bnn_grad._bnn_gradient_reference(x, y, theta)
    print(f"plain float32 (cuBLAS, TF32 off) vs float64: max_abs_err / max|g| "
          f"{float((g32.double() - want_g).abs().max() / want_g.abs().max()):.3e}, logp rel "
          f"{float(((logp32 - want_logp) / want_logp).abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
