"""Where the time of the package's two tensor-core kernels goes, on one GPU.

Each ablation below is a text change applied to a copy of the package's own
``hamiltorch_tpu_torch/kernels/csrc/`` under the git-ignored
``kernels/build/anatomy/`` (the checkout is not touched).  The copy is built
as the package's sources are (``kernels/_build.build_all``) and timed
through the package's own wrapper, whose ``_build.load`` is pointed at the
copy's library.  An ablated kernel computes wrong results: only its time is
read.  Each text must be found in the package's source exactly the stated
number of times, or this raises (``tests/test_torch_anatomy.py`` checks that
on the CPU, so an edit of the kernels that breaks an ablation fails there).

  - The BNN gradient (``csrc/bnn_grad.cuh``) at the flagship (64 chains,
    N=1024, I=784, H=128): ``bnn.no_loads``, the producers issue no TMA
    (the consumers multiply whatever the rings hold), and ``bnn.no_split``,
    A's fragments are not split into tf32 parts (big = a, small = 0).
    Printed: the time of one gradient ((21 evaluations - 1) / 20 in one call
    each, median of 3, the builds in turns) and the forward, backward and
    per-chain kernels' device time a launch (``torch.profiler``; without
    device events it says so).
  - The dense Gaussian kernel (``dense_grid_kernel`` of
    ``csrc/gaussian_hmc.cuh``) at dense D=1024 with 1024 and 128 chains, the
    chain tile forced to 64, 32, 16 and 8 through the C entry and a ``Plan``
    (the plan's own choice marked): ``dense.no_loads``, each product's chunks
    after the first DT_STAGES - 1 not copied in (it computes on stale
    stages), and ``dense.no_mma``, the three ``mma.sync`` of each tile
    replaced by an integer mix of the same split operands.  Printed: a
    step's time, (t(L=12) - t(L=6)) / 6 over 20 draws, each a median of 3.

Run from the root of a checkout on a CUDA card (sm_90a):

    python3 scripts/kernel_anatomy_torch.py
"""

from __future__ import annotations

import importlib
import re
import shutil
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from hamiltorch_tpu_torch.kernels import _build  # noqa: E402

# name -> (source it builds, header under csrc/ it changes,
#          [(text, its stand-in, times the text is found)])
ABLATIONS = {
    "bnn.no_loads": ("bnn_grad", "bnn_grad.cuh", [
        ("mbar_expect_tx(bar, a_tile<FWD_MB>() + 2 * B_TILE);",
         "mbar_arrive(bar);\n          continue;", 1),
        ("mbar_expect_tx(bar, a_tile<BWD_MB>() + 2 * B_TILE);",
         "mbar_arrive(bar);\n        continue;", 1),
    ]),
    "bnn.no_split": ("bnn_grad", "bnn_grad.cuh", [
        ("tf32_split_alu(a[at[e]], big[e], small[e]);",
         "big[e] = __float_as_uint(a[at[e]]), small[e] = 0u;", 1),
    ]),
    "dense.no_loads": ("gaussian_hmc", "gaussian_hmc.cuh", [
        ("    if (kc + DT_STAGES - 1 < nkc) load(kc + DT_STAGES - 1);\n", "\n", 1),
    ]),
    "dense.no_mma": ("gaussian_hmc", "gaussian_hmc.cuh", [
        ("""          mma_tf32(acc_b[mi][ni], a_big[mi], b_big[ni][0], b_big[ni][1]);
          mma_tf32(acc_s[mi][ni], a_big[mi], b_small[ni][0], b_small[ni][1]);
          mma_tf32(acc_s[mi][ni], a_small[mi], b_big[ni][0], b_big[ni][1]);
""", """          acc_b[mi][ni][0] += __uint_as_float(
              (a_big[mi][0] ^ a_big[mi][1] ^ a_big[mi][2] ^ a_big[mi][3] ^ b_big[ni][0] ^
               b_big[ni][1]) & 0x3f800000u);
          acc_s[mi][ni][0] += __uint_as_float(
              (a_small[mi][0] ^ a_small[mi][1] ^ a_small[mi][2] ^ a_small[mi][3] ^
               b_small[ni][0] ^ b_small[ni][1]) & 0x3f800000u);
""", 1),
    ]),
}
ROOT = _build.BUILD_DIR / "anatomy"
LOAD = _build.load  # the package's own loader


def ablated_text(name: str) -> str:
    """The header of ablation ``name`` as the package's source with its
    texts replaced; raises if a text is found any other number of times."""
    _, header, edits = ABLATIONS[name]
    text = (_build.CSRC / header).read_text()
    for old, new, times in edits:
        if text.count(old) != times:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times in "
                               f"csrc/{header}, not {times}")
        text = text.replace(old, new)
    return text


def write_sources(name: str) -> Path:
    """A copy of csrc/ under ROOT with ablation ``name`` applied; its source's path."""
    source, header, _ = ABLATIONS[name]
    out = ROOT / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    (out / header).write_text(ablated_text(name))
    return out / f"{source}.cu"


def use(name: str, *wrappers) -> None:
    """Points the wrappers at the library of ablation ``name`` ("as_is": the package's)."""
    if name == "as_is":
        _build.load = LOAD
    else:
        _build.load = lambda source: LOAD(ROOT / name / f"{source}.cu")
    for mod in wrappers:
        mod._library.cache_clear()


def device_us(torch, fn) -> dict:
    """Device time a launch (us) of the BNN gradient's kernels in one call of
    fn, from torch.profiler; empty if it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        m = re.search(r"(forward|backward|small)_\w*kernel", e.key)
        if m and e.count and dev:
            out[m.group(1)] = out.get(m.group(1), 0.0) + dev / e.count
    return out


def bnn_anatomy(torch, card: str) -> None:
    from chip_smoke import FLAGSHIP, bnn_inputs, cuda_ms, flat

    bnn_grad = importlib.import_module("hamiltorch_tpu_torch.kernels.bnn_grad")
    x, y, *parts = bnn_inputs(torch, **FLAGSHIP, seed=5, device=torch.device("cuda:0"))
    theta = flat(torch, parts).contiguous()
    names = ["as_is"] + [k for k in ABLATIONS if k.startswith("bnn.")]

    def gradient_ms() -> float:
        one = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=1))
        many = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=21))
        return (many - one) / 20

    times = {name: [] for name in names}
    for name in names:  # warm up: load, first call
        use(name, bnn_grad)
        bnn_grad._bnn_gradient(x, y, theta)
        torch.cuda.synchronize()
    for rep in range(3):
        for name in (names if rep % 2 == 0 else names[::-1]):
            use(name, bnn_grad)
            times[name].append(gradient_ms())
    for name in names:
        use(name, bnn_grad)
        us = device_us(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=10))
        kernels = (", ".join(f"{k} {us.get(k, 0.0):.1f} us" for k in ("forward", "backward", "small"))
                   if "forward" in us else "no device events recorded: kernel times not measured")
        print(f"BNN gradient, flagship, {name}: {statistics.median(times[name]):.4f} ms (runs "
              f"{[round(t, 4) for t in times[name]]}); a launch: {kernels} [{card}]", flush=True)
    use("as_is", bnn_grad)


def dense_anatomy(torch, card: str) -> None:
    from chip_smoke import cuda_ms, dense_precision

    gaussian_hmc = importlib.import_module("hamiltorch_tpu_torch.kernels.gaussian_hmc")
    device, draws = torch.device("cuda:0"), 20
    libs = {}
    for name in ["as_is"] + [k for k in ABLATIONS if k.startswith("dense.")]:
        use(name, gaussian_hmc)
        libs[name] = gaussian_hmc._library()
    use("as_is", gaussian_hmc)

    def per_step(lib, theta0, prec, plan) -> float:
        c, d = theta0.shape
        out = torch.empty((c, draws, d), device=device)
        acc = torch.empty((c,), device=device)
        nbytes = lib.gaussian_hmc_scratch_bytes(c, d, 1, plan.variant, plan.group)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)

        def run(steps):
            err = lib.gaussian_hmc_run(
                theta0.data_ptr(), prec.data_ptr(), None, out.data_ptr(), acc.data_ptr(), c, d, 1,
                draws, steps, 0.2, 3, *plan, None, None, scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream, None, None)
            if err != 0:
                raise RuntimeError(f"{plan}: cudaError_t {err}")

        t = {}
        for steps in (6, 12):
            run(steps)
            t[steps] = statistics.median(cuda_ms(torch, lambda: run(steps)) for _ in range(3))
        return (t[12] - t[6]) / 6 / draws * 1e3  # us

    for d, chains in ((1024, 1024), (1024, 128)):
        prec = dense_precision(torch, d, 1).to(device)
        theta0 = torch.zeros(chains, d, device=device)
        chosen = gaussian_hmc._plan(d, True, 8, chains).group
        for tile in gaussian_hmc.DENSE_CHAIN_TILES:
            plan = gaussian_hmc.Plan(5, tile, 8, 0, gaussian_hmc._dense_shared(tile))
            us = {name: per_step(lib, theta0, prec, plan) for name, lib in libs.items()}
            tiles = -(-d // 128) * -(-chains // tile)
            print(f"dense D={d} {chains} chains, tiles of {tile} chains ({tiles} tiles"
                  f"{', the plan' if tile == chosen else ''}): a step "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()) + f" [{card}]", flush=True)


def main() -> int:
    import torch

    from chip_smoke import card_line

    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.build_all(["bnn_grad", "gaussian_hmc"] + [write_sources(name) for name in ABLATIONS])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    bnn_anatomy(torch, card)
    dense_anatomy(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
