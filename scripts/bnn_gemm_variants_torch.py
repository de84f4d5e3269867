"""A/B of the BNN gradient's design (csrc/bnn_grad.cuh) on one GPU.

Builds the package's three BNN sources (``bnn_grad.cu``, ``bnn_hmc.cu``,
``bnn_mclmc.cu``) in each design below and runs each through the package's
wrappers on the flagship (64 chains, N=1024, I=784, H=128).  A tried design
is a stated text change of ``scripts/csrc/bnn_grad_variants.cuh`` (the
package's header with the tried designs kept as switches; unchanged, it is
the package's design), written over ``bnn_grad.cuh`` in a copy of the
sources under the git-ignored ``build/`` (the checkout is not touched), or
another plan:

  - ``former``: the design before the GEMMs became persistent (commit
    1efd31b's ``bnn_grad.cuh``, kept as ``scripts/csrc/bnn_grad_former.cuh``; built
    through ``scripts/csrc/bnn_former_*.cu``, the package's sources on it);
  - ``as_is``: the package;
  - ``one_consumer``: one consumer warpgroup a block, on every tile of the
    block's walk (forward tiles of 64 rows), no setmaxnreg: a block's
    epilogues no longer overlap its products (no ping-pong; compare
    ``fwd_pingpong``);
  - ``no_rebalance``: two consumers, but no setmaxnreg (168 registers a
    thread for every warpgroup);
  - ``smem_split``: the A operand (W1^T, da^T) split per k-slice in shared
    memory by its consumer warpgroup behind a warpgroup barrier, then read
    split, instead of split in registers as each thread loads it (4 ring
    stages: a stage holds A's small part too; the forward as
    ``fwd_pingpong``'s, whose consumers own their tiles);
  - ``not_persistent``: the package's build on grids of a block a tile
    (backward: a tile a consumer warpgroup) instead of _plan's walk;
  - ``stages4``: rings of 2 stages a consumer instead of 3;
  - ``small_tiles``: ``fwd_pingpong`` with forward tiles of 32 rows of x, and
    backward tiles of 56 inputs (half the accumulators), rings of 4 stages;
  - ``three_consumers``: those tiles with three consumer warpgroups a block
    (152 registers a consumer thread), rings of 3;
  - ``fwd_pingpong``: the forward's consumers on tiles of their own (64
    rows of x, all hidden units, wgmma N = 64) with a ring each, so that
    one's epilogue overlaps the other's products, as in the backward;
  - ``serial_epilogue``: the backward's former epilogue, each (jj, r)
    step's loads of W1, p and u after the step before it stored (the
    package's epilogue reads a batch of 7 jj before its first store);
  - ``one_batch``, ``batches4``: the read-ahead epilogue in one batch of
    all 28 steps, or in 4 batches of 7;
  - ``pipe2``, ``pipe4``, ``pipe7``: 2, 4 or 7 batches, each batch's loads
    issued before the stores of the batch before it as well;
  - ``prefetch_p``, ``prefetch_p_w1``: the backward's producer thread asks
    L2 for the tile's rows of p (and of W1) as it starts the tile's loads
    (``cp.async.bulk.prefetch.L2``; only ``bnn_hmc`` passes p);
  - timing only, wrong results (``--anatomy``): ``no_loads`` (the producer
    issues no TMA; the consumers multiply whatever the ring holds) and
    ``no_split`` (A's fragments are not split: big = a, small = 0), and in
    the backward's epilogue ``epi_no_stores`` (g, p and W1 not stored) and
    ``epi_no_loads`` (W1, p and u not loaded).

For each it prints the registers, spills and shared memory of the GEMM
kernels (``-Xptxas -v``), the time of one gradient ((21 evaluations - 1) /
20 in one call each, median of 3, designs in turns), the forward and
backward kernels' device times (``torch.profiler``; without device events
it says so and the gradient's time stands alone), and the error against the
plain gradient in float64.  Then ``bnn_hmc`` (64 x 10 x 50 at step 2e-4)
and ``bnn_mclmc`` (64 x 500 at eps 2e-3, L 10) end to end in ``former`` and
``as_is``, in turns (former, as_is, as_is, former; medians of 3), or, with
``--against``, in each named design and ``as_is`` the same way.  Run from
the root of a checkout on a CUDA card (sm_90a):

    python3 scripts/bnn_gemm_variants_torch.py [--anatomy] [--only NAME ...] [--against NAME ...]
"""

from __future__ import annotations

import argparse
import importlib
import re
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import FLAGSHIP, bnn_inputs, card_line, cuda_ms, flat  # noqa: E402
from hamiltorch_tpu_torch.kernels import _build  # noqa: E402

bnn_grad = importlib.import_module("hamiltorch_tpu_torch.kernels.bnn_grad")
bnn_hmc = importlib.import_module("hamiltorch_tpu_torch.kernels.bnn_hmc")
bnn_mclmc = importlib.import_module("hamiltorch_tpu_torch.kernels.bnn_mclmc")

SOURCES = ("bnn_grad", "bnn_hmc", "bnn_mclmc")
FORMER = {name: REPO / "scripts" / "csrc" / f"bnn_former_{name[4:]}.cu" for name in SOURCES}
VARIANTS = REPO / "scripts" / "csrc" / "bnn_grad_variants.cuh"
# name -> [(text in VARIANTS, replacement[, times it is found])], each text
# found exactly once unless a count is given
EDITS = {
    "one_consumer": [("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 1;"),
                     ("constexpr bool REBALANCE = true;", "constexpr bool REBALANCE = false;"),
                     ("constexpr bool FWD_PINGPONG = false;", "constexpr bool FWD_PINGPONG = true;")],
    "no_rebalance": [("constexpr bool REBALANCE = true;", "constexpr bool REBALANCE = false;")],
    "smem_split": [("constexpr bool SMEM_SPLIT = false;", "constexpr bool SMEM_SPLIT = true;"),
                   ("constexpr int STAGES = 6;", "constexpr int STAGES = 4;"),
                   ("constexpr bool FWD_PINGPONG = false;", "constexpr bool FWD_PINGPONG = true;")],
    "no_loads": [("mbar_expect_tx(bar, a_tile<FWD_MB>() + 2 * B_TILE);",
                  "mbar_arrive(bar);\n          continue;", 2),
                 ("mbar_expect_tx(bar, a_tile<BWD_MB>() + 2 * B_TILE);",
                  "mbar_arrive(bar);\n        continue;")],
    "stages4": [("constexpr int STAGES = 6;", "constexpr int STAGES = 4;")],
    "small_tiles": [("constexpr bool FWD_PINGPONG = false;", "constexpr bool FWD_PINGPONG = true;"),
                    ("constexpr int FN = 64;", "constexpr int FN = 32;"),
                    ("constexpr int BNB = 112;", "constexpr int BNB = 56;"),
                    ("constexpr int STAGES = 6;", "constexpr int STAGES = 8;")],
    "fwd_pingpong": [("constexpr bool FWD_PINGPONG = false;", "constexpr bool FWD_PINGPONG = true;")],
    "three_consumers": [("constexpr bool FWD_PINGPONG = false;",
                         "constexpr bool FWD_PINGPONG = true;"),
                        ("constexpr int FN = 64;", "constexpr int FN = 32;"),
                        ("constexpr int BNB = 112;", "constexpr int BNB = 56;"),
                        ("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 3;"),
                        ("constexpr int STAGES = 6;", "constexpr int STAGES = 9;")],
    "no_split": [("tf32_split_alu(a[at[e]], big[e], small[e]);",
                  "big[e] = __float_as_uint(a[at[e]]);\n      small[e] = 0u;")],
    "serial_epilogue": [("constexpr bool READ_AHEAD = true;", "constexpr bool READ_AHEAD = false;")],
    "one_batch": [("constexpr int BWD_BATCHES = 2;", "constexpr int BWD_BATCHES = 1;")],
    "batches4": [("constexpr int BWD_BATCHES = 2;", "constexpr int BWD_BATCHES = 4;")],
    "pipe2": [("constexpr bool PIPELINE = false;", "constexpr bool PIPELINE = true;")],
    "pipe4": [("constexpr int BWD_BATCHES = 2;", "constexpr int BWD_BATCHES = 4;"),
              ("constexpr bool PIPELINE = false;", "constexpr bool PIPELINE = true;")],
    "pipe7": [("constexpr int BWD_BATCHES = 2;", "constexpr int BWD_BATCHES = 7;"),
              ("constexpr bool PIPELINE = false;", "constexpr bool PIPELINE = true;")],
    "epi_no_stores": [("constexpr int EPI_ANATOMY = 0;", "constexpr int EPI_ANATOMY = 1;")],
    "epi_no_loads": [("constexpr int EPI_ANATOMY = 0;", "constexpr int EPI_ANATOMY = 2;")],
    "prefetch_p": [("constexpr int PREFETCH_L2 = 0;", "constexpr int PREFETCH_L2 = 1;")],
    "prefetch_p_w1": [("constexpr int PREFETCH_L2 = 0;", "constexpr int PREFETCH_L2 = 2;")],
}
ANATOMY = ("no_loads", "no_split", "epi_no_stores", "epi_no_loads")
DESIGNS = ("former", "as_is", "one_consumer", "no_rebalance", "smem_split", "not_persistent",
           "stages4", "small_tiles", "three_consumers", "fwd_pingpong", "serial_epilogue",
           "one_batch", "batches4", "pipe2", "pipe4", "pipe7", "prefetch_p", "prefetch_p_w1")
# designs whose tiles differ from the package's: the plan's constants for them
PLANS = {"fwd_pingpong": dict(FWD_ROWS=64), "smem_split": dict(FWD_ROWS=64),
         "one_consumer": dict(FWD_ROWS=64, CONSUMERS=1),
         "small_tiles": dict(FWD_ROWS=32, BWD_INPUTS=56),
         "three_consumers": dict(FWD_ROWS=32, BWD_INPUTS=56, CONSUMERS=3)}


def make_sources(root: Path, name: str) -> Path:
    """A copy of csrc/ whose bnn_grad.cuh is VARIANTS with the design's changes."""
    src = root / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("build"))
    text = VARIANTS.read_text()
    for old, new, *count in EDITS[name]:
        if text.count(old) != (count or [1])[0]:
            raise RuntimeError(f"design {name}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    (src / "bnn_grad.cuh").write_text(text)
    return src


def not_persistent_grids(n, i_dim, hidden, chains, device):
    """A block a forward tile (its consumers share it) and a block a pair of
    backward tiles (one a consumer)."""
    plan = bnn_grad._plan(n, i_dim, hidden, chains, 1 << 30)
    return plan.fwd_tiles, -(-plan.bwd_tiles // bnn_grad.CONSUMERS)


class Designs:
    """Switches the package's wrappers between the designs' libraries."""

    def __init__(self, names, root: Path):
        self.load, self.grids = _build.load, bnn_grad._grids
        self.plan = {k: getattr(bnn_grad, k) for k in ("FWD_ROWS", "BWD_INPUTS", "CONSUMERS")}
        self.sources = {}
        for name in names:
            if name == "former":
                self.sources[name] = dict(FORMER)
            elif name in ("as_is", "not_persistent"):  # the package's own sources
                self.sources[name] = {}
            else:
                src = make_sources(root, name)
                self.sources[name] = {s: src / f"{s}.cu" for s in SOURCES}

    def build(self) -> dict:
        """Compiles every design's sources at once; {design: ptxas lines of the GEMMs}."""
        paths = [p for srcs in self.sources.values() for p in srcs.values()]
        logs = _build.build_all(list(SOURCES) + paths)
        out = {}
        for name, srcs in self.sources.items():
            log = logs.get(srcs.get("bnn_grad", "bnn_grad"), "")
            lines, kernel = [], None
            for line in log.splitlines():
                if "Compiling entry" in line:
                    m = re.search(r"(forward_\w*kernel|backward_kernelILb[01]E)", line)
                    kernel = m.group(1) if m else None
                elif kernel and ("registers" in line or "spill" in line):
                    lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
            out[name] = lines
        return out

    def use(self, name: str) -> None:
        srcs = self.sources[name]
        _build.load = lambda src: self.load(srcs.get(src, src))
        for mod in (bnn_grad, bnn_hmc, bnn_mclmc):
            mod._grids = not_persistent_grids if name == "not_persistent" else self.grids
        for key, value in {**self.plan, **PLANS.get(name, {})}.items():
            setattr(bnn_grad, key, value)
        for mod in (bnn_grad, bnn_hmc, bnn_mclmc):
            mod._library.cache_clear()

    def restore(self) -> None:
        _build.load = self.load
        for mod in (bnn_grad, bnn_hmc, bnn_mclmc):
            mod._grids = self.grids
        for key, value in self.plan.items():
            setattr(bnn_grad, key, value)
        for mod in (bnn_grad, bnn_hmc, bnn_mclmc):
            mod._library.cache_clear()


def device_us(fn) -> dict:
    """Device time per launch (us) of the forward and backward GEMM kernels in
    one call of fn, from torch.profiler; empty if it records no device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        m = re.search(r"(forward|backward|small)_\w*kernel", e.key)
        if m and e.count and dev:
            kernel = f"{m.group(1)}_kernel"
            out[kernel] = out.get(kernel, 0.0) + dev / e.count
    return out


def gradient_ms(x, y, theta) -> float:
    one = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=1))
    many = cuda_ms(torch, lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=21))
    return (many - one) / 20


def end_to_end(designs: Designs, card: str, base: str = "former") -> None:
    """bnn_hmc and bnn_mclmc at the flagship in base and as_is, in turns."""
    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=torch.device("cuda:0"))
    dim = FLAGSHIP["i"] * FLAGSHIP["h"] + 2 * FLAGSHIP["h"] + 1
    u = torch.randn(FLAGSHIP["c"], dim, generator=torch.Generator().manual_seed(8)).to(args[0].device)
    fns = {"bnn_hmc": lambda s: bnn_hmc.bnn_hmc(s, *args, num_samples=10, num_steps=50,
                                                step_size=2e-4, tau=10.0),
           "bnn_mclmc": lambda s: bnn_mclmc.bnn_mclmc(s, *args, u, num_samples=500, step_size=2e-3,
                                                      length=10.0, tau=10.0)}
    times = {(d, k): [] for d in (base, "as_is") for k in fns}
    for design in (base, "as_is", "as_is", base):
        designs.use(design)
        for name, fn in fns.items():
            fn(0)
            torch.cuda.synchronize()
            runs = [cuda_ms(torch, lambda: fn(r + 1)) for r in range(3)]
            times[(design, name)].append(statistics.median(runs))
    for design in (base, "as_is"):  # bnn_hmc's kernels, p read and written in the backward
        designs.use(design)
        us = device_us(lambda: fns["bnn_hmc"](9))
        if "backward_kernel" in us:
            print(f"bnn_hmc flagship, {design}: forward {us['forward_kernel']:.1f} us, backward "
                  f"{us['backward_kernel']:.1f} us, per-chain {us.get('small_kernel', 0.0):.1f} us "
                  f"a launch [{card}]")
    for name in fns:
        f, a = times[(base, name)], times[("as_is", name)]
        print(f"{name} flagship: {base} {f[0]:.3f} / {f[1]:.3f} ms, as_is {a[0]:.3f} / {a[1]:.3f} "
              f"ms ({base}, as_is, as_is, {base}; medians of 3): as_is / {base} "
              f"{sum(a) / sum(f):.4f} [{card}]")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--anatomy", action="store_true", help="also the timing-only ablations")
    parser.add_argument("--only", nargs="*", help="these designs alone (and no end-to-end runs)")
    parser.add_argument("--against", nargs="*", default=[],
                        help="end-to-end runs of these designs against as_is")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    print(card)
    names = list(opts.only or DESIGNS) + (list(ANATOMY) if opts.anatomy else [])
    names += [name for name in ["as_is", *opts.against] if name not in names]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    designs = Designs(names, _build.BUILD_DIR / "gemm_variants")
    t0 = time.perf_counter()
    ptxas = designs.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    x, y, *parts = bnn_inputs(torch, **FLAGSHIP, seed=5, device=device)
    theta = flat(torch, parts).contiguous()
    want_g, want_logp = bnn_grad._bnn_gradient_reference(x.double(), y.double(), theta.double())
    times = {name: [] for name in names}
    for name in list(names):  # a design whose launch the card refuses is reported and left out
        designs.use(name)
        try:
            bnn_grad._bnn_gradient(x, y, theta)  # warm up: load, first call
            torch.cuda.synchronize()
        except RuntimeError as err:
            print(f"{name}: refused: {err} [{card}]")
            names.remove(name)
    for rep in range(3):
        for name in (names if rep % 2 == 0 else names[::-1]):
            designs.use(name)
            times[name].append(gradient_ms(x, y, theta))
    for name in names:
        designs.use(name)
        g, logp = bnn_grad._bnn_gradient(x, y, theta)
        err = float((g.double() - want_g).abs().max() / want_g.abs().max())
        lerr = float(((logp - want_logp) / want_logp).abs().max())
        us = device_us(lambda: bnn_grad._bnn_gradient(x, y, theta, repeats=10))
        kernels = (f"forward {us['forward_kernel']:.1f} us, backward {us['backward_kernel']:.1f} us, "
                   f"per-chain {us.get('small_kernel', 0.0):.1f} us" if "forward_kernel" in us
                   else "no device events recorded: kernel times not measured")
        print(f"{name}: {statistics.median(times[name]):.4f} ms per gradient (runs "
              f"{[round(t, 4) for t in times[name]]}); {kernels}; vs float64: max_abs_err / max|g| "
              f"{err:.3e}, logp rel {lerr:.3e}{' (timing only)' if name in ANATOMY else ''} [{card}]")
        for line in ptxas[name]:
            print(f"  {line}")
    if not opts.only:
        end_to_end(designs, card)
    for base in opts.against:
        end_to_end(designs, card, base)
    designs.restore()
    g32, logp32 = bnn_grad._bnn_gradient_reference(x, y, theta)
    print(f"plain float32 (cuBLAS, TF32 off) vs float64: max_abs_err / max|g| "
          f"{float((g32.double() - want_g).abs().max() / want_g.abs().max()):.3e}, logp rel "
          f"{float(((logp32 - want_logp) / want_logp).abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
