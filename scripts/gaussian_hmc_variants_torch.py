"""A/B probes of ``gaussian_hmc``'s kernel design on one GPU.

Times the package's kernel beside designs that were tried or replaced.
Those are not in the package's library: this script builds them for itself
from ``scripts/csrc/gaussian_hmc_variants.cu``, which instantiates the
package's kernel templates (``csrc/gaussian_hmc.cuh``) in ways the wrapper's
plan never chooses.  At the two shapes ``PERF.md`` quotes (diagonal D=3, 1024
chains x 1000 draws; dense D=128, 1024 chains x 200 draws) and at D=3 with
65,536 chains x 100 draws:

  - ``as_is``: the package's ``gaussian_hmc`` (D=3: 4 lanes per chain, 3
    producer warps filling the noise ring; D=128: 16-chain blocks on the
    tensor cores);
  - ``warp_per_chain``: the former design, one warp per chain with the noise
    drawn inline and a dense P multiplied by float32 FMAs from shared memory
    (it keeps the new single reduction per draw and the new noise stream);
  - D=3 only: ``thread_per_chain``, the whole chain in one thread's registers,
    with the ring; ``thread_inline``, a thread per chain with Philox,
    Box-Muller and log on the chain's own instruction stream (no ring);
    ``thread_ring_1`` / ``thread_ring_7``, a thread per chain with 1 or 7
    producer warps instead of 3.

Each is timed at L = 1, 6 and 12 leapfrog steps (CUDA events, median of 3,
variants in turns) and a draw's time is split into a per-step part,
(t(12) - t(6)) / 6, and a per-draw part, t(6) less six steps (at L = 1 the
producer warps, not the chains, may set the time).  Every variant's
draws must equal ``as_is`` bit for bit on the diagonal shapes (the stream is
keyed on the logical element) and, in the first 5 draws, within 1e-5 on the
dense one.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked with
``git archive`` into the git-ignored ``build/``) it also times that
checkout's kernel at the two quoted shapes, in a process of its own each
time, in the order parent, this, this, parent.  Run from the root of a
checkout on a CUDA card (sm_90a):

    python3 scripts/gaussian_hmc_variants_torch.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent

# (name, D, dense, chains, draws, L) of the shapes PERF.md quotes
QUOTED = (("diagonal D=3", 3, False, 1024, 1000, 6), ("dense D=128", 128, True, 1024, 200, 10))


def time_quoted(root: Path) -> dict:
    """Median-of-3 kernel times (ms) of the checkout at root, by shape name."""
    sys.path.insert(0, str(root))
    from chip_smoke import cuda_ms, dense_precision
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc

    device, out = torch.device("cuda:0"), {}
    for name, d, dense, chains, draws, steps in QUOTED:
        prec = (dense_precision(torch, d, 1) if dense else torch.linspace(0.25, 4.0, d)).to(device)
        theta0 = torch.zeros(chains, d, device=device)
        gaussian_hmc(0, theta0, prec, draws, steps, 0.2)
        torch.cuda.synchronize()
        runs = [cuda_ms(torch, lambda: gaussian_hmc(r + 1, theta0, prec, draws, steps, 0.2))
                for r in range(3)]
        out[name] = (statistics.median(runs), runs)
    return out


def against_parent(parent: Path, card: str) -> None:
    results = []
    for root in (parent, REPO, REPO, parent):
        done = subprocess.run([sys.executable, __file__, "--time-root", str(root)],
                              capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{done.stdout}\n{done.stderr}")
        results.append(json.loads(done.stdout.strip().splitlines()[-1]))
    for name, *_ in QUOTED:
        ms = [r[name][0] for r in results]
        print(f"{name}: parent {ms[0]:.3f} and {ms[3]:.3f} ms, this checkout {ms[1]:.3f} and "
              f"{ms[2]:.3f} ms (each a median of 3 in its own process) [{card}]")


@functools.lru_cache(maxsize=None)
def _variants_library():
    from hamiltorch_tpu_torch.kernels._build import load

    lib = load(REPO / "scripts" / "csrc" / "gaussian_hmc_variants.cu")
    lib.gaussian_hmc_variant_run.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_ulonglong]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.gaussian_hmc_variant_run.restype = ctypes.c_int
    return lib


def run_design(design, seed, theta0, prec, draws, steps, eps):
    """One of the script's own designs: (group, epl, warps, consumers, chains per warp)."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import _ring_bytes

    group, epl, warps, consumers, per_warp = design
    (c, d), dense = theta0.shape, prec.ndim == 2
    shared = (d + warps) * d * 4 if dense else 0
    if consumers < warps:
        shared += _ring_bytes(consumers * per_warp, d)
    out = torch.empty((c, draws, d), dtype=torch.float32, device=theta0.device)
    acc = torch.empty((c,), dtype=torch.float32, device=theta0.device)
    err = _variants_library().gaussian_hmc_variant_run(
        theta0.data_ptr(), prec.data_ptr(), out.data_ptr(), acc.data_ptr(), c, d, int(dense),
        draws, steps, eps, seed, group, epl, warps, consumers, per_warp, shared,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"design {design} failed: cudaError_t {err}")
    return out, acc


def variants(gaussian_hmc, d, chains):
    """{name: function (seed, theta0, prec, draws, steps, eps) -> (draws, acc)} for D."""
    spread = -(-chains // 132)  # chains per block that put a block on every SM

    def design(*shape):
        return lambda *args: run_design(shape, *args)

    warps = min(8, spread)
    out = {"as_is": gaussian_hmc,
           "warp_per_chain": design(32, 1 if d <= 32 else 4, warps, warps, 1)}
    if d <= 4:
        per_warp = min(32, spread)
        out.update(thread_per_chain=design(1, 4, 4, 1, per_warp),
                   thread_inline=design(1, 4, 1, 1, per_warp),
                   thread_ring_1=design(1, 4, 2, 1, per_warp),
                   thread_ring_7=design(1, 4, 8, 1, per_warp))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="a checkout of an earlier commit to time too")
    parser.add_argument("--time-root", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on a GPU", file=sys.stderr)
        return 2
    if args.time_root:
        print(json.dumps(time_quoted(args.time_root)))
        return 0

    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, cuda_ms, dense_precision

    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc

    device, card = torch.device("cuda:0"), card_line()
    print(card)
    shapes = QUOTED + (("diagonal D=3, 65,536 chains", 3, False, 65536, 100, 6),)
    for name, d, dense, chains, draws, _ in shapes:
        prec = (dense_precision(torch, d, 1) if dense else torch.linspace(0.25, 4.0, d)).to(device)
        theta0 = torch.zeros(chains, d, device=device)
        plans = variants(gaussian_hmc, d, chains)
        times = {(v, steps): [] for v in plans for steps in (1, 6, 12)}
        draws_of = {}
        for rep in range(4):  # rep 0 warms up and keeps the draws
            order = list(plans) if rep % 2 == 0 else list(plans)[::-1]
            for v in order:
                for steps in (1, 6, 12):
                    ms = cuda_ms(torch, lambda: plans[v](5, theta0, prec, draws, steps, 0.2))
                    if rep:
                        times[v, steps].append(ms)
                if rep == 0:
                    draws_of[v] = plans[v](5, theta0, prec, draws, 6, 0.2)[0]
        for v in plans:
            t1, t6, t12 = (statistics.median(times[v, steps]) for steps in (1, 6, 12))
            per_step = (t12 - t6) / 6 / draws
            # dense: the first 5 draws only (later, one Metropolis decision on a knife
            # edge between two roundings of the product would part the chains)
            keep = 5 if dense else draws
            err = float((draws_of[v][:, :keep] - draws_of["as_is"][:, :keep]).abs().max())
            if err > (1e-5 if dense else 0.0):
                raise RuntimeError(f"{name} {v}: draws differ from as_is by {err:.3e}")
            print(f"{name} {chains} chains x {draws} draws, {v}: L=1 {t1:.4f} ms, L=6 {t6:.4f} ms, "
                  f"L=12 {t12:.4f} ms; per step {per_step * 1e6:.2f} ns, per draw beside its steps "
                  f"{(t6 / draws - 6 * per_step) * 1e6:.2f} ns; draws vs as_is max_abs_err {err:.3e} "
                  f"[{card}]")
    if args.parent:
        against_parent(args.parent.resolve(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
