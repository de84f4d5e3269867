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

The any-D variant (``ANY_D``: diagonal and dense D=1024 at 1024 chains x 100
draws x L=10, diagonal D=1000 at 64 chains x 600 x L=6, dense D=4096 at 5
chains x 100 x L=10, and diagonal D beyond 4096, where the package holds one
chain a block of 1024 threads: 4099 at 5 chains, 8192 at 132 and 11,612 at
1024): ``as_is`` (dense P one product a step across a persistent grid on the
tensor cores, diagonal P in registers) beside ``former_any_d``, the former
design (1-8 chains a block of 8 warps with the state in shared memory, dense
P read from L2 or device memory by float32 FMAs), median of 3 in turns at
the shape's own L, with the same gates on the draws; for dense D=1024 also
the per-step / per-draw split of ``as_is``, and beside it the dense kernel
in the forms of ``DENSE_FORMS``: P^T split into its tf32 parts once a run
(and Delta split by whoever writes it) instead of as the product reads
them, each in the stages that fit 227 KB at its chain tile.

``--dense-anatomy`` times instead where a step of the any-D dense kernel
goes (per step: (t(L=12) - t(L=6)) / 6 over 20 draws): the chain tile
forced to 64, 32, 16 and 8 at D=1024 with 1024 and 128 chains (the plan's
choice beside the others), and two copies of the package's sources built
for this alone: ``no_loads``, each product's chunks after the first
DT_STAGES - 1 not copied in (it computes on stale stages), and
``no_mma``, the three ``mma.sync`` of each tile replaced by an integer
mix of the same split operands; and the diagonal kernel at 1, 2 and 4
groups of 4 elements a thread.  Their draws are not used.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked with
``git archive`` into the git-ignored ``build/``) it also times that
checkout's kernel at the two quoted shapes, in a process of its own each
time, in the order parent, this, this, parent.  Run from the root of a
checkout on a CUDA card (sm_90a):

    python3 scripts/gaussian_hmc_variants_torch.py [--parent DIR] [--any-d-only]
    python3 scripts/gaussian_hmc_variants_torch.py --dense-anatomy
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
ANY_D = (("diagonal D=1024", 1024, False, 1024, 100, 10),
         ("dense D=1024", 1024, True, 1024, 100, 10),
         ("diagonal D=1000, 64 chains", 1000, False, 64, 600, 6),
         ("dense D=4096, 5 chains", 4096, True, 5, 100, 10),
         ("diagonal D=4099, 5 chains", 4099, False, 5, 100, 10),
         ("diagonal D=8192, 132 chains", 8192, False, 132, 100, 10),
         ("diagonal D=11612, 1024 chains", 11612, False, 1024, 20, 10))
# the dense kernel's forms of scripts/csrc/gaussian_hmc_variants.cu
# (gaussian_hmc_dense_form_run): name by form number
DENSE_FORMS = ("as_built_2_stages", "split_p_2_stages", "split_p_and_delta_2_stages",
               "split_p_3_stages_32_chains")


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
    lib.gaussian_hmc_wide_run.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_ulonglong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.gaussian_hmc_wide_run.restype = ctypes.c_int
    lib.gaussian_hmc_dense_form_run.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_ulonglong]
        + [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.gaussian_hmc_dense_form_run.restype = ctypes.c_int
    return lib


def wide_shared(d, dense, chains_per_block):
    """The former design's shared bytes: two draws' float64 partial sums of
    8 warps and log-uniforms, then theta, its gradient, the trajectory's
    theta, p and gradient (and, for dense P, theta - mean) at D rounded up
    to 4."""
    dq = 4 * -(-d // 4)
    cb = chains_per_block
    return 8 * (2 * 8 * cb + 2 * cb) + 4 * dq * cb * (6 if dense else 5)


def former_any_d(seed, theta0, prec, draws, steps, eps):
    """The former any-D variant with the plan it had: the fewest chains a
    block (a power of two up to 8) that give every SM a block, fewer where
    needed to fit the state in shared memory."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import MAX_SHARED

    (c, d), dense = theta0.shape, prec.ndim == 2
    per_block = 1
    while per_block < 8 and per_block * 132 < c:
        per_block *= 2
    while per_block > 1 and wide_shared(d, dense, per_block) > MAX_SHARED:
        per_block //= 2
    out = torch.empty((c, draws, d), dtype=torch.float32, device=theta0.device)
    acc = torch.empty((c,), dtype=torch.float32, device=theta0.device)
    err = _variants_library().gaussian_hmc_wide_run(
        theta0.data_ptr(), prec.data_ptr(), out.data_ptr(), acc.data_ptr(), c, d, int(dense),
        draws, steps, eps, seed, per_block, wide_shared(d, dense, per_block),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the former any-D design failed: cudaError_t {err}")
    return out, acc


def dense_form(form, seed, theta0, prec, draws, steps, eps):
    """The any-D dense kernel in form ``form`` of DENSE_FORMS."""
    lib = _variants_library()
    (c, d), stream = theta0.shape, torch.cuda.current_stream().cuda_stream
    sizes = (ctypes.c_longlong * 3)()
    err = lib.gaussian_hmc_dense_form_run(None, None, None, None, c, d, draws, steps, eps, seed,
                                          form, None, sizes, stream)
    if err != 0:
        raise RuntimeError(f"dense form {DENSE_FORMS[form]}: cudaError_t {err}")
    scratch = torch.empty(sizes[0], dtype=torch.uint8, device=theta0.device)
    out = torch.empty((c, draws, d), dtype=torch.float32, device=theta0.device)
    acc = torch.empty((c,), dtype=torch.float32, device=theta0.device)
    err = lib.gaussian_hmc_dense_form_run(theta0.data_ptr(), prec.data_ptr(), out.data_ptr(),
                                          acc.data_ptr(), c, d, draws, steps, eps, seed, form,
                                          scratch.data_ptr(), sizes, stream)
    if err != 0:
        raise RuntimeError(f"dense form {DENSE_FORMS[form]}: cudaError_t {err}")
    return out, acc


# the ablations of --dense-anatomy: (line of csrc/gaussian_hmc.cuh, its stand-in)
ABLATIONS = {
    "no_loads": ("    if (kc + DT_STAGES - 1 < nkc) load(kc + DT_STAGES - 1);\n", "\n"),
    "no_mma": ("""          mma_tf32(acc_b[mi][ni], a_big[mi], b_big[ni][0], b_big[ni][1]);
          mma_tf32(acc_s[mi][ni], a_big[mi], b_small[ni][0], b_small[ni][1]);
          mma_tf32(acc_s[mi][ni], a_small[mi], b_big[ni][0], b_big[ni][1]);
""", """          acc_b[mi][ni][0] += __uint_as_float(
              (a_big[mi][0] ^ a_big[mi][1] ^ a_big[mi][2] ^ a_big[mi][3] ^ b_big[ni][0] ^
               b_big[ni][1]) & 0x3f800000u);
          acc_s[mi][ni][0] += __uint_as_float(
              (a_small[mi][0] ^ a_small[mi][1] ^ a_small[mi][2] ^ a_small[mi][3] ^
               b_small[ni][0] ^ b_small[ni][1]) & 0x3f800000u);
"""),
}


def ablated_library(kind):
    """The package's gaussian_hmc library built from a copy of its sources
    (under the git-ignored kernels/build/) with one ablation applied."""
    from hamiltorch_tpu_torch.kernels import _build
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import _declare

    src = _build.CSRC
    out = _build.BUILD_DIR / "ablation" / kind
    out.mkdir(parents=True, exist_ok=True)
    header = (src / "gaussian_hmc.cuh").read_text()
    line, stand_in = ABLATIONS[kind]
    if header.count(line) != 1:
        raise RuntimeError(f"{kind}: the line to ablate is not in csrc/gaussian_hmc.cuh once")
    (out / "gaussian_hmc.cuh").write_text(header.replace(line, stand_in))
    for name in ("common.cuh", "gaussian_hmc.cu"):
        (out / name).write_text((src / name).read_text())
    return _declare(_build.load(out / "gaussian_hmc.cu"))


def dense_anatomy(card):
    """Where a step of the any-D kernel goes (the module docstring)."""
    from chip_smoke import cuda_ms, dense_precision

    from hamiltorch_tpu_torch.kernels.gaussian_hmc import (Plan, _dense_shared, _library,
                                                           _plan)

    device, draws = torch.device("cuda:0"), 20
    libs = {"as_is": _library(), **{k: ablated_library(k) for k in ABLATIONS}}

    def per_step(lib, theta0, prec, plan):
        (c, d), dense = theta0.shape, prec.ndim == 2
        out = torch.empty((c, draws, d), device=device)
        acc = torch.empty((c,), device=device)
        nbytes = lib.gaussian_hmc_scratch_bytes(c, d, int(dense), plan.variant, plan.group)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None

        def run(steps):
            err = lib.gaussian_hmc_run(
                theta0.data_ptr(), prec.data_ptr(), None, out.data_ptr(), acc.data_ptr(), c, d,
                int(dense), draws, steps, 0.2, 3, *plan, None, None,
                None if scratch is None else scratch.data_ptr(),
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
        chosen = _plan(d, True, 8, chains).group
        for tile in (64, 32, 16, 8):
            plan = Plan(5, tile, 8, 0, _dense_shared(tile))
            us = {k: per_step(lib, theta0, prec, plan) for k, lib in libs.items()}
            tiles = -(-d // 128) * -(-chains // tile)
            print(f"dense D={d} {chains} chains, tiles of {tile} chains ({tiles} tiles"
                  f"{', the plan' if tile == chosen else ''}): per step "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()) + f" [{card}]", flush=True)
    prec = torch.linspace(0.25, 4.0, 1024, device=device)
    theta0 = torch.zeros(1024, 1024, device=device)
    chosen = _plan(1024, False, 8, 1024)
    for per_block, per_thread in ((1, 1), (2, 2), (4, 4), (1, 2), (1, 4)):
        plan = Plan(5, per_block, 8, per_thread, 0)
        us = per_step(libs["as_is"], theta0, prec, plan)
        print(f"diagonal D=1024 1024 chains, {per_block} chains a block, {per_thread} groups of 4 "
              f"elements a thread{' (the plan)' if plan == chosen else ''}: per step {us:.3f} us "
              f"[{card}]", flush=True)


def time_any_d(gaussian_hmc, card):
    """as_is beside former_any_d at the ANY_D shapes."""
    from chip_smoke import cuda_ms, dense_precision, time_in_turns

    device = torch.device("cuda:0")
    for name, d, dense, chains, draws, steps in ANY_D:
        prec = (dense_precision(torch, d, 1) if dense else torch.linspace(0.25, 4.0, d)).to(device)
        theta0 = torch.zeros(chains, d, device=device)
        fns = {"as_is": lambda s: gaussian_hmc(s, theta0, prec, draws, steps, 0.2),
               "former_any_d": lambda s: former_any_d(s, theta0, prec, draws, steps, 0.2)}
        if name == "dense D=1024":
            fns.update({f: functools.partial(dense_form, i, theta0=theta0, prec=prec, draws=draws,
                                             steps=steps, eps=0.2)
                        for i, f in enumerate(DENSE_FORMS)})
        got = {v: fn(5) for v, fn in fns.items()}
        keep = 5 if dense else draws  # dense: the first 5 draws, as above
        errs = {}
        for v in fns:
            errs[v] = float((got[v][0][:, :keep] - got["as_is"][0][:, :keep]).abs().max())
            if errs[v] > (1e-5 if dense else 0.0):
                raise RuntimeError(f"{name} {v}: draws differ from as_is by {errs[v]:.3e}")
        err = errs["former_any_d"]
        t = time_in_turns(torch, fns)
        split = "".join(f"; {v} {t[v][0]:.3f} ms (runs {t[v][1]}, draws vs as_is max_abs_err "
                        f"{errs[v]:.3e})" for v in DENSE_FORMS if v in t)
        if name == "dense D=1024":
            t_l = {}
            for ll in (1, 6, 12):
                gaussian_hmc(1, theta0, prec, draws, ll, 0.2)
                t_l[ll] = statistics.median(
                    cuda_ms(torch, lambda: gaussian_hmc(r, theta0, prec, draws, ll, 0.2))
                    for r in range(3))
            per_step = (t_l[12] - t_l[6]) / 6 / draws
            split += (f"; as_is at L=1/6/12 {t_l[1]:.3f} / {t_l[6]:.3f} / {t_l[12]:.3f} ms: "
                     f"per step {per_step * 1e3:.2f} us, per draw beside its steps "
                     f"{(t_l[6] / draws - 6 * per_step) * 1e3:.2f} us")
        print(f"{name} {chains} chains x {draws} draws x L={steps}: as_is {t['as_is'][0]:.3f} ms "
              f"(runs {t['as_is'][1]}), former_any_d {t['former_any_d'][0]:.3f} ms (runs "
              f"{t['former_any_d'][1]}); draws vs as_is (first {keep}) max_abs_err {err:.3e}; "
              f"acceptance {float(got['as_is'][1].mean()):.4f} / "
              f"{float(got['former_any_d'][1].mean()):.4f}{split} [{card}]", flush=True)


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
    parser.add_argument("--any-d-only", action="store_true", help="time the ANY_D shapes only")
    parser.add_argument("--dense-anatomy", action="store_true",
                        help="where a step of the any-D kernel goes, and nothing else")
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
    if args.dense_anatomy:
        dense_anatomy(card)
        return 0
    time_any_d(gaussian_hmc, card)
    if args.any_d_only:
        return 0
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
