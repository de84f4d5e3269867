"""A/B probes of ``bnn_mclmc``'s design on one GPU.

Times the package's fused MCLMC kernel beside designs that were replaced or
not taken.  Those are not in the package's library: this script builds them
for itself from ``scripts/csrc/bnn_mclmc_variants.cu``, which includes the
package's source whole.  At the flagship (64 chains x 500 draws, eps = 2e-3,
L = 10, on Philox noise), median of 3, in turns (CUDA events):

  - ``as_is``: the package's ``bnn_mclmc`` (9 launches a draw: each
    gradient reduces |g|^2, u.g and |u|^2 in its epilogues, each rotation is
    one pass with the drift or the refresh fused), with the options that
    ``csrc/bnn_mclmc.cu``'s ``kOptions`` takes;
  - ``former``: the design before it (dots, rotate and scale passes, the
    refresh in two more: 16 launches a draw), on the same gradient kernels;
  - the package's design with each set of the options of ``mclmc_run``:
    ``none``; ``reverse`` (passes walking the chains from the last);
    ``dependent`` (programmatic dependent launches); ``graph`` (every draw
    after the first replayed as one CUDA graph); ``all`` (the three).

Every variant's results must equal ``as_is`` bit for bit (the options change
no arithmetic), and the former design's must agree within 1e-5 (parameters)
and 1e-3 relative (var_e) over 5 draws at eps = 2, where dE stands clear of
the float32 rounding of logp (at eps = 2e-3 it does not).  Then a draw's anatomy: the two gradients alone
(``kernels/bnn_grad._bnn_gradient``, 21 evaluations less 1, over 20), the
device time of each kernel a draw and the launches a draw (``torch.profiler``
over runs of 20 and 40 draws: the difference over 20), and the launch gaps
(a draw's time less its kernels' device time).

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked with
``git archive`` into the git-ignored ``build/``) it also times that
checkout's ``bnn_hmc`` (64 chains x 10 draws x 50 steps at 2e-4) and
``bnn_mclmc`` (as above), each in a process of its own, in the order parent,
this, this, parent.  Run from the root of a checkout on a CUDA card (sm_90a):

    python3 scripts/bnn_mclmc_variants_torch.py [--parent DIR]
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
VARIANTS = REPO / "scripts" / "csrc" / "bnn_mclmc_variants.cu"
DRAWS, EPS, LENGTH = 500, 2e-3, 10.0
OPTIONS = {"none": 0, "reverse": 1, "dependent": 2, "graph": 4, "all": 7}


@functools.lru_cache(maxsize=None)
def variants_library():
    from hamiltorch_tpu_torch.kernels import _build

    lib = _build.load(VARIANTS)
    run_args = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                + [ctypes.c_ulonglong] + [ctypes.c_void_p] + [ctypes.c_int] * 2
                + [ctypes.c_void_p])
    lib.bnn_mclmc_options_run.argtypes = run_args + [ctypes.c_int]
    lib.bnn_mclmc_former_run.argtypes = run_args
    for name in ("bnn_mclmc_workspace_bytes", "bnn_mclmc_former_workspace_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
        getattr(lib, name).restype = ctypes.c_size_t
    return lib


def run_variant(design, seed, x, y, w1, b1, w2, b2, u, num_samples, step_size, length,
                tau=10.0, normals=None):
    """``bnn_mclmc``'s call with the variants library: design "former" or a
    name of OPTIONS.  Returns (w1, b1, w2, b2, var_e)."""
    from hamiltorch_tpu_torch.kernels.bnn_grad import _grids
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import _refresh_weight

    lib = variants_library()
    n, i_dim = x.shape
    c, _, h = w1.shape
    dim = i_dim * h + 2 * h + 1
    outs = (torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(w2),
            torch.empty_like(b2), torch.empty((c,), dtype=torch.float32, device=x.device))
    former = design == "former"
    size = (lib.bnn_mclmc_former_workspace_bytes if former else lib.bnn_mclmc_workspace_bytes)(
        n, i_dim, h, c)
    workspace = torch.empty((size,), dtype=torch.uint8, device=x.device)
    args = [x.data_ptr(), y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), u.data_ptr(), *(o.data_ptr() for o in outs), workspace.data_ptr(),
            n, i_dim, h, c, num_samples, float(step_size),
            _refresh_weight(step_size, length, dim), float(tau), int(seed) & (2**64 - 1),
            None if normals is None else normals.data_ptr(),
            *_grids(n, i_dim, h, c, x.device), torch.cuda.current_stream(x.device).cuda_stream]
    err = (lib.bnn_mclmc_former_run(*args) if former
           else lib.bnn_mclmc_options_run(*args, OPTIONS[design]))
    if err != 0:
        raise RuntimeError(f"{design}: cudaError_t {err}")
    return outs


def flagship_run():
    """The timed shape's inputs: (args, u, kwargs)."""
    from chip_smoke import FLAGSHIP, bnn_inputs

    device = torch.device("cuda:0")
    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    dim = FLAGSHIP["i"] * FLAGSHIP["h"] + 2 * FLAGSHIP["h"] + 1
    u = torch.randn(FLAGSHIP["c"], dim, generator=torch.Generator().manual_seed(8)).to(device)
    return args, u, dict(num_samples=DRAWS, step_size=EPS, length=LENGTH, tau=10.0)


def check_results(name, got, want, exact):
    torch.cuda.synchronize()
    if exact:
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{name} does not draw what as_is draws")
        return
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    var_rel = float(((got[4] - want[4]) / want[4]).abs().max())
    print(f"{name} vs as_is: max_abs_err {err:.3e}, var_e max_rel_err {var_rel:.3e}")
    if not (err <= 1e-5 and var_rel <= 1e-3):
        raise RuntimeError(f"{name} disagrees with as_is")


def device_profile(fn):
    """{kernel name: (device ms, launches)} of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    from profile_bnn_hmc_torch import SELF_DEVICE

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            ms, count = out.get(name, (0.0, 0))
            out[name] = (ms + getattr(e, SELF_DEVICE) / 1e3, count + e.count)
    return out


def anatomy(args, u, kw, ms_per_draw, card):
    """Where a draw of as_is goes."""
    from chip_smoke import FLAGSHIP, MCLMC_PASSES, time_in_turns, velocity_bytes
    from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc

    x, y, w1, *rest = args
    theta = torch.cat([t.reshape(t.shape[0], -1) for t in (w1, *rest)], dim=1).contiguous()
    t = time_in_turns(torch, {"one": lambda s: _bnn_gradient(x, y, theta, repeats=1),
                              "many": lambda s: _bnn_gradient(x, y, theta, repeats=21)})
    grad_ms = (t["many"][0] - t["one"][0]) / 20
    profiles = {n: device_profile(lambda n=n: bnn_mclmc(0, *args, u, **{**kw, "num_samples": n}))
                for n in (20, 40)}
    per_draw = {}
    for name, (ms, count) in profiles[40].items():
        ms0, count0 = profiles[20].get(name, (0.0, 0))
        per_draw[name] = ((ms - ms0) / 20, (count - count0) / 20)
    launches = sum(c for _, c in per_draw.values())
    device_ms = sum(m for m, _ in per_draw.values())
    print(f"as_is, a draw: {ms_per_draw * 1e3:.1f} us; two gradients alone (_bnn_gradient) "
          f"{2 * grad_ms * 1e3:.1f} us; device time {device_ms * 1e3:.1f} us in {launches:g} "
          f"launches; launch gaps {(ms_per_draw - device_ms) * 1e3:.1f} us [{card}]")
    for name, (ms, count) in sorted(per_draw.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms * 1e3:.2f} us in {count:g} launches a draw")
    passes = sum(m for name, (m, _) in per_draw.items() if name.startswith("rotate_"))
    modelled = velocity_bytes(FLAGSHIP, MCLMC_PASSES[0])
    print(f"  velocity passes (rotate_drift_kernel, rotate_refresh_kernel): {passes * 1e3:.2f} us a "
          f"draw; with the gradients' two reads of u, {MCLMC_PASSES[0]} passes over the state, "
          f"{modelled / 1e6:.1f} MB a draw (modelled from the shapes, not measured; "
          f"{modelled / 3.35e12 * 1e6:.1f} us at 3.35 TB/s)")


def time_root(root: Path) -> dict:
    """Median-of-3 times (ms) of bnn_hmc and bnn_mclmc at the checkout at root."""
    sys.path.insert(0, str(root))
    from chip_smoke import FLAGSHIP, bnn_inputs, cuda_ms
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc

    device = torch.device("cuda:0")
    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    dim = FLAGSHIP["i"] * FLAGSHIP["h"] + 2 * FLAGSHIP["h"] + 1
    u = torch.randn(FLAGSHIP["c"], dim, generator=torch.Generator().manual_seed(8)).to(device)
    fns = {"bnn_hmc": lambda s: bnn_hmc(s, *args, num_samples=10, num_steps=50, step_size=2e-4,
                                        tau=10.0),
           "bnn_mclmc": lambda s: bnn_mclmc(s, *args, u, num_samples=DRAWS, step_size=EPS,
                                            length=LENGTH, tau=10.0)}
    out = {}
    for name, fn in fns.items():
        fn(0)
        torch.cuda.synchronize()
        runs = [cuda_ms(torch, lambda: fn(r + 1)) for r in range(3)]
        out[name] = (statistics.median(runs), runs)
    return out


def against_parent(parent: Path, card: str) -> None:
    results = []
    for root in (parent, REPO, REPO, parent):
        done = subprocess.run([sys.executable, __file__, "--time-root", str(root)],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{done.stdout}\n{done.stderr}")
        results.append(json.loads(done.stdout.strip().splitlines()[-1]))
    for name in results[0]:
        par = [results[0][name][0], results[3][name][0]]
        this = [results[1][name][0], results[2][name][0]]
        print(f"{name} flagship: parent {par[0]:.3f} / {par[1]:.3f} ms, this {this[0]:.3f} / "
              f"{this[1]:.3f} ms (parent, this, this, parent; medians of 3): this / parent "
              f"{sum(this) / sum(par):.4f} [{card}]")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path)
    parser.add_argument("--time-root", type=Path)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.time_root:
        print(json.dumps(time_root(opts.time_root.resolve())))
        return 0
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    from chip_smoke import card_line, time_in_turns
    from hamiltorch_tpu_torch.kernels import _build
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc

    card = card_line()
    print(card)
    _build.build_all(["bnn_mclmc", "bnn_grad", VARIANTS])
    args, u, kw = flagship_run()
    # the options draw what as_is draws; the former design agrees within the
    # kernels' tolerances at chip_smoke.py's step (at 2e-3, var_e is below
    # the float32 rounding of the flagship's logp)
    want = bnn_mclmc(3, *args, u, **{**kw, "num_samples": 20})
    for name in OPTIONS:
        check_results(name, run_variant(name, 3, *args, u, **{**kw, "num_samples": 20}), want,
                      exact=True)
    large = {**kw, "num_samples": 5, "step_size": 2.0}
    check_results("former", run_variant("former", 3, *args, u, **large),
                  bnn_mclmc(3, *args, u, **large), exact=False)
    fns = {"as_is": lambda s: bnn_mclmc(s, *args, u, **kw)}
    fns.update({name: (lambda s, name=name: run_variant(name, s, *args, u, **kw))
                for name in ["former", *OPTIONS]})
    times = time_in_turns(torch, fns)
    for name, (ms, runs) in times.items():
        print(f"{name}: {ms:.3f} ms ({ms / DRAWS * 1e3:.1f} us a draw) for 64 chains x {DRAWS} "
              f"draws, runs {[round(r, 3) for r in runs]} [{card}]")
    print(f"as_is / former: {times['as_is'][0] / times['former'][0]:.4f}; as_is / none: "
          f"{times['as_is'][0] / times['none'][0]:.4f}")
    anatomy(args, u, kw, times["as_is"][0] / DRAWS, card)
    if opts.parent:
        against_parent(opts.parent.resolve(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
