"""Fused multi-chain HMC for Gaussian targets.

Counterpart of ``hamiltorch_tpu/kernels/gaussian_hmc.py::gaussian_hmc``:
the whole HMC sampler for logp(theta) = -1/2 (theta - mean)^T P
(theta - mean) with P diagonal (a (D,) vector) or dense SPD (a (D, D)
matrix), identity mass, over C chains.  Per draw: standard-normal momenta,
a half kick, L drift+kick steps, half a kick pulled back, and the
Metropolis test ``(h0 - h1) >= log u``.  It returns every draw
``(C, num_samples, D)`` and each chain's acceptance rate.  These are the
reference's headline small-D targets (the 3-D Gaussian of BASELINE config 1).

Two versions of the same function live here:

* ``gaussian_hmc`` is the wrapper.  On CUDA tensors it launches the CUDA
  kernel of ``csrc/gaussian_hmc.cu`` (built for Hopper at first use) and
  nothing else; on CPU tensors it calls the plain version, and on any other
  device it raises.  The tensors' device takes the place of the JAX
  function's ``interpret`` flag.
* ``gaussian_hmc_reference`` is the plain PyTorch version, with the
  kernel's arithmetic (the gradient carried between draws; energies
  reduced in float64).  The CPU tests hold it against the Pallas kernel,
  and ``chip_smoke.py`` holds the CUDA kernel against it.

Both compute over the real D only; the JAX kernel pads D to 128 lanes and
masks the padding out, so the two agree at every D.

``_noise = (momenta (S, C, D), uniforms (S, C))`` makes either version use
the given numbers instead of its own (a test hook, off the main path).
Without it the CUDA kernel draws from Philox keyed on (seed, chain, draw)
and the plain version from one ``torch.Generator`` per draw seeded by
``utils.rng.draw_seed(seed, 0, draw)``; the two streams differ.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..utils import profiling
from ..utils.rng import draw_seed
from .bnn_grad import _check

# the any-D dense kernel's phase counters (csrc/gaussian_hmc.cuh's DensePhase)
DENSE_PHASES = ("product_cycles", "epilogue_cycles", "barrier_cycles", "between_draws_cycles")


def _grad(th, mu, precision):
    """-(theta - mean) P (dense) or -(theta - mean) * P (diagonal), per chain."""
    delta = th - mu
    if precision.ndim == 2:
        return -(delta @ precision)
    return -(delta * precision)


def _energy(th, mu, g, p):
    """-1/2 (theta - mean).g + 1/2 |p|^2 per chain, in float64."""
    pot = -0.5 * torch.sum((th - mu).double() * g.double(), dim=1)
    return pot + 0.5 * torch.sum(p.double() ** 2, dim=1)


def gaussian_hmc_reference(seed, theta0, precision, num_samples, num_steps=10, step_size=0.1,
                           chain_tile=8, mean=None, _noise=None):
    """Plain PyTorch version of ``gaussian_hmc``; same arguments and returns.

    ``chain_tile`` only matters to the CUDA kernel.
    """
    del chain_tile
    c, d = theta0.shape
    eps = step_size
    mu = torch.zeros(d, dtype=theta0.dtype, device=theta0.device) if mean is None else mean
    theta = theta0
    g_cur = _grad(theta, mu, precision)
    out = torch.empty((c, num_samples, d), dtype=theta0.dtype, device=theta0.device)
    accepted = torch.zeros(c, dtype=torch.float32, device=theta0.device)
    gen = None if _noise is not None else torch.Generator(device=theta0.device)
    for n in range(num_samples):
        if _noise is None:
            gen.manual_seed(draw_seed(seed, 0, n))
            p = torch.randn((c, d), generator=gen, dtype=theta0.dtype, device=theta0.device)
            u = torch.rand((c,), generator=gen, dtype=theta0.dtype, device=theta0.device)
        else:
            p, u = _noise[0][n], _noise[1][n]
        h0 = _energy(theta, mu, g_cur, p)
        p = p + (0.5 * eps) * g_cur
        th, g = theta, g_cur
        for _ in range(num_steps):
            th = th + eps * p
            g = _grad(th, mu, precision)
            p = p + eps * g
        p = p - (0.5 * eps) * g
        h1 = _energy(th, mu, g, p)
        accept = (h0 - h1) >= torch.log(u.double())
        theta = torch.where(accept[:, None], th, theta)
        g_cur = torch.where(accept[:, None], g, g_cur)
        out[:, n] = theta
        accepted += accept.to(torch.float32)
    return out, accepted / num_samples


MAX_SHARED = 232448  # bytes of shared memory one block may use on Hopper
MMA_MAX_D = 128  # largest dense D of the tensor-core variant
RING_DRAWS = 16  # draws of noise per buffer of the small-D variants' ring

# What the wrapper asks of csrc/gaussian_hmc.cu: ``variant`` 1-5 (0: no
# variant takes the shape), ``group`` lanes per chain (variant 5: chains per
# tile for dense P, per block for diagonal P), ``consumers`` warps of a block
# that run ``chains_per_warp`` chains each (variants 1, 2 and 4 add warps
# that produce noise; variant 5's 8 or 32 warps share their chains, and
# ``chains_per_warp`` is there the groups of 4 elements each thread holds in
# registers, 0 for the dense form), ``shared`` bytes.
Plan = collections.namedtuple("Plan", "variant group consumers chains_per_warp shared")
_NO_PLAN = Plan(0, 0, 0, 0, 0)
_SMS = 132  # streaming multiprocessors of an H100
WIDE_WARPS = 8  # warps per block of variant 5 (dense P, and diagonal P up to DIAG_MAX_D)
DIAG_MAX_D = 4096  # largest diagonal D whose state a team of 256 threads holds in registers
DIAG_WIDE_WARPS = 32  # warps of the block that holds one chain beyond DIAG_MAX_D
DIAG_WIDE_MAX_D = 12288  # largest diagonal D: 3 groups of 4 elements a thread of 1024
DENSE_ROWS = 128  # rows of the dense product (elements of the gradient) a tile takes
DENSE_CHUNK = 64  # rows of P summed into one partial
DENSE_STAGES = 4  # chunks of a tile's operands in flight
DENSE_CHAIN_TILES = (64, 32, 16, 8)  # chains a dense tile may take


def _dense_shared(chain_tile):
    """The dense form's bytes: DENSE_STAGES chunks of a tile's two operands
    (128 rows of P^T, ``chain_tile`` chains' theta - mean, 64 deep, float32)
    and the float64 energy partials of its rows of warps."""
    rows_of_warps = 4 if chain_tile == 64 else 8
    return (DENSE_STAGES * (DENSE_ROWS + chain_tile) * DENSE_CHUNK * 4
            + 8 * rows_of_warps * chain_tile)


def _diag_wide_shared(per_thread):
    """The one-chain diagonal form's bytes: the mean and P of 1024 threads'
    ``per_thread`` groups of 4 elements, float32."""
    return 2 * 16 * per_thread * 32 * DIAG_WIDE_WARPS


def _dense_chain_tile(d, chains):
    """Chains a dense tile takes: the fewest waves of tiles over the card's
    SMs, each wave weighed by a tile's operands (128 rows of P^T and the
    tile's chains), the wider tile on a tie (P^T read fewer times)."""
    row_tiles = -(-d // DENSE_ROWS)

    def cost(bn):
        waves = -(-(row_tiles * -(-chains // bn)) // _SMS)
        return waves * (DENSE_ROWS + bn), -bn

    return min(DENSE_CHAIN_TILES, key=cost)


def _wide_plan(d, dense, chains):
    """Variant 5, for dense P at any D and diagonal P up to DIAG_WIDE_MAX_D.

    * Dense P: one persistent grid, tiles of 128 rows of the product by
      ``group`` = 8-64 chains (``_dense_chain_tile``), on the tensor cores.
      What bounds it is the product's operations and the bytes its tiles
      read from L2; no D is refused, the card's memory is the limit (P and
      the kernel's padded copy of it, 8 D^2 bytes, beside the state).
    * Diagonal P with D <= DIAG_MAX_D: the state in registers; each thread
      holds ``chains_per_warp`` = 1, 2 or 4 groups of 4 elements (the
      fewest that a team of at most 256 threads needs), a chain's team is
      the next power of two of threads from 32 up, ``group`` = 256 / team
      chains a block of 8 warps.  What bounds it is issue (four dependent
      float32 operations an element and step, beside the noise and the
      float64 energies) and, at many chains, the draws written out.
    * Diagonal P with DIAG_MAX_D < D <= DIAG_WIDE_MAX_D: one chain a block
      of 32 warps, 2 or 3 groups of 4 elements a thread in registers, the
      mean and P in shared memory (``_diag_wide_shared``): beyond 4096 the
      mean and P no longer fit 256 threads' registers beside the state.
    """
    if dense:
        bn = _dense_chain_tile(d, chains)
        return Plan(5, bn, WIDE_WARPS, 0, _dense_shared(bn))
    if d <= DIAG_MAX_D:
        groups = -(-d // 4)
        per_thread = next(g for g in (1, 2, 4) if -(-groups // g) <= 256)
        team = max(32, 1 << (-(-groups // per_thread) - 1).bit_length())
        return Plan(5, 256 // team, WIDE_WARPS, per_thread, 0)
    if d > DIAG_WIDE_MAX_D:
        return _NO_PLAN
    per_thread = -(-d // (4 * 32 * DIAG_WIDE_WARPS))
    return Plan(5, 1, DIAG_WIDE_WARPS, per_thread, _diag_wide_shared(per_thread))


def _ring_bytes(chains_per_block, d):
    """Two buffers of RING_DRAWS draws: a float64 log-uniform and d normals."""
    return 2 * RING_DRAWS * chains_per_block * (8 + 4 * d)


def _plan(d, dense, chain_tile, chains):
    """The kernel variant for (D, diagonal or dense P) and its block shape.

    1. D <= 8: 2, 4 or 8 lanes per chain, one element each; blocks of 1
       warp of chains and 3 warps that produce its noise into a
       shared-memory ring.
    2. 8 < D <= 32: 16 or 32 lanes per chain, one element each; up to
       ``min(chain_tile, 4)`` warps of chains, the rest of 8 warps producers.
    3. D > 32, diagonal P, or dense P with D > MMA_MAX_D: one warp per chain
       (float32 FMA; dense P and one row per warp in shared memory), at most
       ``min(chain_tile, 8)`` warps a block, fewer where that is needed to
       fit P.
    4. Dense P, 32 < D <= MMA_MAX_D: blocks of 16 chains on the tensor cores
       (3xTF32), P pre-split in shared memory, 8 warps of chains where D
       rounded up to 32 divides by 64 and 4 otherwise, and 2 warps that
       produce the next draw's noise; ``chain_tile`` is not used.  (Beyond
       D=128 the split P, theta - mean and the noise no longer fit a block
       together.)

    5. Any other D: diagonal P with D > 256 up to D = 12,288, dense P
       beyond the reach of variant 3 (D > 240) at any D (``_wide_plan``):
       dense P as one product a leapfrog step across a persistent grid on
       the tensor cores (3xTF32), diagonal P with the state in registers.

    In 1-3 a block takes fewer chains than it could where that spreads the
    chains over the card's SMs: each chain's time is its own latency.
    ``chain_tile`` above 32 counts as 32.
    """
    if not (d >= 1 and chain_tile >= 1 and chains >= 1):
        return _NO_PLAN
    if d > 256:
        return _wide_plan(d, dense, chains)
    chain_tile = min(chain_tile, 32)
    p_bytes = 4 * d * d if dense else 0
    if d <= 8:
        group = 2 if d <= 2 else 4 if d <= 4 else 8
        per_warp = min(32 // group, -(-chains // _SMS))
        return Plan(1, group, 1, per_warp, _ring_bytes(per_warp, d) + p_bytes)
    if d <= 32:
        group = 16 if d <= 16 else 32
        per_warp = min(32 // group, -(-chains // _SMS))
        consumers = min(chain_tile, 4, -(-chains // (per_warp * _SMS)))
        return Plan(2, group, consumers, per_warp, _ring_bytes(consumers * per_warp, d) + p_bytes)
    if dense and d <= MMA_MAX_D:
        dp = 32 * -(-d // 32)
        consumers = 8 if dp % 64 == 0 else 4
        # energy partials and log-uniforms, P and theta - mean (each split in two
        # tf32 parts, theta - mean of two steps), the producers' two draws of momenta
        shared = (8 * (consumers + 2) * 16 + 8 * dp * dp + 2 * 2 * 16 * dp * 4
                  + 2 * 16 * (dp + 8) * 4)
        return Plan(4, 32, consumers, 0, shared)
    warps = min(chain_tile, 8, -(-chains // _SMS))
    if dense:
        warps = min(warps, MAX_SHARED // (4 * d) - d)
        if warps < 1:
            return _wide_plan(d, dense, chains)
    return Plan(3, 32, warps, 1, (d + warps) * d * 4 if dense else 0)


@functools.lru_cache(maxsize=None)
def _library():
    from ._build import load

    lib = load("gaussian_hmc")
    lib.gaussian_hmc_error_string.argtypes = [ctypes.c_int]
    lib.gaussian_hmc_error_string.restype = ctypes.c_char_p
    lib.gaussian_hmc_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.gaussian_hmc_scratch_bytes.restype = ctypes.c_size_t
    lib.gaussian_hmc_run.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_ulonglong]
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 6
    )
    lib.gaussian_hmc_run.restype = ctypes.c_int
    return lib


def gaussian_hmc(seed, theta0, precision, num_samples, num_steps=10, step_size=0.1,
                 chain_tile=8, mean=None, _noise=None, _variant=None):
    """Sample C chains from N(mean, P^-1); returns (samples (C, N, D), acc (C,)).

    ``precision`` is (D,) for a diagonal P or (D, D) for a dense SPD one;
    ``mean`` is (D,) or None for zero.  On the card ``_plan`` picks the
    kernel variant from D: 2 to 32 lanes per chain (D <= 32, the next power
    of two), a warp per chain (diagonal D <= 256, dense D <= 240), blocks of
    16 chains on the tensor cores in 3xTF32 (dense 32 < D <= 128), all with
    the chain state in registers, or, for any larger D, the any-D variant:
    dense P as one (C, D) x (D, D) product a leapfrog step on the tensor
    cores in 3xTF32 across one persistent cooperative grid (at any D; its
    scratch, ~4 (D^2 + 7 C D) bytes, is allocated here), and diagonal P with
    a chain's state in the registers of 32-256 threads (D <= 4096) or, up to
    D = 12,288, of 1024.  Beyond that diagonal D the kernel returns
    cudaErrorInvalidValue and this raises.
    ``chain_tile`` is a hint: an upper bound on the warps of chains in one
    block of variants 1-3, which the kernel lowers where that spreads the
    chains over more SMs or is needed to fit a dense P; the draws do not
    depend on it, nor on the variant.  ``_variant=5`` runs the any-D variant
    whatever D is (a test hook: it must draw what the others draw).
    ``gaussian_hmc.launches`` counts the runs of the CUDA kernel.  While the
    recorder (``utils/profiling.py``) records, a call is the span
    ``gaussian_hmc`` with the children ``.prepare``, ``.enqueue`` and
    ``.prologue``, adds to ``gaussian_hmc.kernel_launches``, ``.launch_ns``
    and ``.prologue_ns``, and the any-D kernel at dense P to the counters
    ``dense_grid.<DENSE_PHASES>``.
    """
    with profiling.annotate("gaussian_hmc"):
        device = theta0.device
        with profiling.annotate("gaussian_hmc.prepare"):
            if theta0.ndim != 2:
                raise ValueError(f"theta0 must be (C, D), got shape {tuple(theta0.shape)}")
            c, d = theta0.shape
            _check("theta0", theta0, (c, d), device)
            if precision.ndim not in (1, 2):
                raise ValueError("precision must be (D,) or (D, D), got shape "
                                 f"{tuple(precision.shape)}")
            _check("precision", precision, (d,) * precision.ndim, device)
            if mean is not None:
                _check("mean", mean, (d,), device)
            if num_samples < 1 or num_steps < 1:
                raise ValueError("num_samples and num_steps must be >= 1")
            if int(chain_tile) < 1:
                raise ValueError(f"chain_tile must be >= 1, got {chain_tile}")
            if _variant not in (None, 5):
                raise ValueError(f"_variant must be None or 5, got {_variant}")
            if _noise is not None:
                _check("momenta", _noise[0], (num_samples, c, d), device)
                _check("uniforms", _noise[1], (num_samples, c), device)
            if device.type == "cuda":
                lib = _library()
                dense = precision.ndim == 2
                plan = (_plan(d, dense, int(chain_tile), c) if _variant is None
                        else _wide_plan(d, dense, c))
                out = torch.empty((c, num_samples, d), dtype=torch.float32, device=device)
                acc = torch.empty((c,), dtype=torch.float32, device=device)
                nbytes = lib.gaussian_hmc_scratch_bytes(c, d, int(dense), plan.variant,
                                                        plan.group)
                scratch = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
                stats = profiling.launch_stats()
                phases = (profiling.device_counters("dense_grid", DENSE_PHASES, device)
                          if dense and plan.variant == 5 else None)

        if device.type == "cpu":
            return gaussian_hmc_reference(seed, theta0, precision, num_samples, num_steps,
                                          step_size, chain_tile, mean, _noise=_noise)
        if device.type != "cuda":
            raise ValueError(f"gaussian_hmc runs on CUDA or CPU tensors, not {device}")

        momenta, uniforms = (None, None) if _noise is None else _noise
        with profiling.annotate("gaussian_hmc.enqueue"), torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.gaussian_hmc_run(
                theta0.data_ptr(), precision.data_ptr(),
                None if mean is None else mean.data_ptr(), out.data_ptr(), acc.data_ptr(),
                c, d, int(dense), num_samples, num_steps,
                float(step_size), int(seed) & (2**64 - 1), *plan,
                None if momenta is None else momenta.data_ptr(),
                None if uniforms is None else uniforms.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                stream, stats, None if phases is None else phases.data_ptr(),
            )
        if err != 0:
            msg = lib.gaussian_hmc_error_string(err).decode()
            raise RuntimeError(f"gaussian_hmc CUDA kernel failed: cudaError_t {err} ({msg}); "
                               "see the docstring for the shapes it takes")
        profiling.record_launch_stats("gaussian_hmc", stats)
        gaussian_hmc.launches += 1
        return out, acc


gaussian_hmc.launches = 0
