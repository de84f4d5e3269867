"""Seeds and per-draw random streams.

Counterpart of ``hamiltorch_tpu/utils/rng.py``.  The JAX package keys every
sampler with a ``jax.random`` key and derives each draw's noise with
``fold_in(key, n)`` (``samplers/driver.py``), so a run split into chunks
draws the same numbers as the unsplit run.  Here a sampler's key is an
integer seed, and the noise of chain ``c`` at global draw ``n`` comes from a
``torch.Generator`` seeded with a hash of ``(seed, c, n)``: the stream of a
draw depends on nothing else, so chunked runs reproduce the unchunked one.
``c`` is the chain's global index: the sharded runners
(``parallel/sharding.py``) run each rank's chains under ``chain_slice``, so
they draw what the same chains of the unsharded run draw.

The numbers are PyTorch's, not ``jax.random``'s: tests that compare the two
packages draw with numpy (or with ``jax.random`` on the test side) and hand
the noise to both.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

_MASK64 = (1 << 64) - 1

# Stream namespaces: a sampler adds its namespace to the draw index, so that
# two samplers run with one key do not share a stream.  HMC uses the draw
# index itself, MCLMC [0, 2**32) (samplers/mclmc.py), MAMS and NUTS these
# offsets.  AUX_STREAM holds the extra per-draw noise that a transition asks
# the driver for (RMHMC's jitter, SPLITTING_RAND's term order), beside the
# draw's momentum and Metropolis uniform.  CHEES_JITTER_STREAM holds ChEES's
# trajectory jitter, one uniform a draw shared by every chain; SPREAD_STREAM
# the seed of ChEES's start spread; SG_STREAM the SG-MCMC normals, one
# generator a thinning window keyed on the window's first step, and
# SG_INDEX_STREAM the SG-MCMC minibatch indices, one hash a step.
# PT_STREAM and TI_STREAM hold a replica ladder's noise: at global draw n
# ONE generator a ladder, seeded by draw_seed(key, ladder, stream + n),
# draws the momenta, the Metropolis uniforms and the swap uniforms of every
# replica of the ladder (``draw_ladder_noise``; the ladder index is the
# ensemble of ``run_pt_chains``, 0 otherwise).  SMC_STREAM holds tempered
# SMC's: stage k's device noise (resample uniform, momenta, Metropolis
# uniforms of every mutation) from draw_seed(key, 0, SMC_STREAM + k), its
# trajectory jitter on the host from draw_seed(key, 1, SMC_STREAM + k), the
# prior draw's seed draw_seed(key, 2, SMC_STREAM) and the uniform of
# ``smc_posterior_sample`` from draw_seed(key, 3, SMC_STREAM).
# The next four follow the same design (``stream_generator``): at global
# draw n ONE generator seeded by draw_seed(key, 0, stream + n) draws the
# noise of every chain or walker.  BARKER_STREAM holds a Barker draw's
# increments, keep uniforms and Metropolis uniforms; STRETCH_STREAM a
# stretch-move iteration's z uniforms, partner indices and Metropolis
# uniforms, and its start jitter from draw_seed(key, 1, STRETCH_STREAM);
# ELLIPTICAL_STREAM an elliptical-slice draw's prior normals, slice-level
# and angle uniforms, then one uniform a lane a shrink iteration, in order;
# OPTIM_STREAM ADVI's Monte Carlo normals at step i, and the draws of
# ``laplace_sample`` / ``advi_sample`` from draw_seed(key, 1, OPTIM_STREAM).
# SVGD_STREAM holds SVGD's initial cloud, (n, D) normals from
# draw_seed(key, 0, SVGD_STREAM); the update itself draws nothing.
# STRETCH_ENSEMBLE_STREAM seeds ensemble e of the sharded stretch move:
# its run is the stretch move's with the key draw_seed(key, e,
# STRETCH_ENSEMBLE_STREAM).
MAMS_STREAM = 2**40
NUTS_STREAM = 2**41
AUX_STREAM = 2**42
CHEES_JITTER_STREAM = 2**43
SG_STREAM = 2**44
SG_INDEX_STREAM = 2**45
SPREAD_STREAM = 2**46
PT_STREAM = 2**47
TI_STREAM = 2**48
SMC_STREAM = 2**49
BARKER_STREAM = 2**50
STRETCH_STREAM = 2**51
ELLIPTICAL_STREAM = 2**52
OPTIM_STREAM = 2**53
SVGD_STREAM = 2**54
STRETCH_ENSEMBLE_STREAM = 2**55

_global_gen: torch.Generator | None = None

# (offset, total) while a sharded runner runs its local chains: the batch's
# chain c is global chain offset + c of total (``chain_slice``).
_CHAIN_SLICE: contextvars.ContextVar = contextvars.ContextVar("chain_slice", default=None)


@contextlib.contextmanager
def chain_slice(offset: int, total: int):
    """Within the block, a batch of C chains is the global chains ``offset
    .. offset + C - 1`` of ``total``: the per-chain streams seed on the
    global index (``chain_ids``), and the one-generator-a-draw streams draw
    the whole ``total`` block and keep the batch's rows (``chain_rows``).
    So a sharded run's chains draw what the same chains of the unsharded
    run draw."""
    token = _CHAIN_SLICE.set((int(offset), int(total)))
    try:
        yield
    finally:
        _CHAIN_SLICE.reset(token)


def chain_ids(num_chains: int) -> range:
    """The global indices of a batch of ``num_chains`` chains."""
    cs = _CHAIN_SLICE.get()
    offset = 0 if cs is None else cs[0]
    return range(offset, offset + num_chains)


def keyed_chains(chain_keys, num_chains: int):
    """The pooled samplers' sharding hook: with ``chain_keys`` (the batch's
    global chain indices, ``num_chains`` consecutive ones) a
    ``chain_slice`` at the first; without, no change to the stream."""
    if chain_keys is None:
        return contextlib.nullcontext()
    keys = [int(k) for k in chain_keys]
    first = keys[0] if keys else 0
    if keys != list(range(first, first + num_chains)):
        raise ValueError(
            f"chain_keys must be {num_chains} consecutive global chain indices, got {keys}"
        )
    return chain_slice(first, first + num_chains)


def chain_rows(num_chains: int) -> tuple:
    """``(total, offset)``: a one-generator-a-draw stream draws ``total``
    rows and the batch keeps rows ``offset .. offset + num_chains - 1``."""
    cs = _CHAIN_SLICE.get()
    return (num_chains, 0) if cs is None else (cs[1], cs[0])


def set_random_seed(seed: int | None = None) -> int:
    """Seed the module-level generator used when callers pass no key.

    As in the JAX package this does not run at import time; call it (or pass
    explicit keys) before sampling.  Returns the seed used.
    """
    global _global_gen
    seed = int((time.time() * 1e6) % 1e8) if seed is None else int(seed)
    _global_gen = torch.Generator().manual_seed(seed)
    return seed


def next_key() -> int:
    """A fresh integer key drawn from the module-level generator."""
    if _global_gen is None:
        set_random_seed()
    return int(torch.randint(0, 2**62, (), generator=_global_gen))


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def draw_seed(key: int, chain: int, n: int) -> int:
    """The generator seed of chain ``chain`` at global draw ``n``."""
    h = _splitmix64(int(key) & _MASK64)
    h = _splitmix64(h ^ (int(chain) & _MASK64))
    h = _splitmix64(h ^ (int(n) & _MASK64))
    return h >> 1  # manual_seed takes a non-negative 63-bit value


def draw_noise(key: int, n: int, num_chains: int, dim: int,
               dtype=torch.float32, device=None):
    """Per-draw noise of every chain: ``(z, log_u)``.

    ``z`` is ``(num_chains, dim)`` standard normal (the momentum draw before
    the mass operator shapes it) and ``log_u`` is ``(num_chains,)``, the log
    of one uniform per chain for the Metropolis test.  Chain ``c`` draws
    from its own generator seeded by ``draw_seed(key, c, n)``.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    z = torch.empty((num_chains, dim), dtype=dtype, device=device)
    u = torch.empty((num_chains,), dtype=dtype, device=device)
    for c, g in enumerate(chain_ids(num_chains)):
        gen.manual_seed(draw_seed(key, g, n))
        z[c].normal_(generator=gen)
        u[c : c + 1].uniform_(generator=gen)
    return z, torch.log(u)


def draw_normals(key: int, n: int, num_chains: int, dim: int,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """``(num_chains, dim)`` standard normals; chain ``c`` from its own
    generator seeded by ``draw_seed(key, c, n)`` (the ``z`` of
    ``draw_noise`` without the uniform)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    z = torch.empty((num_chains, dim), dtype=dtype, device=device)
    for c, g in enumerate(chain_ids(num_chains)):
        gen.manual_seed(draw_seed(key, g, n))
        z[c].normal_(generator=gen)
    return z


def draw_nuts_noise(key: int, n: int, num_chains: int, dim: int, max_depth: int,
                    dtype=torch.float32, device=None) -> dict:
    """Everything one NUTS draw of every chain can use (``samplers/nuts.py``):
    ``z`` (C, dim) standard normal for the momentum, and uniforms ``u_dir``
    and ``u_merge`` (C, max_depth) and ``u_leaf`` (C, max_depth,
    2**(max_depth - 1)).  Chain ``c`` draws from its own generator seeded by
    ``draw_seed(key, c, n)``, once per draw: the tree's decisions need no
    generator of their own."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    half = 1 << (max_depth - 1)
    z = torch.empty((num_chains, dim), dtype=dtype, device=device)
    u = torch.empty((num_chains, max_depth * (2 + half)), dtype=dtype, device=device)
    for c, g in enumerate(chain_ids(num_chains)):
        gen.manual_seed(draw_seed(key, g, n))
        z[c].normal_(generator=gen)
        u[c].uniform_(generator=gen)
    return {"z": z, "u_dir": u[:, :max_depth], "u_merge": u[:, max_depth:2 * max_depth],
            "u_leaf": u[:, 2 * max_depth:].reshape(num_chains, max_depth, half)}


def draw_aux_noise(key: int, n: int, num_chains: int, kind: str, size: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Extra per-draw noise of every chain, from a generator seeded by
    ``draw_seed(key, c, AUX_STREAM + n)``: ``kind="uniform"`` gives a
    (num_chains, size) U(0, 1) tensor of ``dtype`` (RMHMC's jitter, one
    vector per transition), ``kind="perm"`` a (num_chains, size) int64
    permutation of ``range(size)`` (SPLITTING_RAND's term order, one per
    trajectory)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    if kind == "uniform":
        out = torch.empty((num_chains, size), dtype=dtype, device=device)
    elif kind == "perm":
        out = torch.empty((num_chains, size), dtype=torch.int64, device=device)
    else:
        raise ValueError(f"unknown noise kind {kind!r}; expected 'uniform' or 'perm'")
    for c, g in enumerate(chain_ids(num_chains)):
        gen.manual_seed(draw_seed(key, g, AUX_STREAM + n))
        if kind == "uniform":
            out[c].uniform_(generator=gen)
        else:
            out[c] = torch.randperm(size, generator=gen, device=device)
    return out


def draw_jitter(key: int, n: int) -> float:
    """ChEES's trajectory jitter at global draw ``n``: one U(0, 1) shared by
    every chain, from a CPU generator seeded by ``draw_seed(key, 0,
    CHEES_JITTER_STREAM + n)`` (keyed on the seed and the draw alone), as a
    host float64 value."""
    gen = torch.Generator().manual_seed(draw_seed(key, 0, CHEES_JITTER_STREAM + n))
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def sg_term_indices(key: int, step: int, num_chains: int, num_terms: int) -> list:
    """The SG-MCMC minibatch index of every chain at global step ``step``:
    ``draw_seed(key, c, SG_INDEX_STREAM + step) mod num_terms``, a
    counter-based draw on the host.  The indices are host ints, a function
    of (seed, chain, step) alone, so choosing a term never waits for the
    card; the modulo's bias is below ``num_terms / 2**63``."""
    return [draw_seed(key, c, SG_INDEX_STREAM + step) % num_terms
            for c in chain_ids(num_chains)]


def draw_sg_window(key: int, first_step: int, leaves: list, steps: int,
                   extra: int = 0) -> tuple:
    """The SG-MCMC normals of one thinning window of every chain.

    ``leaves`` are the chain state's (C, ...) leaves.  Chain ``c`` draws
    from one generator on the leaves' device seeded by ``draw_seed(key, c,
    SG_STREAM + first_step)``: for each leaf in leaf order a (steps, ...)
    block of standard normals in the leaf's dtype (one per step of the
    window), then for each leaf an (extra, ...) block (SGHMC's momentum
    refreshes falling in the window).  Returns ``(z, fresh)``, lists of
    (C, steps, ...) and (C, extra, ...) tensors in leaf order; a chunk
    that starts on a window boundary draws what the straight run draws.
    """
    device = leaves[0].device
    gen = torch.Generator(device=device)
    c_n = leaves[0].shape[0]
    z = [leaf.new_empty((c_n, steps) + tuple(leaf.shape[1:])) for leaf in leaves]
    fresh = [leaf.new_empty((c_n, extra) + tuple(leaf.shape[1:])) for leaf in leaves]
    for c, g in enumerate(chain_ids(c_n)):
        gen.manual_seed(draw_seed(key, g, SG_STREAM + first_step))
        for buf in z:
            buf[c].normal_(generator=gen)
        for buf in fresh:
            if extra:
                buf[c].normal_(generator=gen)
    return z, fresh


def draw_ladder_noise(key: int, n: int, ladder: int, lanes: int, dim: int, stream: int,
                      dtype=torch.float32, device=None) -> tuple:
    """One draw of a replica ladder at global draw ``n``: ``(z, u_mh,
    u_swap)``, a (lanes, dim) standard normal for the momenta and (lanes,)
    uniforms for the Metropolis tests and the swaps, all from ONE generator
    on ``device`` seeded by ``draw_seed(key, ladder, stream + n)``
    (``stream`` is ``PT_STREAM`` or ``TI_STREAM``)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(key, ladder, stream + n))
    z = torch.empty((lanes, dim), dtype=dtype, device=device).normal_(generator=gen)
    u = torch.empty((2, lanes), dtype=dtype, device=device).uniform_(generator=gen)
    return z, u[0], u[1]


def draw_smc_stage_noise(key: int, stage: int, steps: int, n: int, dim: int,
                         dtype=torch.float32, device=None) -> dict:
    """The device noise of SMC stage ``stage``: ``u_res`` (the systematic
    resample's uniform, 0-d), ``z`` (steps, n, dim) momentum normals and
    ``u_mh`` (steps, n) Metropolis uniforms, from one generator on
    ``device`` seeded by ``draw_seed(key, 0, SMC_STREAM + stage)``; and
    ``jit``, the ``steps`` trajectory jitters of the stage as host float64
    values from a CPU generator seeded by ``draw_seed(key, 1, SMC_STREAM +
    stage)`` (a trajectory length needs no device read)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(key, 0, SMC_STREAM + stage))
    u = torch.empty((1 + steps * n,), dtype=dtype, device=device).uniform_(generator=gen)
    z = torch.empty((steps, n, dim), dtype=dtype, device=device).normal_(generator=gen)
    host = torch.Generator().manual_seed(draw_seed(key, 1, SMC_STREAM + stage))
    jit = torch.rand((steps,), generator=host, dtype=torch.float64).tolist()
    return {"u_res": u[0], "z": z, "u_mh": u[1:].reshape(steps, n), "jit": jit}


def draw_smc_posterior_uniform(key: int) -> float:
    """The uniform of ``smc_posterior_sample``'s systematic resample, a host
    float64 value from a CPU generator seeded by ``draw_seed(key, 3,
    SMC_STREAM)``."""
    gen = torch.Generator().manual_seed(draw_seed(key, 3, SMC_STREAM))
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def stream_generator(key: int, stream: int, n: int, device=None, slot: int = 0
                     ) -> torch.Generator:
    """ONE generator on ``device`` (the CPU when None) seeded by
    ``draw_seed(key, slot, stream + n)``: the noise of every chain of draw
    ``n`` of a stream.  Callers draw with ``device=gen.device`` and move the
    result to their own device, so a CPU generator put in its place (as the
    card tests do) gives the card the CPU's numbers."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(key, slot, stream + n))
    return gen
