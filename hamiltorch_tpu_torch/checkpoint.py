"""Chunked sampling with checkpoint/resume.

Counterpart of ``hamiltorch_tpu/checkpoint.py`` for the families the port
has: single-chain and batched HMC (``run_hmc_checkpointed``,
``run_hmc_chains_checkpointed``), tree-doubling NUTS
(``run_nuts_checkpointed``) and its pooled ensemble
(``run_nuts_ensemble_checkpointed``), MCLMC (``run_mclmc_checkpointed``),
MAMS (``run_mams_checkpointed``), RMHMC (``run_rmhmc_checkpointed``),
split HMC (``run_split_hmc_checkpointed``), ChEES (``run_chees_checkpointed``),
SG-MCMC (``run_sgld_checkpointed``, ``run_sghmc_checkpointed``), parallel
tempering (``run_pt_checkpointed``, one ladder or ensembles),
thermodynamic integration (``run_ti_checkpointed``), the Barker proposal
(``run_barker_checkpointed``) and the stretch move
(``run_stretch_checkpointed``): all fifteen drivers of the JAX module.
Sampling proceeds in chunks; after every chunk its trace goes to
``chunk_XXXXXXXX.npz`` and the whole resume carry (chain state with its
cached potential evaluation, dual averaging, the windowed-warmup carry where
there is one, MCLMC's tuned (eps, L) and velocity, ChEES's trajectory
adaptation, SGHMC's momentum or pSGLD's accumulator, PT's ladder,
Barker's Welford state, the stretch move's walkers) to ``state.npz``,
written atomically, with the integer seed and the draw
counter.  Calling again with the same arguments continues where the last
completed chunk stopped.

Every draw's noise is keyed on (seed, chain, global draw index)
(``utils/rng.py``) and the port runs eagerly, so a resumed or chunked run
equals the straight run bit for bit at ANY chunking (the JAX package
promises it at the same chunking only: its chunked and straight programs
compile differently).

Safety: the state file holds a fingerprint of the configuration (the
fields that change the stream), the chain's shape, dtype and tree
structure, and this package's name: resuming a directory written under
other arguments, or by the JAX package, raises ``ValueError`` instead of
splicing two runs.  The files are the port's own format: numpy archives of
tensors, bfloat16 stored as its 16-bit pattern (numpy has no bfloat16) and
restored exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from .samplers.adaptation import DualAveragingState, da_init
from .samplers.driver import ChainState, MCMCResult, MCMCStats
from .utils.convert import place_start
from .utils.pytree import is_param_tree, tree_leaves, tree_map, tree_structure, tree_unflatten_like

PACKAGE = "hamiltorch_tpu_torch"
_STATE_FILE = "state.npz"
# the names of the entries of an archive stored as bfloat16 bit patterns
_BF16 = "_bfloat16_entries"

# config fields that do not change the sampled stream: changing them
# between resumes must not invalidate the checkpoint
_COSMETIC_FIELDS = {"num_samples", "progress_every"}


def _fingerprint(config, theta0, extra=None) -> str:
    """Stable hash of the configuration, the chain's shape, dtype and tree
    structure, ``extra`` (other stream-changing options, by repr) and this
    package's name."""
    if is_param_tree(theta0):
        leaves = tree_leaves(theta0)
        shape = [list(leaf.shape) for leaf in leaves]
        dtype = [str(leaf.dtype) for leaf in leaves]
        tdef = repr(tree_structure(theta0))
    else:
        shape, dtype, tdef = list(theta0.shape), str(theta0.dtype), None
    payload = {
        "package": PACKAGE,
        "config_type": type(config).__name__,
        "config": {
            f.name: repr(getattr(config, f.name))
            for f in dataclasses.fields(config)
            if f.name not in _COSMETIC_FIELDS
        },
        "theta_shape": shape,
        "theta_dtype": dtype,
        "extra": repr(extra),
    }
    if tdef is not None:
        payload["theta_treedef"] = tdef
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _np_savable(t: torch.Tensor) -> tuple[np.ndarray, bool]:
    """(host array, is_bfloat16): a tensor as numpy can store it; a bfloat16
    tensor as its 16-bit pattern, which ``_tensor_of`` turns back exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), True
    return t.numpy(), False


def _archive(entries: dict) -> dict:
    """``np.savez`` keyword arguments for ``{name: tensor}``."""
    out, bf16 = {}, []
    for name, t in entries.items():
        out[name], is_bf16 = _np_savable(t)
        if is_bf16:
            bf16.append(name)
    out[_BF16] = np.asarray(bf16, dtype=str)
    return out


def _tensor_of(z, name: str) -> torch.Tensor:
    """Entry ``name`` of an archive written by ``_archive`` as a CPU tensor."""
    a = z[name]
    if name in set(z[_BF16].tolist()):
        return torch.from_numpy(np.array(a, copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _save_state(path: str, carry, seed: int, n_done: int, fingerprint: str) -> None:
    tmp = path + ".tmp.npz"  # keep .npz so np.savez appends nothing
    entries = {f"leaf_{i}": leaf for i, leaf in enumerate(tree_leaves(carry))}
    np.savez(tmp, n_done=np.asarray(n_done), seed=np.asarray(str(int(seed))),
             fingerprint=np.asarray(fingerprint), **_archive(entries))
    os.replace(tmp, path)


def _load_state(path: str, carry_template, fingerprint: str):
    """(carry, seed, n_done) of a state file; each leaf takes the device and
    dtype of the template's."""
    z = np.load(path)
    if "fingerprint" not in z.files or str(z["fingerprint"]) != fingerprint:
        raise ValueError(
            f"checkpoint at {path} was written under a different configuration "
            "(config/shape/dtype/package fingerprint mismatch); pass resume=False "
            "to start over, or restore the original arguments to continue that run."
        )
    template = tree_leaves(carry_template)
    leaves = [_tensor_of(z, f"leaf_{i}").to(device=t.device, dtype=t.dtype)
              for i, t in enumerate(template)]
    return tree_unflatten_like(carry_template, leaves), int(str(z["seed"])), int(z["n_done"])


def _flatten_chunk_dict(d: dict) -> dict:
    """``{name: tensor}`` of a chunk: a tree value (a tree state's trace)
    becomes per-leaf ``<name>__leaf_<i>`` entries."""
    out = {}
    for k, v in d.items():
        leaves = tree_leaves(v)
        if len(leaves) == 1 and leaves[0] is v:
            out[k] = v
        else:
            out.update({f"{k}__leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    return out


def _checkpoint_loop(chunk_runner, key: int, carry_template, init_carry_fn, config,
                     ckpt_dir: str, chunk_size: int, resume: bool, fingerprint: str,
                     save_chunk, mesh=None):
    """Run chunks until ``config.num_samples`` draws are done.

    ``chunk_runner(seed, carry, n_done, cfg) -> (result, new_carry)``;
    ``save_chunk(result) -> {name: tensor or tree}`` for the chunk file.
    ``carry_template`` has the carry's structure, devices and dtypes (it
    places a loaded state); ``init_carry_fn()`` computes the real initial
    carry (it may evaluate the potential, so it runs only when NOT
    resuming).  Returns the chunk archives (oldest first) and the final
    carry.

    On a ``mesh`` every rank runs the loop and holds the same global
    result and carry; rank 0 alone writes ``ckpt_dir`` (a directory every
    rank reads), and the ranks meet at a barrier after each write.
    """
    writer, sync = True, (lambda: None)
    if mesh is not None:
        import torch.distributed as dist

        writer = dist.get_rank() == 0
        sync = dist.barrier
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    sync()
    state_path = os.path.join(ckpt_dir, _STATE_FILE)
    resuming = resume and os.path.exists(state_path)
    sync()  # every rank has looked before rank 0 cleans the directory
    if resuming:
        carry, seed, n_done = _load_state(state_path, carry_template, fingerprint)
    else:
        if writer:
            for f in os.listdir(ckpt_dir):
                if f.startswith("chunk_") or f == _STATE_FILE:
                    os.remove(os.path.join(ckpt_dir, f))
        carry, seed, n_done = init_carry_fn(), key, 0

    # chunks hold whole thinning windows
    thin = max(getattr(config, "thin", 1), 1)
    chunk_size = max(thin, (chunk_size // thin) * thin)
    progress = getattr(config, "progress_every", 0)
    t0, n_start = time.time(), n_done
    while n_done < config.num_samples:
        this_chunk = min(chunk_size, config.num_samples - n_done)
        overrides = {"num_samples": this_chunk}
        if progress:
            # the loop reports per completed chunk instead of per draw
            overrides["progress_every"] = 0
        cfg = dataclasses.replace(config, **overrides)
        result, carry = chunk_runner(seed, carry, n_done, cfg)
        if writer:
            np.savez(os.path.join(ckpt_dir, f"chunk_{n_done:08d}.npz"),
                     **_archive(_flatten_chunk_dict(save_chunk(result))))
        n_done += this_chunk
        if writer:
            _save_state(state_path, carry, seed, n_done, fingerprint)
        sync()
        if progress and writer:
            rate = (n_done - n_start) / max(time.time() - t0, 1e-9)
            print(f"checkpoint: {n_done}/{config.num_samples} draws saved "
                  f"({rate:,.1f} draws/sec)")

    chunks = sorted(f for f in os.listdir(ckpt_dir)
                    if f.startswith("chunk_") and f.endswith(".npz"))
    return [np.load(os.path.join(ckpt_dir, f)) for f in chunks], carry


def _cat(zs, name: str, axis: int, kept: int, device, like=None):
    """Entry ``name`` of every chunk joined along ``axis``, cut to ``kept``
    rows, on ``device``; a tree entry is rebuilt like ``like``."""
    take = (slice(None),) * axis + (slice(None, kept),)

    def one(entry):
        return torch.cat([_tensor_of(z, entry) for z in zs], dim=axis)[take].to(device)

    if name in zs[0].files:
        return one(name)
    return tree_unflatten_like(like, [one(f"{name}__leaf_{i}")
                                      for i in range(len(tree_leaves(like)))])


def _da_tuple(da: DualAveragingState) -> tuple:
    return (da.step_size, da.log_eps_bar, da.h_t, da.mu)


def _da_of(t) -> DualAveragingState:
    return DualAveragingState(*t)


def _assemble_mcmc(zs, config, carry, time_axis: int = 0, acc_from_prob: bool = False):
    """The chunk archives as one MCMCResult; ``carry`` is ``(state, da
    tuple[, warm])`` in the result's layout.  A directory from a longer run
    may hold more draws: exactly the draws this config asks for come back.
    """
    state, da = carry[0], _da_of(carry[1])
    device = tree_leaves(state.theta)[0].device
    kept = config.num_samples // max(getattr(config, "thin", 1), 1)
    samples = _cat(zs, "samples", time_axis, kept, device, like=state.theta)
    stats = MCMCStats(**{f: _cat(zs, f, time_axis, kept, device) for f in MCMCStats._fields})
    if acc_from_prob:
        acc_rate = torch.mean(stats.accept_prob, dim=time_axis)
    else:
        # transition-weighted mean of the chunks' rates: with thin > 1 the
        # stats hold each window's last transition only
        remaining, num = kept, 0.0
        for z in zs:
            rows = z["accepted"].shape[time_axis]
            take = min(rows, remaining)
            if take == rows:
                rate = _tensor_of(z, "acc_rate").double().numpy()
            else:  # a boundary chunk of a longer run: the kept rows' outcomes
                acc = np.asarray(z["accepted"], np.float64)
                rate = np.mean(acc[(slice(None),) * time_axis + (slice(None, take),)],
                               axis=time_axis)
            num = num + rate * take
            remaining -= take
            if remaining <= 0:
                break
        acc_rate = torch.as_tensor(num / max(kept, 1), dtype=stats.energy_old.dtype,
                                   device=device)
    return MCMCResult(samples=samples, stats=stats, final_step_size=da.step_size,
                      acc_rate=acc_rate, final_state=state, final_da=da,
                      final_warm=carry[2] if len(carry) > 2 else None)


def _mcmc_chunk_fields(result: MCMCResult) -> dict:
    out = {"samples": result.samples}
    out.update({f: getattr(result.stats, f) for f in MCMCStats._fields})
    out["acc_rate"] = result.acc_rate  # the chunk's exact rate (thin-aware)
    return out


def _chain_state_template(theta) -> ChainState:
    """The structure of a batch's ChainState (leading chain axis), no
    potential evaluation."""
    leaf = tree_leaves(theta)[0]
    return ChainState(theta, leaf.new_zeros(leaf.shape[:1]), tree_map(torch.zeros_like, theta))


def _first(tree):
    """A one-chain batch's tree without its chain axis."""
    return tree_map(lambda t: t[0], tree)


def _hmc_runner(key, lp, theta0, config, mass, ckpt_dir, chunk_size, resume, one_chain: bool):
    """The checkpoint loop of ``_run_hmc_batched`` over the chains of
    ``theta0`` (leading axis); the carry holds the batch's state, dual
    averaging and, with windowed warmup, its carry."""
    from .samplers.hmc import _first_chain, _run_hmc_batched, init_chain_state
    from .samplers.nuts import init_metric_seed
    from .samplers.warmup import schedule_flags

    leaves = tree_leaves(theta0)
    c, dtype, device = leaves[0].shape[0], leaves[0].dtype, leaves[0].device
    windowed = bool(config.adapt_mass) and config.burn > 0
    da0 = _da_tuple(da_init(torch.full((c,), config.step_size, dtype=dtype, device=device),
                            dtype=dtype, device=device))
    tail = ()
    if windowed:
        template = getattr(mass, "template", None)
        seed_mass = mass.inner if template is not None else mass
        dim = sum(leaf[0].numel() for leaf in leaves)
        wf0, metric0 = init_metric_seed(seed_mass, dim, dtype, config.adapt_mass == "dense",
                                        device, (c,))
        tail = ((wf0, metric0, torch.zeros(c, dtype=torch.int32, device=device)),)

    def init_carry_fn():
        states = torch.func.vmap(lambda t: init_chain_state(lp, t))(theta0)
        return (states, da0) + tail

    def chunk_runner(seed, carry, n_done, cfg):
        cf = ef = None
        if windowed:
            # each chunk takes its slice of the GLOBAL warmup schedule
            cf, ef = schedule_flags(config.burn, n_done, cfg.num_samples)
        res = _run_hmc_batched(seed, theta0, lp, cfg, mass, init_state=carry[0],
                               init_da=_da_of(carry[1]), start_iter=n_done,
                               init_warm=carry[2] if windowed else None,
                               collect_flags=cf, end_flags=ef)
        new = (res.final_state, _da_tuple(res.final_da)) + ((res.final_warm,) if windowed else ())
        return (_first_chain(res) if one_chain else res), new

    fp = _fingerprint(config, _first(theta0) if one_chain else theta0)
    zs, carry = _checkpoint_loop(chunk_runner, key, (_chain_state_template(theta0), da0) + tail,
                                 init_carry_fn, config, ckpt_dir, chunk_size, resume, fp,
                                 _mcmc_chunk_fields)
    if one_chain:
        return _assemble_mcmc(zs, config, _first(carry))
    return _assemble_mcmc(zs, config, carry, time_axis=1)


def run_hmc_checkpointed(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config,  # MCMCConfig
    ckpt_dir: str,
    chunk_size: int = 100,
    inv_mass=None,
    pass_grad=None,
    resume: bool = True,
) -> MCMCResult:
    """HMC (``run_hmc``) with per-chunk checkpointing into ``ckpt_dir``.

    Interrupt at any point; calling again with ``resume=True`` (the default)
    continues from the last completed chunk and returns the whole result,
    ``run_hmc``'s with the same key bit for bit (``acc_rate`` within
    rounding: it is summed per chunk).  ``theta0`` is a flat tensor or a
    parameter tree; a start that is not a tensor goes to the card.
    """
    from .samplers.hmc import _one_chain

    lp, stacked, mass = _one_chain(log_prob_fn, theta0, config, inv_mass, pass_grad)
    return _hmc_runner(key, lp, stacked, config, mass, ckpt_dir, chunk_size, resume, True)


def run_hmc_chains_checkpointed(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config,  # MCMCConfig
    ckpt_dir: str,
    num_chains: int,
    chunk_size: int = 100,
    inv_mass=None,
    pass_grad=None,
    resume: bool = True,
    theta0_is_stacked: bool | None = None,
) -> MCMCResult:
    """Batched HMC chains (``run_hmc_chains``) with per-chunk checkpointing;
    samples and stats come back chain-major as from ``run_hmc_chains``, bit
    for bit."""
    from .ops.potential import resolve_potential
    from .samplers.hmc import _mass_for
    from .utils.pytree import stack_param_tree

    lp = resolve_potential(log_prob_fn, pass_grad)
    theta0 = place_start(theta0)
    if is_param_tree(theta0):
        template, theta0 = stack_param_tree(theta0, num_chains, stacked=theta0_is_stacked)
    else:
        template = None
        if theta0.ndim == 1:
            theta0 = theta0.expand((num_chains,) + tuple(theta0.shape)).clone()
    mass = _mass_for(theta0, template, inv_mass, config)
    return _hmc_runner(key, lp, theta0, config, mass, ckpt_dir, chunk_size, resume, False)


def _single_chain_runner(key, stacked, config, ckpt_dir, chunk_size, resume, extra,
                         init_logp, run_batched):
    """The checkpoint loop of a single-chain sampler whose batched runner
    ``run_batched(seed, cfg, state, da, n_done)`` continues a chunk from its
    (state, dual averaging) carry; ``init_logp`` evaluates the start's
    log-prob over the chain axis of ``stacked`` (1 chain).  ``extra`` enters
    the fingerprint."""
    from .samplers.hmc import _first_chain

    leaf = tree_leaves(stacked)[0]
    da0 = _da_tuple(da_init(torch.full((1,), config.step_size, dtype=leaf.dtype,
                                       device=leaf.device), dtype=leaf.dtype, device=leaf.device))

    def init_carry_fn():
        return (ChainState(stacked, init_logp(stacked), tree_map(torch.zeros_like, stacked)),
                da0)

    def chunk_runner(seed, carry, n_done, cfg):
        res = run_batched(seed, cfg, carry[0], _da_of(carry[1]), n_done)
        return _first_chain(res), (res.final_state, _da_tuple(res.final_da))

    zs, carry = _checkpoint_loop(chunk_runner, key, (_chain_state_template(stacked), da0),
                                 init_carry_fn, config, ckpt_dir, chunk_size, resume,
                                 _fingerprint(config, _first(stacked), extra=extra),
                                 _mcmc_chunk_fields)
    return _assemble_mcmc(zs, config, _first(carry))


def run_split_hmc_checkpointed(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config,  # MCMCConfig
    ckpt_dir: str,
    chunk_size: int = 100,
    integrator=None,
    inv_mass=None,
    data=None,
    pass_grad=None,
    resume: bool = True,
) -> MCMCResult:
    """Symmetric-split minibatch HMC (``run_split_hmc_stacked``) with
    per-chunk checkpointing: ``term_fn(theta, m[, data])`` one term, the
    stacked data passed as ``data``.  The splitting scheme and the number of
    terms enter the fingerprint.  ``theta0`` may be a parameter tree (with a
    tree-taking ``term_fn``; diagonal metrics only).  Bit for bit the
    straight run at any chunking."""
    from .enums import Integrator
    from .samplers.splitting import _prepare_one, _run_split_batched, stacked_total_logp

    integrator = Integrator.SPLITTING if integrator is None else integrator
    stacked, mass = _prepare_one(theta0, inv_mass)

    def run_batched(seed, cfg, state, da, n_done):
        return _run_split_batched(seed, stacked, term_fn, num_terms, cfg, integrator, mass,
                                  data, pass_grad=pass_grad, init_state=state, init_da=da,
                                  start_iter=n_done)

    return _single_chain_runner(
        key, stacked, config, ckpt_dir, chunk_size, resume, (integrator, num_terms),
        torch.func.vmap(stacked_total_logp(term_fn, num_terms, data)), run_batched)


def run_rmhmc_checkpointed(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config,  # MCMCConfig
    ckpt_dir: str,
    chunk_size: int = 50,
    resume: bool = True,
    **rmhmc_kwargs,
) -> MCMCResult:
    """RMHMC (``run_rmhmc``, a flat ``theta0``) with per-chunk
    checkpointing: the sampler where resume matters most, its implicit
    fixed points making it the slowest per draw.  ``rmhmc_kwargs`` go to the
    sampler (``integrator``, ``metric``, ``jitter``, ``softabs_const``,
    ``explicit_binding_const``, ``fixed_point_threshold``,
    ``fixed_point_max_iterations``, ``ham_func``, ``custom_metric``); the
    integrator and the metric options enter the fingerprint.  Bit for bit
    the straight run at any chunking."""
    from .ops.potential import resolve_potential
    from .samplers.rmhmc import _run_rmhmc_batched, resolve_rmhmc_options

    stacked = place_start(theta0)[None]
    lp = resolve_potential(log_prob_fn)
    integrator, opts, ham_func, custom_metric = resolve_rmhmc_options(rmhmc_kwargs)

    def run_batched(seed, cfg, state, da, n_done):
        return _run_rmhmc_batched(seed, stacked, lp, cfg, integrator, opts, ham_func,
                                  custom_metric, init_state=state, init_da=da,
                                  start_iter=n_done)

    return _single_chain_runner(key, stacked, config, ckpt_dir, chunk_size, resume,
                                (integrator, opts), torch.func.vmap(lp), run_batched)


def _nuts_carry(theta0, config, mass, pooled: bool):
    """(template, da0 tuple, warm0) of a NUTS batch: the carry's seed, as
    ``_run_nuts_batched`` builds it."""
    from .samplers.nuts import init_metric_seed

    leaves = tree_leaves(theta0)
    c, dtype, device = leaves[0].shape[0], leaves[0].dtype, leaves[0].device
    batch = () if pooled else (c,)
    windowed = bool(config.adapt_mass) and config.burn > 0
    template = getattr(mass, "template", None)
    seed_mass = mass.inner if template is not None else mass
    dim = sum(leaf[0].numel() for leaf in leaves)
    wf0, metric0 = init_metric_seed(seed_mass, dim, dtype,
                                    windowed and config.adapt_mass == "dense", device, batch)
    da0 = _da_tuple(da_init(torch.full(batch, config.step_size, dtype=dtype, device=device),
                            dtype=dtype, device=device))
    return da0, (wf0, metric0, torch.zeros(batch, dtype=torch.int32, device=device))


def _nuts_chunk_runner(lp, theta0, config, mass, pooled: bool, mesh=None, num_chains=None):
    """A chunk of NUTS chains; on a ``mesh`` (the pooled ensemble) each rank
    runs its rows of the global carry and the chunk is gathered."""
    from .samplers.nuts import _run_nuts_batched
    from .samplers.warmup import schedule_flags

    windowed = bool(config.adapt_mass) and config.burn > 0
    if mesh is not None:
        from .parallel import sharding

        _, group = sharding.mesh_chain_layout(mesh, num_chains)
        lo, n = sharding._local_chains(mesh, "mesh", num_chains)
        keys = sharding.derive_chain_keys(None, num_chains)[lo:lo + n]

    def chunk_runner(seed, carry, n_done, cfg):
        collect, end = schedule_flags(config.burn if windowed else 0, n_done, cfg.num_samples)
        if mesh is None:
            res, info = _run_nuts_batched(seed, theta0, lp, cfg, mass, pooled=pooled,
                                          init_state=carry[0], init_da=_da_of(carry[1]),
                                          start_iter=n_done, init_warm=carry[2],
                                          collect_flags=collect, end_flags=end)
        else:
            state = ChainState(*(sharding._rows(f, lo, n) for f in carry[0]))
            res, info = _run_nuts_batched(seed, sharding._rows(theta0, lo, n), lp, cfg, mass,
                                          pooled=True, init_state=state,
                                          init_da=_da_of(carry[1]), start_iter=n_done,
                                          init_warm=carry[2], collect_flags=collect,
                                          end_flags=end, chain_keys=keys, axis_name=group)
            res, info = sharding.gather_chains((res, info), mesh, "mesh",
                                               sharding.pooled_nuts_batch_spec)
        return (res, info), (res.final_state, _da_tuple(res.final_da), res.final_warm)

    return chunk_runner


def _nuts_init_fn(lp, theta0, da0, warm0):
    from .ops.potential import value_and_grad

    def init_carry_fn():
        logp, grad = torch.func.vmap(value_and_grad(lp))(theta0)
        return (ChainState(theta0, logp, grad), da0, warm0)

    return init_carry_fn


def run_nuts_checkpointed(
    key: int,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0,
    config,  # NUTSConfig
    ckpt_dir: str,
    chunk_size: int = 100,
    inv_mass=None,
    resume: bool = True,
) -> MCMCResult:
    """Tree-doubling NUTS (``run_nuts``) with per-chunk checkpointing.

    ``adapt_mass`` windowed warmup resumes exactly: the Welford state, the
    metric and the window-relative dual-averaging counter are in the state
    file, and each chunk takes its slice of the global window schedule.
    Returns the MCMCResult (the per-draw NUTSInfo beyond MCMCStats is not
    kept), ``run_nuts``'s bit for bit; ``acc_rate`` is the mean acceptance
    statistic.
    """
    from .ops.potential import resolve_potential
    from .samplers.hmc import _first_chain
    from .samplers.nuts import _prepare_one

    lp = resolve_potential(log_prob_fn, None)
    stacked, mass = _prepare_one(theta0, config, inv_mass)
    da0, warm0 = _nuts_carry(stacked, config, mass, pooled=False)
    run = _nuts_chunk_runner(lp, stacked, config, mass, pooled=False)

    def chunk_runner(seed, carry, n_done, cfg):
        (res, _), new = run(seed, carry, n_done, cfg)
        return res, new

    zs, carry = _checkpoint_loop(
        chunk_runner, key, (_chain_state_template(stacked), da0, warm0),
        _nuts_init_fn(lp, stacked, da0, warm0), config, ckpt_dir, chunk_size, resume,
        _fingerprint(config, _first(stacked)),
        lambda res: _mcmc_chunk_fields(_first_chain(res)))
    # NUTS has no Metropolis test: the rate is the mean acceptance statistic
    return _assemble_mcmc(zs, config, _first(carry), acc_from_prob=True)


def run_nuts_ensemble_checkpointed(
    key: int,
    log_prob_fn,
    theta0,
    config,  # NUTSConfig
    ckpt_dir: str,
    num_chains: int = 16,
    chunk_size: int = 100,
    inv_mass=None,
    resume: bool = True,
    mesh=None,
    theta0_is_stacked: bool | None = None,
):
    """Pooled-adaptation ensemble NUTS (``run_nuts_ensemble``) with per-chunk
    checkpointing.  The pooled carry (chain states with their potential
    evaluations, the shared dual averaging, the Chan-merged Welford state
    and the window-relative counter) is in the state file, and each chunk
    takes its slice of the global warmup schedule.  Returns (MCMCResult,
    NUTSInfo) in ``run_nuts_ensemble``'s layout, bit for bit.

    ``mesh``: shard the ensemble over a ``parallel.sharding.make_mesh`` mesh
    per chunk (``run_nuts_ensemble_sharded``, pooled sums all-reduced over
    every rank); every rank holds the global carry and result, and the
    result is ``run_nuts_ensemble_sharded``'s bit for bit at any chunking.
    Sharded and unsharded checkpoints carry distinct fingerprints (the
    all-reduce reassociates the pooled sums).
    """
    from .ops.potential import resolve_potential
    from .samplers.nuts import NUTSInfo, _prepare_chains, _time_major

    lp = resolve_potential(log_prob_fn, None)
    theta0, mass = _prepare_chains(theta0, config, num_chains, inv_mass, theta0_is_stacked)
    da0, warm0 = _nuts_carry(theta0, config, mass, pooled=True)
    run = _nuts_chunk_runner(lp, theta0, config, mass, pooled=True, mesh=mesh,
                             num_chains=num_chains)

    def chunk_runner(seed, carry, n_done, cfg):
        (res, info), new = run(seed, carry, n_done, cfg)
        return _time_major(res, info), new

    def save_chunk(chunk):
        res, info = chunk
        out = {"samples": res.samples, "accepted": res.stats.accepted}
        out.update({f: getattr(info, f) for f in NUTSInfo._fields})
        return out

    zs, carry = _checkpoint_loop(
        chunk_runner, key, (_chain_state_template(theta0), da0, warm0),
        _nuts_init_fn(lp, theta0, da0, warm0), config, ckpt_dir, chunk_size, resume,
        _fingerprint(config, theta0, extra=None if mesh is None else "sharded"), save_chunk,
        mesh=mesh)
    state, da = carry[0], _da_of(carry[1])
    device = tree_leaves(state.theta)[0].device
    kept = config.num_samples // config.thin
    info = NUTSInfo(**{f: _cat(zs, f, 0, kept, device) for f in NUTSInfo._fields})
    stats = MCMCStats(
        accept_prob=info.accept_prob,
        accepted=_cat(zs, "accepted", 0, kept, device),
        divergent=info.divergent,
        energy_old=info.energy,
        energy_new=info.energy_new,
        step_size=info.step_size,
        fp_iters=torch.zeros_like(info.tree_depth),
        fp_residual=torch.zeros_like(info.accept_prob),
    )
    return MCMCResult(
        samples=_cat(zs, "samples", 1, kept, device, like=state.theta),
        stats=stats,
        final_step_size=da.step_size,
        acc_rate=info.accept_prob.mean(),
        final_state=state,
        final_da=da,
        final_warm=carry[2],
    ), info


def run_mclmc_checkpointed(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config,  # MCLMCConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    data=None,
    resume: bool = True,
    pass_grad=None,
):
    """MCLMC (``run_mclmc``) with per-chunk checkpointing.

    The FIRST chunk runs the tuning phase (``config.tune_steps``); the tuned
    (eps, L) and the velocity are in the state file and every later chunk
    runs frozen from them.  Each step's noise is keyed on the global step
    index, so the assembled trace is ``run_mclmc``'s with the same key bit
    for bit.  ``chunk_size`` counts transitions (rounded to a ``thin``
    multiple); ``theta0`` may be flat or a parameter tree.
    """
    from .samplers.mclmc import (
        MCLMCResult,
        MCLMCStats,
        _bind_data,
        _prep_flat,
        _run_chains,
        _seed_scales,
    )

    theta0 = place_start(theta0)
    theta0f, fn, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    theta = theta0f[None]
    eps0, length0 = _seed_scales(config, theta0f.shape[0], 1, theta0f.device)
    # (theta, u, eps, L); the velocity is a placeholder until the first chunk
    # has run (the straight run draws it inside from the seed)
    carry0 = (theta, torch.zeros_like(theta), eps0, length0)

    def chunk_runner(seed, carry, n_done, cfg):
        x, u, eps, length = carry
        if n_done == 0:
            r = _run_chains(seed, x, eps, length, fn, cfg)
        else:
            r = _run_chains(seed, x, eps, length, fn, dataclasses.replace(cfg, tune_steps=0),
                            init_u=u, start_step=n_done)
        return r, (r.final_theta, r.final_u, r.step_size, r.trajectory_length)

    def save_chunk(r):
        out = {"samples": r.samples[0]}
        out.update({f: getattr(r.stats, f)[0] for f in MCLMCStats._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, carry0, lambda: carry0, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0, extra="mclmc"), save_chunk)
    kept = config.num_samples // config.thin
    device = theta0f.device
    x, u, eps, length = _first(carry)
    samples = _cat(zs, "samples", 0, kept, device)
    stats = MCLMCStats(**{f: _cat(zs, f, 0, kept, device) for f in MCLMCStats._fields})
    if unravel is not None:
        samples, x = unravel(samples), unravel(x)
    return MCLMCResult(samples=samples, stats=stats, step_size=eps, trajectory_length=length,
                       final_theta=x, final_u=u,
                       final_step=torch.tensor(config.num_samples, dtype=torch.int32,
                                               device=device))


def run_mams_checkpointed(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config,  # MAMSConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    data=None,
    resume: bool = True,
    pass_grad=None,
):
    """MAMS (``run_mams``) with per-chunk checkpointing.

    The dual-averaging state is in the state file; ``config.burn`` is a
    global draw index, so adaptation continues across chunk boundaries and
    freezes at the straight run's draw.  Each draw's noise is keyed on the
    global index: the assembled trace is ``run_mams``'s with the same key
    bit for bit.  ``chunk_size`` counts draws (rounded to a ``thin``
    multiple); ``theta0`` may be flat or a parameter tree.
    """
    from .samplers.mams import MAMSResult, MAMSStats, _run_chains
    from .samplers.mclmc import _bind_data, _prep_flat

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0 = place_start(theta0)
    theta0f, fn, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    device = theta0f.device
    da0 = _da_tuple(da_init(torch.full((1,), config.step_size, dtype=torch.float32,
                                       device=device)))
    carry0 = (theta0f[None], da0)

    def chunk_runner(seed, carry, n_done, cfg):
        r = _run_chains(seed, carry[0], fn, cfg, init_da=_da_of(carry[1]), start_step=n_done)
        return r, (r.final_theta, _da_tuple(r.final_da))

    def save_chunk(r):
        out = {"samples": r.samples[0]}
        out.update({f: getattr(r.stats, f)[0] for f in MAMSStats._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, carry0, lambda: carry0, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0, extra="mams"), save_chunk)
    kept = config.num_samples // config.thin
    x, da = _first(carry[0]), _da_of(_first(carry[1]))
    samples = _cat(zs, "samples", 0, kept, device)
    stats = MAMSStats(**{f: _cat(zs, f, 0, kept, device) for f in MAMSStats._fields})
    burn_kept = config.burn // config.thin
    acc_rate = (stats.accept_prob[burn_kept:] if kept > burn_kept else stats.accept_prob).mean()
    if unravel is not None:
        samples, x = unravel(samples), unravel(x)
    return MAMSResult(samples=samples, stats=stats,
                      step_size=torch.exp(da.log_eps_bar) if config.adapt_step_size
                      else da.step_size,
                      acc_rate=acc_rate, final_theta=x, final_da=da,
                      final_step=torch.tensor(config.num_samples, dtype=torch.int32,
                                              device=device))


def run_chees_checkpointed(
    key: int,
    log_prob_fn,
    theta0,
    config,  # ChEESConfig
    ckpt_dir: str,
    num_chains: int = 16,
    chunk_size: int = 100,
    inv_mass=None,
    resume: bool = True,
    mesh=None,
    theta0_is_stacked: bool | None = None,
):
    """ChEES-HMC (``run_chees``) with per-chunk checkpointing of the whole
    adaptation carry (the ensemble with its potential evaluations, the
    trajectory length's Adam state, dual averaging, the Welford window and
    the metric).  Each chunk takes its slice of the global warmup schedule;
    a single start is spread from the key as ``run_chees`` spreads it.
    Returns a ChEESResult, ``run_chees``'s bit for bit at any chunking
    (``chunk_size`` rounds to a multiple of ``thin``).

    ``mesh``: shard the ensemble over a ``parallel.sharding.make_mesh`` mesh
    per chunk (``run_chees_sharded``); every rank holds the global carry
    and result, ``run_chees_sharded``'s bit for bit at any chunking.
    Sharded and unsharded checkpoints carry distinct fingerprints.
    """
    from .ops.potential import resolve_potential, value_and_grad
    from .samplers.chees import (
        ChEESInfo,
        ChEESResult,
        _run_chees,
        init_chees_carry,
        prepare_chees,
    )
    from .samplers.warmup import schedule_flags

    lp = resolve_potential(log_prob_fn, None)
    theta0s, mass = prepare_chees(key, theta0, config, num_chains, inv_mass, theta0_is_stacked)
    windowed = bool(config.adapt_mass) and config.burn > 0

    # the state file holds the dual-averaging state as a tuple of tensors
    def stored(carry):
        return carry._replace(da=_da_tuple(carry.da))

    def restored(carry):
        return carry._replace(da=_da_of(carry.da))

    leaf = tree_leaves(theta0s)[0]
    template = stored(init_chees_carry(theta0s, leaf.new_zeros(leaf.shape[:1]),
                                       tree_map(torch.zeros_like, theta0s), config, mass))

    def init_carry_fn():
        logps, grads = torch.func.vmap(value_and_grad(lp))(theta0s)
        return stored(init_chees_carry(theta0s, logps, grads, config, mass))

    if mesh is not None:
        from .parallel import sharding

        _, group = sharding.mesh_chain_layout(mesh, num_chains)
        lo, n = sharding._local_chains(mesh, "mesh", num_chains)
        keys = sharding.derive_chain_keys(key, num_chains)[lo:lo + n]

    def chunk_runner(seed, carry, n_done, cfg):
        collect, end = schedule_flags(config.burn if windowed else 0, n_done, cfg.num_samples)
        if mesh is None:
            res = _run_chees(seed, theta0s, lp, cfg, mass, init_carry=restored(carry),
                             start_iter=n_done, collect_flags=collect, end_flags=end)
        else:
            local = restored(carry)._replace(**{f: sharding._rows(getattr(carry, f), lo, n)
                                                for f in ("thetas", "logps", "grads")})
            res = _run_chees(seed, sharding._rows(theta0s, lo, n), lp, cfg, mass,
                             init_carry=local, start_iter=n_done, collect_flags=collect,
                             end_flags=end, chain_keys=keys, axis_name=group)
            res = sharding.gather_chains(res, mesh, "mesh", sharding.chees_spec)
        return res, stored(res.final_carry)

    def save_chunk(res):
        out = {"samples": res.samples}
        out.update({f: getattr(res.info, f) for f in ChEESInfo._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, template, init_carry_fn, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0s,
                                              extra=None if mesh is None else "sharded"),
                                 save_chunk, mesh=mesh)
    carry = restored(carry)
    kept = config.num_samples // max(config.thin, 1)
    device = leaf.device
    return ChEESResult(
        samples=_cat(zs, "samples", 1, kept, device, like=carry.thetas),
        info=ChEESInfo(**{f: _cat(zs, f, 0, kept, device) for f in ChEESInfo._fields}),
        final_step_size=carry.da.step_size,
        final_trajectory_length=torch.exp(carry.log_t),
        final_carry=carry,
    )


def run_sgld_checkpointed(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config,  # SGLDConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    inv_mass=None,
    data=None,
    resume: bool = True,
):
    """SGLD / pSGLD (``run_sgld``) with per-chunk checkpointing, the SG-MCMC
    long-run driver.  ``chunk_size`` counts transitions (rounded to a
    multiple of ``thin``); the chain and the RMSProp accumulator are in the
    state file.  Every step's term and normals are keyed on the global step,
    so the assembled result is ``run_sgld``'s with the same key, bit for
    bit."""
    return _run_sgmcmc_checkpointed("sgld", key, term_fn, num_terms, theta0, config,
                                    ckpt_dir, chunk_size, inv_mass, data, resume)


def run_sghmc_checkpointed(
    key: int,
    term_fn: Callable,
    num_terms: int,
    theta0,
    config,  # SGHMCConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    inv_mass=None,
    data=None,
    resume: bool = True,
):
    """SGHMC (``run_sghmc``) with per-chunk checkpointing; the momentum is
    in the state file.  The contract of :func:`run_sgld_checkpointed`."""
    return _run_sgmcmc_checkpointed("sghmc", key, term_fn, num_terms, theta0, config,
                                    ckpt_dir, chunk_size, inv_mass, data, resume)


def _run_sgmcmc_checkpointed(which, key, term_fn, num_terms, theta0, config, ckpt_dir,
                             chunk_size, inv_mass, data, resume):
    from .samplers.sgmcmc import SGMCMCResult, SGMCMCStats, _prep, _run_sghmc, _run_sgld

    theta0, pre, data = _prep(key, term_fn, num_terms, theta0, config, inv_mass, data,
                              f"run_{which}_checkpointed")
    runner = _run_sgld if which == "sgld" else _run_sghmc
    stacked = tree_map(lambda t: t.unsqueeze(0), theta0)
    # the RMSProp accumulator or the momentum; plain SGLD carries None
    aux0 = None
    if which == "sghmc" or getattr(config, "preconditioner", "none") == "rmsprop":
        aux0 = tree_map(torch.zeros_like, stacked)
    carry0 = (stacked, aux0)

    def chunk_runner(seed, carry, n_done, cfg):
        res = runner(seed, carry[0], term_fn, num_terms, cfg, pre, data, carry[1], n_done)
        return res, (res.final_theta, res.final_aux)

    def save_chunk(res):
        out = {"samples": _first(res.samples)}
        out.update({f: getattr(res.stats, f)[0] for f in SGMCMCStats._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, carry0, lambda: carry0, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0, extra=(which, num_terms)),
                                 save_chunk)
    kept = config.num_samples // config.thin
    device = tree_leaves(theta0)[0].device
    return SGMCMCResult(
        samples=_cat(zs, "samples", 0, kept, device, like=theta0),
        stats=SGMCMCStats(**{f: _cat(zs, f, 0, kept, device) for f in SGMCMCStats._fields}),
        final_theta=_first(carry[0]),
        final_aux=_first(carry[1]),
        final_step=torch.tensor(config.num_samples, dtype=torch.int32, device=device),
    )


def run_pt_checkpointed(
    key: int,
    log_prob_fn,
    theta0,
    config,  # PTConfig
    ckpt_dir: str,
    chunk_size: int = 100,
    inv_mass=None,
    resume: bool = True,
    num_ensembles=None,
    theta0_is_stacked: bool | None = None,
    mesh=None,
):
    """Parallel tempering with per-chunk checkpointing of the whole ladder
    carry (replica positions with their cached potential evaluations, the
    log temperature gaps, the swap-rate EMA and the per-slot dual
    averaging).  The global draw index keys the noise and the even/odd swap
    parity, so the result is ``run_parallel_tempering``'s (or, with
    ``num_ensembles``, ``run_pt_chains``'s) bit for bit at any chunking.

    ``mesh``: shard the ``num_ensembles`` ladders over a
    ``parallel.sharding.make_mesh`` mesh per chunk (``run_pt_sharded``; no
    collectives but the gather); every rank holds the global carry and
    result, ``run_pt_chains``'s bit for bit.
    """
    if mesh is not None and num_ensembles is None:
        raise ValueError(
            "mesh-sharded PT checkpointing shards the ensemble axis; pass "
            "num_ensembles as well."
        )
    from .ops.potential import resolve_potential
    from .samplers.tempering import (
        PTCarry,
        _pt_ensemble_stack,
        _run_pt,
        assemble_pt_ensemble_result,
        assemble_pt_result,
        init_pt_carry,
        prepare_pt,
    )

    if num_ensembles is None:
        theta0s, mass = prepare_pt(theta0, config, inv_mass, theta0_is_stacked)
    else:
        theta0s, mass = _pt_ensemble_stack(theta0, config, num_ensembles, inv_mass)
    # no burn < num_samples guard: an interrupted run may stop inside the
    # burn window; burn slicing happens at assembly
    lp = resolve_potential(log_prob_fn, None)

    # the state file holds the dual-averaging state as a tuple of tensors
    def stored(carry):
        return carry._replace(da=_da_tuple(carry.da))

    def restored(carry):
        return PTCarry(*carry[:5], da=_da_of(carry.da))

    leaf = tree_leaves(theta0s)[0]
    lead = tuple(leaf.shape[:1 if num_ensembles is None else 2])
    zeros = leaf.new_zeros(lead[:-1] + (config.num_temps,))
    gaps = leaf.new_zeros(lead[:-1] + (config.num_temps - 1,))
    template = PTCarry(theta0s, zeros, tree_map(torch.zeros_like, theta0s), gaps, gaps,
                       (zeros,) * 4)

    if mesh is not None:
        from .parallel import sharding
        from .utils.rng import chain_slice

        lo, n = sharding._local_chains(mesh, "mesh", num_ensembles, "num_ensembles")

    def chunk_runner(seed, carry, n_done, cfg):
        if mesh is None:
            out = _run_pt(seed, theta0s, lp, cfg, mass, init_carry=restored(carry),
                          start_iter=n_done, ensembles=num_ensembles)
        else:
            # every field of the carry leads with the ensemble axis
            local = restored(sharding._map_paths(lambda _, t: t[lo:lo + n], carry))
            with chain_slice(lo, num_ensembles):
                out = _run_pt(seed, sharding._rows(theta0s, lo, n), lp, cfg, mass,
                              init_carry=local, start_iter=n_done, ensembles=n)
            out = sharding.gather_chains(out, mesh, "mesh")
        traj, alphas, swaps, carry_f = out
        return (traj, alphas, swaps), stored(carry_f)

    def save_chunk(result):
        traj, alphas, swaps = result
        return {"traj": traj, "alphas": alphas, "swaps": swaps}

    zs, carry = _checkpoint_loop(
        chunk_runner, key, template,
        lambda: stored(init_pt_carry(lp, theta0s, config, num_ensembles)), config, ckpt_dir,
        chunk_size, resume, _fingerprint(config, theta0s, extra=num_ensembles), save_chunk,
        mesh=mesh)
    carry = restored(carry)
    axis = 0 if num_ensembles is None else 1
    kept = config.num_samples  # burn slicing happens at assembly
    traj = _cat(zs, "traj", axis, kept, leaf.device, like=theta0s)
    alphas = _cat(zs, "alphas", axis, kept, leaf.device)
    swaps = _cat(zs, "swaps", axis, kept, leaf.device)
    assemble = assemble_pt_result if num_ensembles is None else assemble_pt_ensemble_result
    return assemble(traj, alphas, swaps, carry, config)


def run_ti_checkpointed(
    key: int,
    log_prior_fn: Callable,
    log_lik_fn: Callable,
    theta0,
    config,  # TIConfig
    ckpt_dir: str,
    chunk_size: int = 500,
    data=None,
    resume: bool = True,
):
    """Thermodynamic integration (``run_ti``) with per-chunk checkpointing.

    The rung states and the per-rung dual-averaging state are in the state
    file; the global draw index keys the noise and the swap parity, so the
    assembled result (the evidence estimators run once, over the joined
    post-burn log-likelihood trace) is ``run_ti``'s with the same key, bit
    for bit, and an interrupted run resumes exactly.  A directory left by a
    longer completed run gives exactly the requested draws.  A bfloat16
    state keeps its dtype on disk.
    """
    from .ops.potential import resolve_potential
    from .samplers.ti import _run_ti, assemble_ti_result, init_ti_da, stack_ti_rungs, ti_ladder

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0s = stack_ti_rungs(theta0, config)
    lik = resolve_potential(log_lik_fn, None)
    leaf = tree_leaves(theta0s)[0]
    k, dtype, device = leaf.shape[0], leaf.dtype, leaf.device
    carry0 = (theta0s, _da_tuple(init_ti_da(config, k, dtype, device)))

    def chunk_runner(seed, carry, n_done, cfg):
        out = _run_ti(seed, carry[0], log_prior_fn, lik, cfg, data=data,
                      init_da=_da_of(carry[1]), start_iter=n_done)
        return out, (out[6], _da_tuple(out[7]))

    def save_chunk(out):
        return {"cold": out[0], "llik": out[1], "alphas": out[2], "swaps": out[3]}

    zs, carry = _checkpoint_loop(chunk_runner, key, carry0, lambda: carry0, config, ckpt_dir,
                                 chunk_size, resume, _fingerprint(config, theta0s), save_chunk)
    kept = config.num_samples
    cold = _cat(zs, "cold", 0, kept, device, like=tree_map(lambda t: t[0], theta0s))
    out = (cold, _cat(zs, "llik", 0, kept, device), _cat(zs, "alphas", 0, kept, device),
           _cat(zs, "swaps", 0, kept, device), ti_ladder(k, config.schedule_power, dtype, device),
           _da_of(carry[1]).step_size)
    return assemble_ti_result(out, config)


def run_barker_checkpointed(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config,  # BarkerConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    scale=None,
    data=None,
    resume: bool = True,
    pass_grad=None,
):
    """Barker proposal (``run_barker``) with per-chunk checkpointing.

    The state file holds the chain's position, its dual-averaging state and
    its Welford state; ``config.burn`` is a GLOBAL draw index, so the
    step-size adaptation, the Welford window and the scale switch at
    ``3*burn//4`` land on the draws of the straight run, and each draw's
    noise is keyed on the global draw index: the result is ``run_barker``'s
    with the same key bit for bit, at any chunking.  ``chunk_size`` counts
    draws (rounded to a ``thin`` multiple); ``theta0`` may be flat or a
    parameter tree (``scale`` may then be a per-leaf tree).
    """
    from .samplers.barker import (
        BarkerResult,
        BarkerStats,
        _draw_scale,
        _ravel_scale,
        _run_barker,
        init_barker_da,
    )
    from .samplers.mclmc import _bind_data, _prep_flat
    from .samplers.warmup import WelfordState, welford_init

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    theta0 = place_start(theta0)
    scale_f = (_ravel_scale(scale, theta0) if is_param_tree(theta0)
               else (1.0 if scale is None else scale))
    theta0f, fn, unravel = _prep_flat(_bind_data(log_prob_fn, data), theta0, pass_grad)
    dtype, device = theta0f.dtype, theta0f.device
    carry0 = (theta0f[None], _da_tuple(init_barker_da(config, 1, device, dtype)),
              tuple(welford_init(theta0f.shape[0], dtype, device, (1,))))

    def chunk_runner(seed, carry, n_done, cfg):
        theta, da, wf = carry
        r = _run_barker(seed, theta, fn, cfg, scale_f, init_da=_da_of(da),
                        init_welford=WelfordState(*wf), start_step=n_done)
        return r, (r.final_theta, _da_tuple(r.final_da), tuple(r.final_welford))

    def save_chunk(r):
        out = {"samples": r.samples[0]}
        out.update({f: getattr(r.stats, f)[0] for f in BarkerStats._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, carry0, lambda: carry0, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0, extra="barker"), save_chunk)
    kept = config.num_samples // config.thin
    stats = BarkerStats(**{f: _cat(zs, f, 0, kept, device) for f in BarkerStats._fields})
    samples = _cat(zs, "samples", 0, kept, device)
    theta, wf = carry[0][0], WelfordState(*carry[2])
    da = DualAveragingState(*(t[0] for t in carry[1]))
    burn_kept = config.burn // config.thin
    tail = stats.accept_prob[burn_kept:] if kept > burn_kept else stats.accept_prob
    # reduced as the straight run reduces its (1, N) row
    acc_rate = torch.mean(tail[None], dim=1)[0]
    scale_arr = torch.as_tensor(scale_f, dtype=dtype, device=device).expand(theta0f.shape)
    if unravel is not None:
        samples, theta = unravel(samples), unravel(theta)
    return BarkerResult(
        samples=samples, stats=stats,
        step_size=torch.exp(da.log_eps_bar) if config.adapt_step_size else da.step_size,
        acc_rate=acc_rate, final_theta=theta, final_da=da,
        final_welford=WelfordState(*(t[0] for t in wf)),
        final_step=torch.tensor(config.num_samples, dtype=torch.int32, device=device),
        scale=_draw_scale(config, scale_arr, wf, config.num_samples, dtype)[0])


def run_stretch_checkpointed(
    key: int,
    log_prob_fn: Callable,
    theta0,
    config,  # StretchConfig
    ckpt_dir: str,
    chunk_size: int = 1000,
    num_walkers: int = 64,
    data=None,
    init_jitter: float = 1e-2,
    resume: bool = True,
):
    """Stretch-move ensemble (``run_stretch``) with per-chunk checkpointing.

    The state file holds the walker matrix and its cached log-densities;
    each iteration's noise is keyed on the global iteration index, so the
    result is ``run_stretch``'s with the same key bit for bit, at any
    chunking.  ``chunk_size`` counts iterations (rounded to a ``thin``
    multiple); ``theta0`` may be flat, an explicit walker matrix, or a
    parameter tree.
    """
    from .samplers.mclmc import _bind_data
    from .samplers.stretch import (
        StretchResult,
        StretchStats,
        _prep_walkers,
        _run_stretch,
        logp_dtype,
    )

    theta0 = place_start(theta0)
    walkers0, fn, unravel = _prep_walkers(key, _bind_data(log_prob_fn, data), theta0,
                                          num_walkers, init_jitter)
    device = walkers0.device
    template = (walkers0, torch.zeros((num_walkers,), dtype=logp_dtype(walkers0.dtype),
                                      device=device))

    def init_carry_fn():
        return (walkers0, None)

    def chunk_runner(seed, carry, n_done, cfg):
        r = _run_stretch(seed, carry[0], fn, cfg, num_walkers, init_logp=carry[1],
                         start_step=n_done)
        return r, (r.final_walkers, r.final_logp)

    def save_chunk(r):
        out = {"samples": r.samples}
        out.update({f: getattr(r.stats, f) for f in StretchStats._fields})
        return out

    zs, carry = _checkpoint_loop(chunk_runner, key, template, init_carry_fn, config, ckpt_dir,
                                 chunk_size, resume,
                                 _fingerprint(config, theta0, extra=("stretch", num_walkers)),
                                 save_chunk)
    kept = config.num_samples // config.thin
    stats = StretchStats(**{f: _cat(zs, f, 0, kept, device) for f in StretchStats._fields})
    samples = _cat(zs, "samples", 0, kept, device)
    walkers, logp = carry
    if unravel is not None:
        samples, walkers = unravel(samples), unravel(walkers)
    return StretchResult(
        samples=samples, stats=stats, acc_rate=torch.mean(stats.accept_frac),
        final_walkers=walkers, final_logp=logp,
        final_step=torch.tensor(config.num_samples, dtype=torch.int32, device=device))
