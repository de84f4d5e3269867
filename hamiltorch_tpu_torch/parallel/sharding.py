"""Device-mesh sharding over ``torch.distributed``: chain-parallel and
data-parallel sampling.

Counterpart of ``hamiltorch_tpu/parallel/sharding.py``.  The JAX module
builds a 2-D ``jax.sharding.Mesh`` with a ``chains`` axis (independent
chains, no communication) and a ``data`` axis (the likelihood sharded over
the dataset, each potential's value and gradient summed with ``psum``) and
runs everything under ``shard_map``.  Here one process (a torch rank) holds
one device, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks with ``mesh_dim_names=("chains", "data")``: NCCL on the
card, gloo when the caller asks for ``device="cpu"``.

Every rank runs its local chains against its local data shard on its own
device, with the port's local runner (``run_hmc_chains``,
``run_nuts_chains``, ...), and returns the same global result, chains in
global order, assembled by ``all_gather`` over the chain-holding ranks;
replicated fields stay as every rank computed them.  Each rank's chains
draw their global slice of the port's own stream (``utils.rng.
chain_slice``), so a chains-only mesh gives bit for bit the unsharded
``run_*_chains`` on the same seed, and a data mesh agrees with the
full-batch run up to the order of the sums.

The data-sharded potential (``make_psum_log_prob``) sums each batched
evaluation's values and gradients with ONE ``all_reduce`` over the
``data`` ranks, through a ``torch.autograd.Function`` whose ``vmap`` rule
sees the whole chain batch; the prior enters once, locally.  The pooled
ensembles (ChEES, pooled NUTS) all-reduce their cross-chain sums over the
chain-holding ranks.  A host loop whose length depends on values (ChEES's
leapfrog count, a NUTS tree) takes it from values every rank of a
collective holds bit for bit: all-reduce results, or state every such rank
computes from the same inputs.

The JAX module's ``*_specs`` helpers are ``shard_map`` partition specs; a
torch rank holds its shard as an ordinary tensor, so they have no
counterpart (ROADMAP.md, "Not ported, by decision").
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
from typing import Callable

import torch
import torch.distributed as dist

from ..utils.convert import resolve_device
from ..utils.pytree import is_param_tree, stack_param_tree, tree_leaves, tree_map
from ..utils.rng import STRETCH_ENSEMBLE_STREAM, chain_slice, draw_seed

MESH_AXES = ("chains", "data")
# the mesh make_mesh built last in this process: a dimension name given as
# ``axis_name`` resolves against it, as a name resolves against the
# surrounding mesh under shard_map
_ACTIVE_MESH = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(chains: int = 1, data: int = 1, devices=None, device=None):
    """Build a (chains, data) ``DeviceMesh`` over the ranks of the process
    group.

    ``devices``: the global ranks in mesh order (row-major over (chains,
    data)); by default every rank in rank order.  The mesh spans the whole
    process group.  ``device``: None (the default) puts each rank on its
    card, ``cuda:<local rank>``, with NCCL, and raises without one;
    ``device="cpu"`` runs the ranks on the CPU with gloo.  Without a
    process group a one-rank group starts on a free localhost port.  A
    multi-rank group is the caller's (``torchrun``, or
    ``parallel.multihost.initialize_multihost``).
    """
    global _ACTIVE_MESH
    from torch.distributed.device_mesh import DeviceMesh

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        resolve_device(None)  # raises without a card
    backend = "gloo" if on_cpu else "nccl"
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if chains * data != len(ranks):
        raise ValueError(
            f"mesh {chains}x{data} needs {chains * data} devices, have {len(ranks)}"
        )
    if sorted(ranks) != list(range(world)):
        raise ValueError(
            f"devices={ranks} must list every rank of the {world}-rank process group once"
        )
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    if backend not in str(dist.get_backend()):
        raise ValueError(
            f"the process group's backend is {dist.get_backend()!r}; a mesh on "
            f"{'the CPU' if on_cpu else 'the card'} needs {backend!r}"
        )
    if not on_cpu:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    mesh = DeviceMesh("cpu" if on_cpu else "cuda",
                      torch.tensor(ranks, dtype=torch.int64).reshape(chains, data),
                      mesh_dim_names=MESH_AXES)
    _ACTIVE_MESH = mesh
    return mesh


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _mesh_shape(mesh) -> tuple:
    return tuple(int(s) for s in mesh.mesh.shape)


def resolve_group(axis_name, mesh=None):
    """The process group of ``axis_name``: a ``ProcessGroup`` as given, a
    mesh dimension name (``"chains"`` / ``"data"``) or a tuple of both (the
    whole mesh) against ``mesh`` (by default the mesh ``make_mesh`` built
    last)."""
    if not isinstance(axis_name, (str, tuple, list)):
        return axis_name
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None or not dist.is_initialized():
        raise ValueError(f"axis_name={axis_name!r} needs a mesh; call make_mesh first")
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if tuple(names) != MESH_AXES:
        raise ValueError(f"axis_name={axis_name!r}; expected 'chains', 'data' or both")
    return dist.group.WORLD  # a mesh spans the whole process group


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor; every rank
    receives the same bits)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def tree_group_sum(tree, group):
    """Every leaf of ``tree`` summed over ``group`` with ONE all-reduce."""
    leaves = tree_leaves(tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for leaf in leaves:
        out.append(flat[at:at + leaf.numel()].reshape(leaf.shape))
        at += leaf.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


class _SummedLoglik(torch.autograd.Function):
    """The data-summed log likelihood of a flat (..., D) theta with
    ``nbatch`` leading batch dims: ``(value, gradient)``, each summed over
    ``group`` in one all-reduce.  Its ``vmap`` rule moves the batch dim
    to the front and calls it again, so a ``torch.func.vmap``-ed potential
    issues one collective per batched evaluation, and its backward returns
    ``ct * gradient``: the gradient is the full-batch one, not the group
    size times the local one.  The local gradient comes from the autograd
    engine on the vmapped value (rows are independent): a ``torch.func``
    gradient transform nested here cost more host time a call."""

    @staticmethod
    def forward(theta, local, group, nbatch):
        d = theta.shape[-1]
        with torch.enable_grad():
            flat = theta.detach().reshape(-1, d).requires_grad_(True)
            vals = torch.func.vmap(local)(flat)
            grads = None
            if vals.requires_grad:  # a likelihood that ignores theta has no graph
                (grads,) = torch.autograd.grad(vals.sum(), flat, allow_unused=True)
            if grads is None:
                grads = torch.zeros_like(flat)
        buf = torch.cat([vals.detach().reshape(-1, 1).to(grads.dtype), grads], dim=1)
        dist.all_reduce(buf, group=group)
        lead = tuple(theta.shape[:nbatch])
        return buf[:, 0].reshape(lead).to(vals.dtype), buf[:, 1:].reshape(theta.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, ct, _ct_grad):
        (grad,) = ctx.saved_tensors
        return ct.unsqueeze(-1) * grad, None, None, None

    @staticmethod
    def vmap(info, in_dims, theta, local, group, nbatch):
        theta = theta.movedim(in_dims[0], 0)
        return _SummedLoglik.apply(theta, local, group, nbatch + 1), (0, 0)


def make_psum_log_prob(loglik_shard_fn, log_prior_fn, x_shard, y_shard, axis_name="data"):
    """Exact data-sharded potential: ``log_prior_fn(theta) + sum over the
    'data' ranks of loglik_shard_fn(theta, x_shard, y_shard)``.

    The JAX module's ``custom_vjp`` pairs each evaluation's value and
    gradient (a naive ``psum`` has the wrong transpose: n_devices times
    the local gradient).  Here ``_SummedLoglik`` computes the local value
    and gradient and sums both in one all-reduce; under ``torch.func``
    (``grad``, ``vmap`` over chains) one collective serves the whole
    batch.  ``axis_name``: a mesh dimension name, a tuple of both, or a
    ``ProcessGroup`` (``resolve_group``).  ``theta`` may be a flat (D,)
    tensor or a parameter tree (raveled for the sum, in leaf order).
    Every rank of the group must evaluate the same number of times in the
    same order: the data ranks of a chain group run identical chains.
    """
    group = resolve_group(axis_name)

    def summed(theta):
        if is_param_tree(theta):
            from ..utils.pytree import unravel_last_axis_fn

            unravel = unravel_last_axis_fn(theta)
            flat = torch.cat([leaf.reshape(-1) for leaf in tree_leaves(theta)])

            def local(v):
                return loglik_shard_fn(unravel(v), x_shard, y_shard)
        else:
            flat = theta

            def local(v):
                return loglik_shard_fn(v, x_shard, y_shard)

        return _SummedLoglik.apply(flat, local, group, 0)[0]

    def log_prob(theta):
        return log_prior_fn(theta) + summed(theta)

    return log_prob


def _warn_progress_ignored(config):
    """Every rank would print its own progress line: the sharded runners
    say so once (on rank 0) and run silent instead.  Returns the config
    with ``progress_every`` stripped (unchanged when the field is absent
    or zero)."""
    if getattr(config, "progress_every", 0):
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(
                "[hamiltorch_tpu_torch] progress_every is ignored by the sharded "
                "runners (every rank would print its own line); the sharded run "
                "proceeds without a progress bar.",
                file=sys.stderr,
            )
        config = dataclasses.replace(config, progress_every=0)
    return config


def _position(mesh) -> tuple:
    """This rank's (chains, data) coordinate on ``mesh``."""
    flat = mesh.mesh.reshape(-1).tolist()
    return divmod(flat.index(dist.get_rank()), _mesh_shape(mesh)[1])


def _slot(mesh, axes: str) -> tuple:
    """(index, count) of this rank among the chain-holding slots: every
    rank of the mesh (``axes="mesh"``) or the coordinate along 'chains'."""
    nc, nd = _mesh_shape(mesh)
    c, d = _position(mesh)
    if axes == "mesh":
        return c * nd + d, nc * nd
    return c, nc


def mesh_chain_layout(mesh, num_chains: int):
    """(axes, group) for sharding a chain ensemble over the WHOLE mesh;
    validates that the ensemble divides the device count.  ``group`` is
    the pooled sums' process group (the JAX function returns the axis
    name)."""
    n_dev = mesh.mesh.numel()
    if num_chains % n_dev:
        raise ValueError(f"num_chains={num_chains} not divisible by {n_dev} devices")
    return MESH_AXES, dist.group.WORLD


def derive_chain_keys(key, num_chains: int):
    """The per-chain stream indices of an ensemble: the port's chain ``c``
    draws from ``draw_seed(key, c, ...)`` (``utils.rng``), so its "key" is
    its global index.  Shared by the sharded ensembles and their
    checkpointed counterparts, and recomputable from the base key alone,
    so any chunking reproduces the same stream."""
    return range(num_chains)


def _local_chains(mesh, axes: str, num_chains: int, what: str = "num_chains") -> tuple:
    """(offset, count) of this rank's chains; raises when they do not divide."""
    idx, count = _slot(mesh, axes)
    if num_chains % count:
        if axes == "mesh":
            raise ValueError(f"{what}={num_chains} not divisible by {count} devices")
        raise ValueError(f"{what}={num_chains} not divisible by mesh chains={count}")
    n = num_chains // count
    return idx * n, n


def _data_shard(mesh, dev, *arrays):
    """This rank's rows of each array (the leading axis split over 'data')."""
    nd = _mesh_shape(mesh)[1]
    d = _position(mesh)[1]
    out = []
    for a in arrays:
        a = torch.as_tensor(a, device=dev)
        if a.shape[0] % nd:
            raise ValueError(f"data length {a.shape[0]} not divisible by mesh data={nd}")
        m = a.shape[0] // nd
        out.append(a[d * m:(d + 1) * m])
    return out


def _place(theta, dev):
    if is_param_tree(theta):
        return tree_map(lambda leaf: torch.as_tensor(leaf, device=dev), theta)
    return torch.as_tensor(theta, device=dev)


def _stack(theta0, n: int, stacked, dev):
    """theta0 with a leading axis of ``n`` on every leaf, on ``dev``."""
    theta0 = _place(theta0, dev)
    if is_param_tree(theta0):
        return stack_param_tree(theta0, n, stacked=stacked)[1]
    if theta0.ndim == 1:
        return theta0.expand((n,) + tuple(theta0.shape)).clone()
    return theta0


def _rows(tree, lo: int, n: int):
    return tree_map(lambda leaf: leaf[lo:lo + n], tree)


# --------------------------------------------------------------------------
# Assembling the global result: all_gather over the chain-holding ranks.
# --------------------------------------------------------------------------

def _map_paths(fn, obj, path=()):
    """``fn(path, tensor)`` over every tensor of a result (named tuples,
    dataclasses, dicts, lists and tuples); other values pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(path, obj)
    if hasattr(obj, "_fields"):
        return type(obj)(*(_map_paths(fn, v, path + (k,)) for k, v in zip(obj._fields, obj)))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_paths(fn, getattr(obj, f.name), path + (f.name,))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_paths(fn, obj[k], path + (k,)) for k in obj}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_paths(fn, v, path + (i,)) for i, v in enumerate(obj))
    return obj


def _gather_cat(t: torch.Tensor, mesh, axes: str, dim: int) -> torch.Tensor:
    """``t`` of every chain-holding rank, concatenated along ``dim`` in
    global chain order."""
    idx, count = _slot(mesh, axes)
    if count == 1:
        return t
    group = dist.group.WORLD if axes == "mesh" else mesh.get_group("chains")
    wire = t.contiguous()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    elif wire.dtype in (torch.bfloat16, torch.float16):
        wire = wire.view(torch.int16)
    pieces = [torch.empty_like(wire) for _ in range(count)]
    dist.all_gather(pieces, wire, group=group)
    flat = mesh.mesh.reshape(-1).tolist()
    nd = _mesh_shape(mesh)[1]

    def slot_of(rank):
        pos = flat.index(rank)
        return pos if axes == "mesh" else pos // nd

    order = sorted(range(count), key=lambda i: slot_of(dist.get_process_group_ranks(group)[i]))
    out = torch.cat([pieces[i] for i in order], dim=dim)
    if t.dtype == torch.bool:
        return out.to(torch.bool)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def _chain_first(path, t):
    """Independent chains: every tensor with a dimension carries the chain
    axis first; 0-d tensors are replicated."""
    return 0 if t.ndim >= 1 else None


def gather_chains(result, mesh, axes: str, spec=_chain_first):
    """The global result: each tensor that ``spec(path, tensor)`` gives a
    chain dim is gathered along it over the chain-holding ranks (``axes``:
    ``"mesh"`` or ``"chains"``); the others are replicated and kept."""
    def one(path, t):
        dim = spec(path, t)
        return t if dim is None else _gather_cat(t, mesh, axes, dim)

    return _map_paths(one, result)


# --------------------------------------------------------------------------
# Independent chains: HMC, NUTS, RMHMC, MCLMC, MAMS, Barker.
# --------------------------------------------------------------------------

def _run_local(mesh, axes, num_chains, runner, theta0, stacked=None, spec=_chain_first):
    """Run ``runner(local_theta0, local_count)`` on this rank's chains under
    their global slice of the stream, and gather the result."""
    dev = mesh_device(mesh)
    lo, n = _local_chains(mesh, axes, num_chains)
    full = _stack(theta0, num_chains, stacked, dev)
    with chain_slice(lo, num_chains):
        out = runner(_rows(full, lo, n), n)
    return gather_chains(out, mesh, axes, spec)


def sample_chains_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y,
                          theta0, config, mesh, num_chains: int, inv_mass=None):
    """HMC chains sharded over ``mesh``'s 'chains' axis with the likelihood
    sharded over its 'data' axis.

    ``loglik_shard_fn(theta, x_shard, y_shard)`` returns the summed
    log-likelihood of its shard; the full potential is ``log_prior_fn(theta)
    + sum_data(loglik_shard_fn(...))`` (``make_psum_log_prob``): exact
    full-batch HMC on datasets larger than one device's memory.  ``x`` and
    ``y`` are the whole dataset on every rank; each rank keeps its rows.
    ``theta0``: (D,) broadcast or (num_chains, D).
    """
    from ..samplers.hmc import run_hmc_chains

    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _run_local(mesh, "chains", num_chains,
                           lambda t, n: run_hmc_chains(key, lp, t, config, n, inv_mass),
                           theta0)


def run_hmc_chains_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                           inv_mass=None, theta0_is_stacked: bool | None = None):
    """Chain-only sharding: the potential replicated, the chains over the
    whole mesh (both axes flattened), no communication but the final
    gather.  ``theta0`` may be a parameter tree (single state broadcast, or
    (C, ...)-stacked leaves)."""
    from ..samplers.hmc import run_hmc_chains

    config = _warn_progress_ignored(config)
    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_hmc_chains(key, log_prob_fn, t, config, n, inv_mass,
                                    theta0_is_stacked=True),
        theta0, theta0_is_stacked)


def run_nuts_chains_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                            inv_mass=None, theta0_is_stacked: bool | None = None):
    """Tree-NUTS chains sharded over the whole mesh (no communication).
    Returns (MCMCResult, NUTSInfo) with a leading chain axis."""
    from ..samplers.nuts import run_nuts_chains

    config = _warn_progress_ignored(config)
    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_nuts_chains(key, log_prob_fn, t, config, n, inv_mass,
                                     theta0_is_stacked=True),
        theta0, theta0_is_stacked)


def sample_nuts_chains_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y,
                               theta0, config, mesh, num_chains: int, inv_mass=None):
    """Tree-NUTS chains over BOTH mesh axes: chains over 'chains', the
    likelihood over 'data' (``make_psum_log_prob``).  The data ranks of a
    chain group build identical trees, so their collectives line up.
    Returns (MCMCResult, NUTSInfo) with a leading chain axis."""
    from ..samplers.nuts import run_nuts_chains

    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _run_local(mesh, "chains", num_chains,
                           lambda t, n: run_nuts_chains(key, lp, t, config, n, inv_mass),
                           theta0)


def run_rmhmc_chains_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                             **rmhmc_kwargs):
    """Independent RMHMC chains sharded over the whole mesh (no
    communication).  ``rmhmc_kwargs`` are ``run_rmhmc_chains``'s sampler
    options.  Returns an MCMCResult with a leading chain axis."""
    from ..samplers.rmhmc import run_rmhmc_chains

    config = _warn_progress_ignored(config)
    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_rmhmc_chains(key, log_prob_fn, t, config, n, **rmhmc_kwargs),
        theta0)


def run_mclmc_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                      data=None, theta0_is_stacked: bool | None = None):
    """Independent MCLMC chains sharded over the WHOLE mesh (both axes
    flattened), each tuning its own (eps, L); ``theta0`` flat (D,), (C, D)
    or a parameter tree, as ``run_mclmc_chains`` takes it."""
    from ..samplers.mclmc import run_mclmc_chains

    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_mclmc_chains(key, log_prob_fn, t, config, n, data=data,
                                      theta0_is_stacked=True),
        theta0, theta0_is_stacked)


def sample_mclmc_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y, theta0,
                         config, mesh, num_chains: int):
    """MCLMC chains over 'chains' with the likelihood sharded over 'data':
    every step's gradient completes with one all-reduce over the data
    ranks.  ``theta0``: flat (D,) broadcast or (num_chains, D)."""
    from ..samplers.mclmc import run_mclmc_chains

    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _run_local(mesh, "chains", num_chains,
                           lambda t, n: run_mclmc_chains(key, lp, t, config, n), theta0)


def run_mams_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                     data=None, theta0_is_stacked: bool | None = None):
    """Independent MAMS chains sharded over the WHOLE mesh, each
    dual-averaging its own step size; the layout contract of
    :func:`run_mclmc_sharded`."""
    from ..samplers.mams import run_mams_chains

    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_mams_chains(key, log_prob_fn, t, config, n, data=data,
                                     theta0_is_stacked=True),
        theta0, theta0_is_stacked)


def sample_mams_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y, theta0,
                        config, mesh, num_chains: int):
    """MAMS chains over 'chains' with the likelihood sharded over 'data';
    the contract of :func:`sample_mclmc_sharded`."""
    from ..samplers.mams import run_mams_chains

    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _run_local(mesh, "chains", num_chains,
                           lambda t, n: run_mams_chains(key, lp, t, config, n), theta0)


def _barker_spec(path, t):
    # the proposal scale is (D,), shared by every chain, unless it adapts
    if path == ("scale",) and t.ndim == 1:
        return None
    return _chain_first(path, t)


def run_barker_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                       scale=None, data=None, theta0_is_stacked: bool | None = None):
    """Independent Barker-proposal chains sharded over the WHOLE mesh; the
    layout contract of :func:`run_mams_sharded`.  Each rank draws the
    whole block of a draw's noise and keeps its chains' rows
    (``utils.rng.chain_rows``)."""
    from ..samplers.barker import run_barker_chains

    return _run_local(
        mesh, "mesh", num_chains,
        lambda t, n: run_barker_chains(key, log_prob_fn, t, config, n, scale=scale, data=data,
                                       theta0_is_stacked=True),
        theta0, theta0_is_stacked, spec=_barker_spec)


# --------------------------------------------------------------------------
# Pooled ensembles: ChEES and NUTS with cross-chain adaptation.
# --------------------------------------------------------------------------

def pooled_nuts_batch_spec(path, t):
    """The pooled NUTS batch before ``_time_major``: the chain axis first on
    the samples, stats, final chain state and infos; the pooled adaptation
    replicated."""
    if path[0] == 0 and path[1] not in ("samples", "stats", "final_state"):
        return None
    return 0


def _pooled_nuts(key, lp, theta0, config, mesh, axes, num_chains, inv_mass, stacked, group):
    from ..samplers.nuts import _prepare_chains, _run_nuts_batched, _time_major

    dev = mesh_device(mesh)
    lo, n = _local_chains(mesh, axes, num_chains)
    full, mass = _prepare_chains(_place(theta0, dev), config, num_chains, inv_mass, stacked)
    res, info = _run_nuts_batched(key, _rows(full, lo, n), lp, config, mass, pooled=True,
                                  chain_keys=derive_chain_keys(key, num_chains)[lo:lo + n],
                                  axis_name=group)
    # gathered in the batch's layout, then time-major with the pooled rate
    # over every chain, as the unsharded ensemble has them
    return _time_major(*gather_chains((res, info), mesh, axes, pooled_nuts_batch_spec))


def run_nuts_ensemble_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                              inv_mass=None, theta0_is_stacked: bool | None = None):
    """Ensemble NUTS with POOLED adaptation sharded over the whole mesh: the
    dual-averaging statistic (the ensemble-mean leaf acceptance) and the
    pooled Welford mass estimate are all-reduced over every rank each draw.
    Returns (MCMCResult, NUTSInfo) in ``run_nuts_ensemble``'s layout:
    ``samples`` chain-major (C, N, D), stats and infos TIME-major (N, C)."""
    config = _warn_progress_ignored(config)
    _, group = mesh_chain_layout(mesh, num_chains)
    return _pooled_nuts(key, log_prob_fn, theta0, config, mesh, "mesh", num_chains, inv_mass,
                        theta0_is_stacked, group)


def sample_nuts_ensemble_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y,
                                 theta0, config, mesh, num_chains: int, inv_mass=None):
    """Pooled-adaptation ensemble NUTS on BOTH mesh axes: the chains over
    'chains' (the pooled sums all-reduced over them) and the likelihood
    over 'data' (``make_psum_log_prob``).  ``run_nuts_ensemble``'s layout."""
    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _pooled_nuts(key, lp, theta0, config, mesh, "chains", num_chains, inv_mass, None,
                        mesh.get_group("chains"))


def chees_spec(path, t):
    """``run_chees``'s layout: samples and the carry's chain state
    chain-major, the per-chain infos (N, C), the shared adaptation
    replicated."""
    field = path[0]
    if field == "samples":
        return 0
    if field == "info":
        return 1 if path[1] in ("accept_prob", "divergent") else None
    if field == "final_carry":
        return 0 if path[1] in ("thetas", "logps", "grads") else None
    return None


def _pooled_chees(key, lp, theta0, config, mesh, axes, num_chains, inv_mass, stacked, group):
    from ..samplers.chees import _run_chees, prepare_chees

    dev = mesh_device(mesh)
    lo, n = _local_chains(mesh, axes, num_chains)
    # every rank spreads the whole ensemble from the key, then keeps its rows
    full, mass = prepare_chees(key, _place(theta0, dev), config, num_chains, inv_mass, stacked)
    out = _run_chees(key, _rows(full, lo, n), lp, config, mass,
                     chain_keys=derive_chain_keys(key, num_chains)[lo:lo + n], axis_name=group)
    return gather_chains(out, mesh, axes, chees_spec)


def run_chees_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_chains: int,
                      inv_mass=None, theta0_is_stacked: bool | None = None):
    """ChEES-HMC with the chain ensemble sharded over the WHOLE mesh: the
    cross-chain criterion (ensemble mean, acceptance-weighted trajectory
    gradient, mean acceptance, windowed Welford mass estimate) is
    all-reduced over every rank each draw.  The chains draw their slice of
    ``run_chees``'s stream, so the result is ``run_chees``'s up to the
    order of the pooled sums."""
    config = _warn_progress_ignored(config)
    _, group = mesh_chain_layout(mesh, num_chains)
    return _pooled_chees(key, log_prob_fn, theta0, config, mesh, "mesh", num_chains, inv_mass,
                         theta0_is_stacked, group)


def sample_chees_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y, theta0,
                         config, mesh, num_chains: int, inv_mass=None):
    """ChEES-HMC on BOTH mesh axes: the ensemble over 'chains' (its
    cross-chain statistics all-reduced over them) and the likelihood over
    'data' (``make_psum_log_prob``)."""
    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    return _pooled_chees(key, lp, theta0, config, mesh, "chains", num_chains, inv_mass, None,
                         mesh.get_group("chains"))


# --------------------------------------------------------------------------
# Tempering, evidence, SG-MCMC, SVGD, the stretch move.
# --------------------------------------------------------------------------

def run_pt_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_ensembles: int,
                   inv_mass=None):
    """Independent parallel-tempering ladders sharded over the whole mesh
    (no collectives but the gather): each rank runs its slice of the E
    ladders.  Returns a PTResult with a leading ensemble axis, as
    ``run_pt_chains``; ``theta0`` as ``run_pt_chains`` takes it."""
    from ..samplers.tempering import _pt_ensemble_stack, run_pt_chains

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    lo, n = _local_chains(mesh, "mesh", num_ensembles, "num_ensembles")
    full, _ = _pt_ensemble_stack(_place(theta0, dev), config, num_ensembles, inv_mass)
    with chain_slice(lo, num_ensembles):
        out = run_pt_chains(key, log_prob_fn, _rows(full, lo, n), config, n, inv_mass)
    return gather_chains(out, mesh, "mesh")


def sample_pt_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y, theta0,
                      config, mesh, num_ensembles: int, inv_mass=None):
    """Parallel-tempering ladders over BOTH mesh axes: ensembles over
    'chains', the likelihood over 'data'.  Every replica evaluates the
    exact full-batch potential (``make_psum_log_prob``).  Returns a
    PTResult with a leading ensemble axis."""
    from ..samplers.tempering import _pt_ensemble_stack, run_pt_chains

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    config = _warn_progress_ignored(config)
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    lo, n = _local_chains(mesh, "chains", num_ensembles, "num_ensembles")
    full, _ = _pt_ensemble_stack(_place(theta0, dev), config, num_ensembles, inv_mass)
    with chain_slice(lo, num_ensembles):
        out = run_pt_chains(key, lp, _rows(full, lo, n), config, n, inv_mass)
    return gather_chains(out, mesh, "chains")


def run_ti_sharded(key, log_prior_fn: Callable, loglik_shard_fn: Callable, x, y, theta0,
                   config, mesh):
    """Thermodynamic integration with the LIKELIHOOD sharded over 'data'.

    Every rank runs the identical replica ladder (the swaps stay local; the
    stream and the ladder state replicate), and only the rungs'
    log-likelihood values and gradients are summed over the data ranks
    (``make_psum_log_prob`` with a zero prior).  Returns the TIResult of
    the local ``run_ti`` on the gathered data, up to the order of the
    sums, on every rank."""
    from ..samplers.ti import run_ti

    if config.burn >= config.num_samples:
        raise RuntimeError("burn must be less than num_samples.")
    dev = mesh_device(mesh)
    xs, ys = _data_shard(mesh, dev, x, y)
    lik = make_psum_log_prob(loglik_shard_fn, lambda t: 0.0, xs, ys, mesh.get_group("data"))
    return run_ti(key, log_prior_fn, lik, _place(theta0, dev), config)


def _run_sgmcmc_sharded(runner, key, term_shard_fn, log_prior_fn, num_terms, theta0, config,
                        mesh, num_chains, data, inv_mass, what):
    from ..samplers.sgmcmc import _prep

    nc, nd = _mesh_shape(mesh)
    if num_chains % nc:
        raise ValueError(
            f"{what}: num_chains={num_chains} not divisible by mesh chains={nc}"
        )
    if data is None:
        raise ValueError(
            f"{what}: data is required (stacked (M, B, ...) term arrays; "
            "the B axis shards over the mesh 'data' axis)"
        )
    dev = mesh_device(mesh)
    data = tree_map(lambda a: torch.as_tensor(a, device=dev), data)
    for leaf in tree_leaves(data):
        if leaf.ndim < 2 or leaf.shape[1] % nd:
            raise ValueError(
                f"{what}: every data leaf must be (M, B, ...) with B "
                f"divisible by mesh data={nd}; got {tuple(leaf.shape)}"
            )
    d = _position(mesh)[1]
    data_l = tree_map(lambda a: a[:, d * (a.shape[1] // nd):(d + 1) * (a.shape[1] // nd)], data)
    full = _stack(theta0, num_chains, None, dev)
    template = tree_map(lambda leaf: leaf[0], full)
    _, pre, _ = _prep(key, term_shard_fn, num_terms, template, config, inv_mass, None, what)
    config = _warn_progress_ignored(config)
    lo, n = _local_chains(mesh, "chains", num_chains)
    with chain_slice(lo, num_chains):
        out = runner(key, _rows(full, lo, n), term_shard_fn, num_terms, config, pre, data_l,
                     None, 0, mesh.get_group("data"), log_prior_fn)
    return gather_chains(out, mesh, "chains")


def run_sgld_sharded(key, term_shard_fn: Callable, log_prior_fn: Callable, num_terms: int,
                     theta0, config, mesh, num_chains: int, data, inv_mass=None):
    """SGLD chains sharded over 'chains' with the minibatch gradient
    data-parallel over 'data'.

    ``term_shard_fn(theta, m, data_shard)`` returns its rank's SLICE of
    term m's log-likelihood (data leaves are (M, B, ...) arrays whose B
    axis shards over the mesh); the gradient estimate is ``num_terms *
    sum_data(grad ll_shard) + grad log_prior``: the prior enters once,
    locally.  The data ranks of a chain group draw the same terms and
    noise, so the result equals the local ``run_sgld_chains`` whose term
    is ``ll_full_term + log_prior / num_terms`` up to the order of the
    sums.  One all-reduce of the gradient a step."""
    from ..samplers.sgmcmc import _run_sgld

    return _run_sgmcmc_sharded(_run_sgld, key, term_shard_fn, log_prior_fn, num_terms, theta0,
                               config, mesh, num_chains, data, inv_mass, "run_sgld_sharded")


def run_sghmc_sharded(key, term_shard_fn: Callable, log_prior_fn: Callable, num_terms: int,
                      theta0, config, mesh, num_chains: int, data, inv_mass=None):
    """SGHMC chains sharded over 'chains' x data-parallel minibatch
    gradients: the contract of :func:`run_sgld_sharded`."""
    from ..samplers.sgmcmc import _run_sghmc

    return _run_sgmcmc_sharded(_run_sghmc, key, term_shard_fn, log_prior_fn, num_terms, theta0,
                               config, mesh, num_chains, data, inv_mass, "run_sghmc_sharded")


def run_csgmcmc_sharded(key, term_shard_fn: Callable, log_prior_fn: Callable, num_terms: int,
                        theta0, config, mesh, num_chains: int, data, inv_mass=None):
    """Cyclical SG-MCMC chains sharded over 'chains' x data-parallel
    minibatch gradients: the contract of :func:`run_sgld_sharded`."""
    from ..samplers.sgmcmc import _csgmcmc_sharded_adapter

    return _run_sgmcmc_sharded(_csgmcmc_sharded_adapter, key, term_shard_fn, log_prior_fn,
                               num_terms, theta0, config, mesh, num_chains, data, inv_mass,
                               "run_csgmcmc_sharded")


def run_svgd_sharded(key, loglik_shard_fn: Callable, log_prior_fn: Callable, x, y, theta0,
                     config, mesh, num_particles: int = 100, _noise=None):
    """SVGD with the LIKELIHOOD sharded over 'data'.

    The particles interact all-to-all through the RBF kernel, so every
    rank holds the whole (replicated) cloud and computes the same update;
    only each step's ``num_particles`` gradients are data-parallel, one
    all-reduce of the batch's values and gradients over the data ranks
    (``make_psum_log_prob``).  Returns the SVGDResult of the local
    ``run_svgd`` on the gathered data, up to the order of the sums.
    ``_noise``: the initial cloud's (n, D) unit normals (a test hook).
    """
    from ..svgd import SVGDResult, _run_svgd, check_num_particles, initial_cloud
    from ..utils.pytree import ravel_pytree_fn

    dev = mesh_device(mesh)
    theta0 = _place(theta0, dev)
    is_tree = is_param_tree(theta0)
    if is_tree:
        flat0, unravel = ravel_pytree_fn(theta0)
    else:
        flat0, unravel = theta0.reshape(-1), None
    check_num_particles(num_particles)
    xs, ys = _data_shard(mesh, dev, x, y)
    particles = initial_cloud(key, flat0, config, num_particles, _noise)
    lp = make_psum_log_prob(loglik_shard_fn, log_prior_fn, xs, ys, mesh.get_group("data"))
    if is_tree:
        lp_flat = lambda v: lp(unravel(v))  # noqa: E731
    else:
        lp_flat = lp
    xo, phi_tr, h_tr, rej, aux, last = _run_svgd(particles, lp_flat, config)
    return SVGDResult(unravel(xo) if is_tree else xo, phi_tr, h_tr, rej, aux, last)


def stretch_ensemble_key(key: int, e: int) -> int:
    """The seed of ensemble ``e`` of :func:`run_stretch_sharded`: its run is
    ``run_stretch(stretch_ensemble_key(key, e), ...)``."""
    return draw_seed(key, e, STRETCH_ENSEMBLE_STREAM)


def run_stretch_sharded(key, log_prob_fn: Callable, theta0, config, mesh, num_ensembles: int,
                        num_walkers: int = 64, data=None, init_jitter: float = 1e-2):
    """Independent stretch-move ensembles sharded over the WHOLE mesh.

    The move is all-to-all within an ensemble, so each walker cloud stays
    on one rank and the mesh multiplies throughput at the ensemble level,
    with no collectives but the gather.  Ensemble ``e`` is
    ``run_stretch(stretch_ensemble_key(key, e), ...)``: a (D,) centre
    jittered by its own key, or its block of an explicit (E, K, D)
    ``theta0``.  Returns a StretchResult with a leading (num_ensembles,)
    axis; flat theta0 only.  Gradient-free."""
    from ..samplers.stretch import StretchResult, run_stretch

    if num_walkers < 4 or num_walkers % 2:
        raise ValueError(
            f"num_walkers={num_walkers}; the parallel stretch move needs "
            "an EVEN ensemble of >= 4"
        )
    dev = mesh_device(mesh)
    theta0 = torch.as_tensor(theta0, device=dev)
    if theta0.ndim == 3:
        if tuple(theta0.shape[:2]) != (num_ensembles, num_walkers):
            raise ValueError(
                f"theta0 {tuple(theta0.shape)} != (num_ensembles, num_walkers, D)"
            )
    elif theta0.ndim != 1:
        raise ValueError(
            f"theta0 must be (D,) or (num_ensembles, num_walkers, D); "
            f"got {tuple(theta0.shape)}"
        )
    lo, n = _local_chains(mesh, "mesh", num_ensembles, "num_ensembles")
    runs = [run_stretch(stretch_ensemble_key(key, e), log_prob_fn,
                        theta0 if theta0.ndim == 1 else theta0[e], config, num_walkers,
                        data=data, init_jitter=init_jitter)
            for e in range(lo, lo + n)]
    out = _map_paths(lambda path, _: torch.stack([_get(r, path) for r in runs]), runs[0])
    return gather_chains(StretchResult(*out), mesh, "mesh")


def _get(obj, path):
    for k in path:
        obj = getattr(obj, k) if isinstance(k, str) and hasattr(obj, "_fields") else obj[k]
    return obj
