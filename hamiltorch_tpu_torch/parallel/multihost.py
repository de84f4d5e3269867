"""Multi-process initialisation helpers.

Counterpart of ``hamiltorch_tpu/parallel/multihost.py``.  JAX scales past
one host as single-controller SPMD: ``jax.distributed.initialize`` wires
the hosts and each process drives several local devices.  In PyTorch one
process (a rank) drives one device, and ``torch.distributed`` wires the
ranks: ``initialize_multihost`` wraps ``init_process_group`` over
``tcp://<coordinator_address>``, and the sharded samplers of
``parallel/sharding.py`` run over a mesh of all ranks
(``global_chain_mesh``).  A user with several cards starts one rank a card,
with ``torchrun`` (which sets the rendezvous environment; call
``make_mesh`` after ``torch.distributed.init_process_group()``) or with
``initialize_multihost(coordinator_address="host:port",
num_processes=N, process_id=i)`` in each process.

The cross-process layer is exercised for real on a LOCALHOST cluster:
:func:`launch_localhost_cluster` spawns the ranks as subprocesses (spawned,
never forked: the parent may hold JAX's and torch's threads), each wires
itself through ``initialize_multihost``, runs the sharded samplers over
the global mesh and saves its traces, which must match across processes
and match a single-process run.  A JAX process holds several devices and a
torch rank one, so the cluster has ``num_processes * devices_per_process``
ranks, one process each; the two names and their defaults are kept for
parity with the JAX function.  ``python -m
hamiltorch_tpu_torch.parallel.multihost`` runs one rank of that cluster
(used by the launcher; also a template for real launch scripts).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> dict:
    """Initialise ``torch.distributed`` (a no-op for a single process).

    ``coordinator_address`` is ``"host:port"`` of rank 0's rendezvous
    (``tcp://``), ``num_processes`` the world size and ``process_id`` this
    process's rank.  ``device``: None (the default) for NCCL on the cards,
    ``"cpu"`` for gloo.  Returns a small info dict for logging, with the
    JAX function's keys (one device a process).
    """
    if (num_processes is not None and num_processes > 1 or coordinator_address) \
            and not dist.is_initialized():
        on_cpu = device is not None and torch.device(device).type == "cpu"
        dist.init_process_group(
            "gloo" if on_cpu else "nccl",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes or 1),
            rank=int(process_id or 0),
        )
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def global_chain_mesh(data_parallelism: int = 1, device=None):
    """A mesh over ALL ranks: ``data_parallelism`` consecutive ranks share a
    chain group along 'data' (lay them on one host, where the per-step
    all-reduce is cheapest); the rest are independent 'chains'."""
    from .sharding import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % data_parallelism:
        raise ValueError(f"{n} devices not divisible by data={data_parallelism}")
    return make_mesh(chains=n // data_parallelism, data=data_parallelism, device=device)


# --------------------------------------------------------------------------
# Localhost cluster self-test: the cross-process layer run for real.
# --------------------------------------------------------------------------

# The self-tests' geometry is fixed, so that every launch (one rank or a
# cluster of 1, 2, 4 or 8) computes the same traces: 8 chains, and a
# 16-row dataset split over every rank.
SELFTEST_CHAINS = 8
SELFTEST_ROWS = 16


def selftest_problem(device=None):
    """``(log_prob, loglik_shard, log_prior, x, y, chains config, psum
    config)`` of the self-tests, on ``device``: the unsharded runs of the
    same problem are the single-process reference."""
    from ..samplers.driver import MCMCConfig

    def lp(t):
        return -0.5 * torch.sum(t**2)

    x = torch.linspace(-1.0, 1.0, SELFTEST_ROWS, device=device).reshape(SELFTEST_ROWS, 1) \
        * torch.ones((1, 3), device=device)
    y = torch.sin(3.0 * x[:, 0])

    def loglik_shard(t, xs, ys):
        return -12.5 * torch.sum((xs @ t - ys) ** 2)

    cfg_chains = MCMCConfig(num_samples=12, num_steps_per_sample=3, step_size=0.25)
    cfg_psum = MCMCConfig(num_samples=12, num_steps_per_sample=3, step_size=0.05)
    return lp, loglik_shard, lp, x, y, cfg_chains, cfg_psum


def _selftest_chains(key, device=None):
    """Chains-sharded HMC over the global mesh (no communication but the
    gather: each rank runs its own chains)."""
    from .sharding import mesh_device, run_hmc_chains_sharded

    mesh = global_chain_mesh(data_parallelism=1, device=device)
    lp, _, _, _, _, cfg, _ = selftest_problem(mesh_device(mesh))
    r = run_hmc_chains_sharded(key, lp, torch.zeros(3, device=mesh_device(mesh)), cfg, mesh,
                               num_chains=SELFTEST_CHAINS)
    return r.samples


def _selftest_psum(key, device=None):
    """Data-sharded HMC over the global mesh: the likelihood's value and
    gradient are summed over the 'data' ranks every leapfrog step.  'data'
    spans ALL ranks (chains=1), so in a multi-process launch the
    all-reduce crosses the process boundary."""
    from .sharding import mesh_device, sample_chains_sharded

    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    mesh = global_chain_mesh(data_parallelism=n_dev, device=device)
    dev = mesh_device(mesh)
    _, loglik_shard, log_prior, x, y, _, cfg = selftest_problem(dev)
    r = sample_chains_sharded(key, loglik_shard, log_prior, x, y, torch.zeros(3, device=dev),
                              cfg, mesh, num_chains=1)
    return r.samples


def selftest_keys() -> dict:
    """The integer seed of each self-test family."""
    from ..utils.rng import draw_seed

    return {"chains": draw_seed(7, 0, 0), "psum": draw_seed(7, 1, 0)}


def run_cluster_selftest(device=None):
    """Run both self-test families on the current process group (one
    process or many) and return the traces as host numpy arrays.  Every
    rank holds the gathered global result, and the geometry does not
    depend on the rank count, so the arrays compare across launch modes
    and against the unsharded runs of ``selftest_problem`` directly."""
    import numpy as np

    keys = selftest_keys()
    out = {}
    for name, fn in (("chains", _selftest_chains), ("psum", _selftest_psum)):
        samples = fn(keys[name], device)
        out[name] = np.asarray(samples.cpu())
    return out


def launch_localhost_cluster(num_processes: int = 2,
                             devices_per_process: int = 4,
                             timeout: float = 600.0,
                             device=None) -> dict:
    """Spawn a localhost cluster of ``num_processes * devices_per_process``
    ranks, one process each, and run :func:`run_cluster_selftest` in it.

    ``device``: None puts each rank on a card of this host (NCCL; needs as
    many cards as ranks), ``"cpu"`` runs gloo ranks on the CPU.  Each rank
    is a fresh interpreter (spawned, not forked) wired through
    ``initialize_multihost``.  Returns rank 0's traces plus every rank's
    info dict; raises on any worker failure, on a worker that outlives
    ``timeout`` seconds (all are killed), or on a cross-process
    disagreement.
    """
    import json
    import socket
    import tempfile
    import time

    import numpy as np

    world = num_processes * devices_per_process
    if device is None and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"a {world}-rank cluster on the cards needs {world} CUDA devices, have "
            f"{torch.cuda.device_count()}; pass device='cpu' for gloo ranks"
        )
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        dev_arg = "cuda" if device is None else str(torch.device(device))
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "hamiltorch_tpu_torch.parallel.multihost",
                 f"localhost:{port}", str(world), str(i), td, dev_arg],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(world)
        ]
        logs, failed = [], False
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                failed = True
            logs.append(out)
            failed = failed or p.returncode != 0
        if failed:
            raise RuntimeError(
                "localhost cluster worker failed:\n"
                + "\n---\n".join((log or "")[-4000:] for log in logs)
            )

        results, infos = [], []
        for i in range(world):
            z = np.load(os.path.join(td, f"worker_{i}.npz"))
            results.append({k: z[k] for k in z.files if k != "info"})
            infos.append(json.loads(str(z["info"])))
        for info in infos:
            if info["process_count"] != world:
                raise RuntimeError(f"bad cluster wiring: {info}")
        for i in range(1, world):
            for k in results[0]:
                np.testing.assert_array_equal(
                    results[0][k], results[i][k],
                    err_msg=f"process {i} disagrees on '{k}'",
                )
        return {"traces": results[0], "infos": infos}


def _worker_main(argv) -> None:
    """One rank of the localhost cluster (``python -m ...multihost
    <coordinator> <num_processes> <process_id> <outdir> [device]``)."""
    import json

    import numpy as np

    coordinator, nproc, pid, outdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    device = None if len(argv) < 5 or argv[4] == "cuda" else argv[4]
    torch.set_num_threads(1)
    info = initialize_multihost(coordinator_address=coordinator, num_processes=nproc,
                                process_id=pid, device=device)
    assert info["process_count"] == nproc, info
    try:
        traces = run_cluster_selftest(device)
        np.savez(os.path.join(outdir, f"worker_{pid}.npz"), info=json.dumps(info), **traces)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
