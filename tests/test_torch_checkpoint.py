"""The port's checkpointed runners (``hamiltorch_tpu_torch/checkpoint.py``).

For each of the six runners (HMC, HMC chains, NUTS, the pooled NUTS
ensemble, MCLMC, MAMS), on a small Gaussian with windowed warmup where the
sampler has it (burn 160 puts a slow window across the chunks), and for
RMHMC, split HMC, ChEES (flat, tree, dense warmup with ``thin``),
SGLD / pSGLD / SGHMC, PT, TI, Barker and the stretch move:

* a run stopped part-way and resumed equals the straight sampler call with
  the same key bit for bit, at two chunkings (every draw's noise is keyed
  on the global draw index and the port runs eagerly; SG-MCMC's chunks
  hold whole thinning windows);
* a changed stream-changing option raises the fingerprint ``ValueError``;
  ``num_samples`` and ``progress_every`` do not;
* ``resume=False`` clears the old chunks;
* a bfloat16 trace (a bfloat16 chain, or NUTS's ``trace_dtype``) comes back
  bit for bit;
* a directory written by the JAX package's ``run_hmc_checkpointed`` is
  refused;
* ``mesh=`` (the pooled NUTS ensemble, ChEES, PT ensembles) on a 2-rank
  gloo group: one spawned cluster runs every case, and a run stopped
  part-way and resumed equals the straight sharded run bit for bit; a
  directory written without a mesh is refused on one.
"""

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import hamiltorch_tpu_torch as tht  # noqa: E402
from hamiltorch_tpu_torch import checkpoint as ck  # noqa: E402
from hamiltorch_tpu_torch.utils.pytree import tree_leaves  # noqa: E402

SCALES = torch.tensor([1.0, 2.0, 0.5, 1.5])
RUNNERS = ["hmc", "hmc_chains", "nuts", "nuts_ensemble", "mclmc", "mams"]
CHAINS = 3
# (draws of the straight run, draws of the first, interrupted, call)
DRAWS = {"hmc": (170, 90), "hmc_chains": (170, 90), "nuts": (170, 90),
         "nuts_ensemble": (170, 90), "mclmc": (40, 17), "mams": (30, 13)}
# two chunkings per runner: a small one and one that leaves a partial chunk
CHUNKS = {"hmc": (16, 60), "hmc_chains": (16, 60), "nuts": (16, 60),
          "nuts_ensemble": (16, 60), "mclmc": (6, 15), "mams": (4, 11)}


def log_prob(t):
    return -0.5 * torch.sum((t / SCALES.to(t.dtype)) ** 2) + 0.1 * torch.sum(torch.sin(t))


def start(dtype=torch.float32):
    return torch.tensor([0.5, -0.3, 0.2, 0.8], dtype=dtype)


def config(name, num_samples, **kw):
    if name in ("hmc", "hmc_chains"):
        return tht.MCMCConfig(num_samples=num_samples, num_steps_per_sample=3, step_size=0.3,
                              burn=160, adapt_step_size=True, adapt_mass="diag", **kw)
    if name in ("nuts", "nuts_ensemble"):
        return tht.NUTSConfig(num_samples=num_samples, step_size=0.4, burn=160,
                              max_tree_depth=4, adapt_mass="diag", **kw)
    if name == "mclmc":
        return tht.MCLMCConfig(num_samples=num_samples, tune_steps=20, **kw)
    return tht.MAMSConfig(num_samples=num_samples, num_steps_per_sample=4, burn=6, **kw)


def straight(name, cfg, theta0):
    """The sampler's own call with key 5, as the runner returns it."""
    if name == "hmc":
        return tht.run_hmc(5, log_prob, theta0, cfg)
    if name == "hmc_chains":
        return tht.run_hmc_chains(5, log_prob, theta0, cfg, CHAINS)
    if name == "nuts":
        return tht.run_nuts(5, log_prob, theta0, cfg)[0]
    if name == "nuts_ensemble":
        return tht.run_nuts_ensemble(5, log_prob, theta0, cfg, CHAINS)
    if name == "mclmc":
        return tht.run_mclmc(5, log_prob, theta0, cfg)
    return tht.run_mams(5, log_prob, theta0, cfg)


def checkpointed(name, cfg, theta0, ckpt_dir, chunk, **kw):
    if name == "hmc":
        return ck.run_hmc_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, chunk_size=chunk, **kw)
    if name == "hmc_chains":
        return ck.run_hmc_chains_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, CHAINS,
                                              chunk_size=chunk, **kw)
    if name == "nuts":
        return ck.run_nuts_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, chunk_size=chunk,
                                        **kw)
    if name == "nuts_ensemble":
        return ck.run_nuts_ensemble_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, CHAINS,
                                                 chunk_size=chunk, **kw)
    if name == "mclmc":
        return ck.run_mclmc_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, chunk_size=chunk,
                                         **kw)
    return ck.run_mams_checkpointed(5, log_prob, theta0, cfg, ckpt_dir, chunk_size=chunk, **kw)


def assert_same(got, want):
    """Every tensor of the two results equal bit for bit, but acc_rate, which
    the HMC runners sum per chunk (equal within two roundings of its dtype)."""
    if isinstance(want, tuple) and not hasattr(want, "_fields"):  # (result, info)
        for a, b in zip(got, want):
            assert_same(a, b)
        return
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "acc_rate" and isinstance(got, tht.MCMCResult):
            torch.testing.assert_close(a, b, rtol=2 * torch.finfo(b.dtype).eps, atol=0)
            continue
        if dataclasses.is_dataclass(b):
            a, b = [getattr(a, f.name) for f in dataclasses.fields(a)], [
                getattr(b, f.name) for f in dataclasses.fields(b)]
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb), field
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert same_bits(x, y), field


def same_bits(a, b):
    """Equal tensors, bit for bit: a NaN (a diverged draw's energy) equals a
    NaN with the same bits at the same place."""
    if torch.equal(a, b):
        return True
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.is_floating_point() and a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])))


def chunk_files(path):
    return sorted(f for f in os.listdir(path) if f.startswith("chunk_"))


@pytest.mark.parametrize("name", RUNNERS)
def test_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    total, first = DRAWS[name]
    want = straight(name, config(name, total), start())
    for chunk in CHUNKS[name]:
        d = str(tmp_path / f"c{chunk}")
        part = checkpointed(name, config(name, first), start(), d, chunk)
        assert_same(part, straight(name, config(name, first), start()))
        resumed = checkpointed(name, config(name, total), start(), d, chunk)
        assert_same(resumed, want)
        assert len(chunk_files(d)) >= total // chunk


@pytest.mark.parametrize("name", RUNNERS)
def test_a_changed_option_raises_and_the_cosmetic_ones_do_not(name, tmp_path):
    total, first = 12, 8
    d = str(tmp_path)
    checkpointed(name, config(name, first), start(), d, 4)
    changed = dataclasses.replace(config(name, total), step_size=0.25)
    with pytest.raises(ValueError, match="fingerprint"):
        checkpointed(name, changed, start(), d, 4)
    with pytest.raises(ValueError, match="fingerprint"):  # another start dtype
        checkpointed(name, config(name, total), start(torch.float64), d, 4)
    cosmetic = {"progress_every": 5} if hasattr(config(name, 1), "progress_every") else {}
    got = checkpointed(name, config(name, total, **cosmetic), start(), d, 4)
    assert_same(got, straight(name, config(name, total), start()))


@pytest.mark.parametrize("name", RUNNERS)
def test_resume_false_clears_old_chunks(name, tmp_path):
    d = str(tmp_path)
    checkpointed(name, config(name, 12), start(), d, 2)
    assert len(chunk_files(d)) == 6
    other = dataclasses.replace(config(name, 8), step_size=0.25)
    got = checkpointed(name, other, start(), d, 4, resume=False)
    assert chunk_files(d) == ["chunk_00000000.npz", "chunk_00000004.npz"]
    assert_same(got, straight(name, other, start()))


@pytest.mark.parametrize("name", RUNNERS)
def test_bfloat16_trace_round_trips(name, tmp_path):
    """A bfloat16 trace through the chunk files: NUTS's trace_dtype with a
    float32 chain, the other samplers' bfloat16 chains."""
    if name.startswith("nuts"):
        cfg, theta0 = config(name, 12, trace_dtype="bfloat16"), start()
    else:
        cfg, theta0 = config(name, 12), start(torch.bfloat16)
    got = checkpointed(name, cfg, theta0, str(tmp_path), 5)
    want = straight(name, cfg, theta0)
    assert tree_leaves(got[0] if isinstance(got, tuple) and name == "nuts_ensemble"
                       else got)[0].dtype == torch.bfloat16
    assert_same(got, want)
    assert_same(checkpointed(name, cfg, theta0, str(tmp_path), 5), want)  # read back


def test_tree_states_resume(tmp_path):
    """A parameter-tree chain: the trace is saved leaf by leaf and rebuilt."""
    tree = {"a": torch.tensor([0.5, -0.3]), "b": torch.tensor([[0.2], [0.8]])}

    def lp(t):
        return log_prob(torch.cat([t["a"], t["b"].reshape(-1)]))

    cfg = tht.NUTSConfig(num_samples=10, step_size=0.4, burn=5, max_tree_depth=4)
    want = tht.run_nuts_ensemble(5, lp, tree, cfg, CHAINS)
    ck.run_nuts_ensemble_checkpointed(5, lp, tree, dataclasses.replace(cfg, num_samples=4),
                                      str(tmp_path), CHAINS, chunk_size=3)
    got = ck.run_nuts_ensemble_checkpointed(5, lp, tree, cfg, str(tmp_path), CHAINS,
                                            chunk_size=3)
    assert_same(got, want)
    hmc_cfg = tht.MCMCConfig(num_samples=10, num_steps_per_sample=3, step_size=0.3)
    got = ck.run_hmc_chains_checkpointed(5, lp, tree, hmc_cfg, str(tmp_path / "h"), CHAINS,
                                         chunk_size=4)
    assert_same(got, tht.run_hmc_chains(5, lp, tree, hmc_cfg, CHAINS))


# --- mesh=: one 2-rank gloo cluster runs every case -------------------------------

MESH_CHAINS = 4
MESH_TIMEOUT = 120.0
MESH_NUTS = tht.NUTSConfig(num_samples=24, step_size=0.4, burn=12, max_tree_depth=4,
                           adapt_mass="diag")
MESH_CHEES = tht.ChEESConfig(num_samples=24, step_size=0.3, burn=12, adapt_mass="diag")
MESH_PT = tht.PTConfig(num_samples=24, num_steps_per_sample=3, step_size=0.3, num_temps=3,
                       max_temp=10.0, burn=8, adapt_ladder=True, adapt_step_size=True)


def _mesh_runs(name, mesh, d, n, chunk=5, num_chains=MESH_CHAINS):
    """(straight sharded run, checkpointed mesh run) of ``n`` draws in ``d``."""
    from hamiltorch_tpu_torch.parallel import sharding as sh

    if name == "nuts_ensemble":
        cfg = dataclasses.replace(MESH_NUTS, num_samples=n)
        return (sh.run_nuts_ensemble_sharded(5, log_prob, start(), cfg, mesh, num_chains),
                ck.run_nuts_ensemble_checkpointed(5, log_prob, start(), cfg, d, num_chains,
                                                  chunk_size=chunk, mesh=mesh))
    if name == "chees":
        cfg = dataclasses.replace(MESH_CHEES, num_samples=n)
        return (plain(sh.run_chees_sharded(5, log_prob, start(), cfg, mesh, num_chains)),
                plain(ck.run_chees_checkpointed(5, log_prob, start(), cfg, d, num_chains,
                                                chunk_size=chunk, mesh=mesh)))
    cfg = dataclasses.replace(MESH_PT, num_samples=n)
    return (plain(sh.run_pt_sharded(5, log_prob, start(), cfg, mesh, num_chains)),
            plain(ck.run_pt_checkpointed(5, log_prob, start(), cfg, d, chunk_size=chunk,
                                         num_ensembles=num_chains, mesh=mesh)))


def _flatten(obj) -> dict:
    from hamiltorch_tpu_torch.parallel import sharding as sh

    out = {}

    def put(path, t):
        out["/".join(str(p) for p in path)] = t.detach().float().numpy() \
            if t.dtype == torch.bfloat16 else t.detach().numpy()
        return t

    sh._map_paths(put, obj)
    return out


def mesh_worker(rank: int, port: int, outdir: str) -> None:
    """One rank of the mesh cluster: every mesh= case, saved to
    ``outdir/r<rank>.npz``."""
    import torch.distributed as dist

    from hamiltorch_tpu_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    mesh = sh.make_mesh(2, 1, device="cpu")
    out = {}
    for name in ("nuts_ensemble", "chees", "pt"):
        d = os.path.join(outdir, name)  # one directory every rank names
        straight_part, part = _mesh_runs(name, mesh, d, 10)
        straight_full, full = _mesh_runs(name, mesh, d, 24)
        for tag, res in (("straight_part", straight_part), ("part", part),
                         ("straight_full", straight_full), ("full", full)):
            out.update({f"{name}::{tag}::{k}": v for k, v in _flatten(res).items()})
        # a run at another chunking from scratch
        _, other = _mesh_runs(name, mesh, d + "_c7", 24, chunk=7)
        out.update({f"{name}::other::{k}": v for k, v in _flatten(other).items()})
        try:  # chains that do not divide the ranks
            _mesh_runs(name, mesh, d + "_odd", 12, num_chains=3)
            out[f"{name}::odd"] = np.array("")
        except ValueError as e:
            out[f"{name}::odd"] = np.array(str(e))
    # a directory written without a mesh is refused on one (each rank its own)
    d = os.path.join(outdir, f"plain_{rank}")
    ck.run_chees_checkpointed(5, log_prob, start(), dataclasses.replace(MESH_CHEES,
                                                                        num_samples=6),
                              d, MESH_CHAINS, chunk_size=3)
    try:
        ck.run_chees_checkpointed(5, log_prob, start(), MESH_CHEES, d, MESH_CHAINS,
                                  chunk_size=3, mesh=mesh)
        out["chees::unsharded_dir"] = np.array("")
    except ValueError as e:
        out["chees::unsharded_dir"] = np.array(str(e).replace(d, "<dir>"))
    np.savez(os.path.join(outdir, f"r{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_cluster(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), port, outdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline, logs, failed = time.monotonic() + MESH_TIMEOUT, [], False
    for p in procs:
        try:
            log, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            failed = True
        logs.append(log)
        failed = failed or p.returncode != 0
    assert not failed, "\n---\n".join((log or "")[-3000:] for log in logs)
    ranks = [dict(np.load(os.path.join(outdir, f"r{r}.npz"))) for r in range(2)]
    for k, v in ranks[0].items():  # every rank holds the same global result
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    return ranks[0]


def _mesh_result(cluster, name, tag):
    prefix = f"{name}::{tag}::"
    return {k[len(prefix):]: v for k, v in cluster.items() if k.startswith(prefix)}


def _assert_mesh_resumes(cluster, name):
    """The resumed mesh run equals the straight sharded run bit for bit, at
    two chunkings, as does the interrupted first call."""
    for got_tag, want_tag in (("part", "straight_part"), ("full", "straight_full"),
                              ("other", "straight_full")):
        got, want = _mesh_result(cluster, name, got_tag), _mesh_result(cluster, name, want_tag)
        assert got.keys() == want.keys() and want, (name, got_tag)
        for k, w in want.items():
            if k == "0/acc_rate":  # summed per chunk by the HMC-style assembly
                np.testing.assert_allclose(got[k], w, rtol=4e-7, err_msg=k)
                continue
            np.testing.assert_array_equal(got[k], w, err_msg=f"{name} {got_tag} {k}")
    assert f"not divisible by 2 devices" in str(cluster[f"{name}::odd"])


def test_ensemble_mesh_raises(mesh_cluster):
    """``run_nuts_ensemble_checkpointed(mesh=)`` on a 2-rank group: stopped
    and resumed, it equals ``run_nuts_ensemble_sharded`` bit for bit at two
    chunkings; chains that do not divide the ranks raise."""
    _assert_mesh_resumes(mesh_cluster, "nuts_ensemble")


@pytest.fixture(scope="module")
def jax_written_dir(tmp_path_factory):
    """A directory the JAX package's run_hmc_checkpointed wrote."""
    import jax
    import jax.numpy as jnp

    import hamiltorch_tpu as jht
    from hamiltorch_tpu.checkpoint import run_hmc_checkpointed

    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    run_hmc_checkpointed(jax.random.key(0), lambda t: -0.5 * jnp.sum(t ** 2),
                         jnp.asarray(start().numpy()),
                         jht.MCMCConfig(num_samples=6, num_steps_per_sample=3, step_size=0.3),
                         d, chunk_size=3)
    assert sorted(os.listdir(d)) == ["chunk_00000000.npz", "chunk_00000003.npz", "state.npz"]
    return d


@pytest.mark.parametrize("name", RUNNERS)
def test_a_directory_the_jax_package_wrote_is_refused(name, jax_written_dir, tmp_path):
    d = str(tmp_path / "copy")
    shutil.copytree(jax_written_dir, d)
    cfg = (tht.MCMCConfig(num_samples=9, num_steps_per_sample=3, step_size=0.3)
           if name.startswith("hmc") else config(name, 9))
    with pytest.raises(ValueError, match="fingerprint"):
        checkpointed(name, cfg, start(), d, 3)


def test_archive_keeps_bfloat16_bits(tmp_path):
    """bfloat16 has no numpy dtype: its 16-bit patterns go to disk and come
    back exactly, NaN payloads and signed zeros included."""
    bits = torch.tensor([0x7FC1, -0x8000, 0x0001, 0x3F80, -0x0081], dtype=torch.int16)
    t = bits.view(torch.bfloat16)
    path = str(tmp_path / "a.npz")
    np.savez(path, **ck._archive({"t": t, "f": torch.ones(2)}))
    z = np.load(path)
    assert torch.equal(ck._tensor_of(z, "t").view(torch.int16), bits)
    assert ck._tensor_of(z, "f").dtype == torch.float32


# --- RMHMC and split HMC -------------------------------------------------------

def banana(t):
    return -0.5 * (t[0] ** 2 / 4.0) - 0.5 * ((t[1] - 0.1 * (t[0] ** 2 - 4.0)) ** 2) / 0.5


SPLIT_DATA = torch.tensor(np.random.RandomState(0).randn(3, 4, 2), dtype=torch.float32)


def split_term(t, m, data):
    flat = torch.cat([t["a"], t["b"]]) if isinstance(t, dict) else t
    return -0.5 * torch.sum((flat - data[m]) ** 2) / 3.0 + 0.1 * torch.sum(torch.sin(flat))


# name -> (straight(cfg, **kw), checkpointed(cfg, dir, chunk, **kw), theta0)
RM_SPLIT = {
    "rmhmc-implicit-jitter": (
        lambda cfg, **kw: tht.run_rmhmc(5, banana, torch.tensor([0.4, -0.2]), cfg, **kw),
        lambda cfg, d, c, **kw: ck.run_rmhmc_checkpointed(5, banana, torch.tensor([0.4, -0.2]),
                                                          cfg, d, chunk_size=c, **kw),
        dict(metric=tht.Metric.SOFTABS, softabs_const=1e2, jitter=0.05,
             fixed_point_max_iterations=4)),
    "rmhmc-explicit": (
        lambda cfg, **kw: tht.run_rmhmc(5, banana, torch.tensor([0.4, -0.2]), cfg, **kw),
        lambda cfg, d, c, **kw: ck.run_rmhmc_checkpointed(5, banana, torch.tensor([0.4, -0.2]),
                                                          cfg, d, chunk_size=c, **kw),
        dict(integrator=tht.Integrator.EXPLICIT, metric=tht.Metric.JACOBIAN_DIAG, jitter=0.3)),
    "split-rand": (
        lambda cfg, **kw: tht.samplers.run_split_hmc_stacked(
            5, split_term, 3, torch.zeros(2), cfg, data=SPLIT_DATA, **kw),
        lambda cfg, d, c, **kw: ck.run_split_hmc_checkpointed(
            5, split_term, 3, torch.zeros(2), cfg, d, chunk_size=c, data=SPLIT_DATA, **kw),
        dict(integrator=tht.Integrator.SPLITTING_RAND)),
    "split-tree": (
        lambda cfg, **kw: tht.samplers.run_split_hmc_stacked(
            5, split_term, 3, {"a": torch.zeros(1), "b": torch.zeros(1)}, cfg,
            data=SPLIT_DATA, **kw),
        lambda cfg, d, c, **kw: ck.run_split_hmc_checkpointed(
            5, split_term, 3, {"a": torch.zeros(1), "b": torch.zeros(1)}, cfg, d, chunk_size=c,
            data=SPLIT_DATA, **kw),
        dict(integrator=tht.Integrator.SPLITTING, inv_mass=torch.tensor([0.8, 1.3]))),
}


def rm_split_config(num_samples):
    return tht.MCMCConfig(num_samples=num_samples, num_steps_per_sample=2, step_size=0.4,
                          burn=5, adapt_step_size=True)


@pytest.mark.parametrize("name", sorted(RM_SPLIT))
def test_rmhmc_and_split_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    run, run_ck, kw = RM_SPLIT[name]
    want = run(rm_split_config(11), **kw)
    for chunk in (2, 4):
        d = str(tmp_path / f"c{chunk}")
        assert_same(run_ck(rm_split_config(7), d, chunk, **kw), run(rm_split_config(7), **kw))
        assert_same(run_ck(rm_split_config(11), d, chunk, **kw), want)


@pytest.mark.parametrize("name", sorted(RM_SPLIT))
def test_rmhmc_and_split_refuse_a_changed_option(name, tmp_path):
    """The integrator (and the metric options, the number of terms) enter
    the fingerprint, beside the config."""
    run, run_ck, kw = RM_SPLIT[name]
    d = str(tmp_path / "d")
    run_ck(rm_split_config(4), d, 2, **kw)
    other = (dict(kw, integrator=tht.Integrator.MIDPOINT) if name.startswith("rmhmc")
             else dict(kw, integrator=tht.Integrator.SPLITTING_KMID))
    with pytest.raises(ValueError, match="fingerprint"):
        run_ck(rm_split_config(6), d, 2, **other)
    with pytest.raises(ValueError, match="fingerprint"):
        run_ck(dataclasses.replace(rm_split_config(6), step_size=0.3), d, 2, **kw)
    assert_same(run_ck(rm_split_config(6), d, 2, **kw), run(rm_split_config(6), **kw))


# --- ChEES and SG-MCMC -----------------------------------------------------------

def tree_log_prob(t):
    return log_prob(torch.cat([t["a"], t["b"].reshape(-1)]))


def tree_start(dtype=torch.float32):
    flat = start(dtype)
    return {"a": flat[:2], "b": flat[2:].reshape(2, 1)}


# name -> (log_prob, start, config fields); burn 160 puts a slow window across chunks
CHEES = {
    "flat-diag": (log_prob, start, dict(adapt_mass="diag")),
    "tree-diag-halton": (tree_log_prob, tree_start,
                         dict(adapt_mass=True, trajectory_jitter="halton")),
    "flat-dense-thin": (log_prob, start, dict(adapt_mass="dense", thin=2)),
}


def chees_config(name, num_samples, **kw):
    return tht.ChEESConfig(num_samples=num_samples, step_size=0.3, burn=160,
                           **dict(CHEES[name][2], **kw))


def plain(res):
    """A ChEESResult with its carry's dual-averaging state as a tuple."""
    return res._replace(final_carry=res.final_carry._replace(da=ck._da_tuple(res.final_carry.da)))


@pytest.mark.parametrize("name", sorted(CHEES))
def test_chees_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    lp, theta0, _ = CHEES[name]
    want = plain(tht.run_chees(5, lp, theta0(), chees_config(name, 170), CHAINS))
    for chunk in (16, 60):
        d = str(tmp_path / f"c{chunk}")
        part = ck.run_chees_checkpointed(5, lp, theta0(), chees_config(name, 90), d, CHAINS,
                                         chunk_size=chunk)
        assert_same(plain(part), plain(tht.run_chees(5, lp, theta0(), chees_config(name, 90),
                                                     CHAINS)))
        got = ck.run_chees_checkpointed(5, lp, theta0(), chees_config(name, 170), d, CHAINS,
                                        chunk_size=chunk)
        assert_same(plain(got), want)


def test_chees_refuses_a_changed_option_and_mesh(tmp_path, mesh_cluster):
    d = str(tmp_path)
    ck.run_chees_checkpointed(5, log_prob, start(), chees_config("flat-diag", 8), d, CHAINS,
                              chunk_size=4)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_chees_checkpointed(5, log_prob, start(),
                                  chees_config("flat-diag", 12, trajectory_jitter="halton"), d,
                                  CHAINS, chunk_size=4)
    # mesh=: resumed equals run_chees_sharded; an unsharded directory is refused
    _assert_mesh_resumes(mesh_cluster, "chees")
    assert "fingerprint" in str(mesh_cluster["chees::unsharded_dir"])
    bf = chees_config("flat-diag", 12, trace_dtype="bfloat16")
    got = ck.run_chees_checkpointed(5, log_prob, start(), bf, str(tmp_path / "bf"), CHAINS,
                                    chunk_size=5)
    assert got.samples.dtype == torch.bfloat16
    assert_same(plain(got), plain(tht.run_chees(5, log_prob, start(), bf, CHAINS)))


SG_TERMS = 3


def sg_term(t, m):
    flat = torch.cat([t["a"], t["b"].reshape(-1)]) if isinstance(t, dict) else t
    return log_prob(flat) / SG_TERMS + 0.2 * (m - 1) * torch.sum(flat)


# name -> (straight runner, checkpointed runner, start, config, inv_mass)
SG = {
    "sgld": (tht.run_sgld, ck.run_sgld_checkpointed, start,
             lambda n: tht.SGLDConfig(num_samples=n, step_size=0.05, thin=2), None),
    "psgld-tree": (tht.run_sgld, ck.run_sgld_checkpointed, tree_start,
                   lambda n: tht.SGLDConfig(num_samples=n, step_size=0.02, thin=2,
                                            preconditioner="rmsprop"), None),
    "sghmc-refresh": (tht.run_sghmc, ck.run_sghmc_checkpointed, start,
                      lambda n: tht.SGHMCConfig(num_samples=n, step_size=0.02, thin=2,
                                                resample_momentum_every=5),
                      torch.tensor([1.0, 2.0, 0.5, 1.5])),
}


@pytest.mark.parametrize("name", sorted(SG))
def test_sgmcmc_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    run, run_ck, theta0, cfg, pre = SG[name]
    want = run(5, sg_term, SG_TERMS, theta0(), cfg(30), inv_mass=pre)
    for chunk in (4, 10):
        d = str(tmp_path / f"c{chunk}")
        assert_same(run_ck(5, sg_term, SG_TERMS, theta0(), cfg(14), d, chunk_size=chunk,
                           inv_mass=pre),
                    run(5, sg_term, SG_TERMS, theta0(), cfg(14), inv_mass=pre))
        assert_same(run_ck(5, sg_term, SG_TERMS, theta0(), cfg(30), d, chunk_size=chunk,
                           inv_mass=pre), want)


@pytest.mark.parametrize("name", sorted(SG))
def test_sgmcmc_refuses_a_changed_option_and_keeps_bfloat16(name, tmp_path):
    run, run_ck, theta0, cfg, pre = SG[name]
    d = str(tmp_path / "d")
    run_ck(5, sg_term, SG_TERMS, theta0(), cfg(8), d, chunk_size=4, inv_mass=pre)
    with pytest.raises(ValueError, match="fingerprint"):  # another number of terms
        run_ck(5, sg_term, SG_TERMS + 1, theta0(), cfg(12), d, chunk_size=4, inv_mass=pre)
    with pytest.raises(ValueError, match="fingerprint"):
        run_ck(5, sg_term, SG_TERMS, theta0(), dataclasses.replace(cfg(12), step_size=0.03), d,
               chunk_size=4, inv_mass=pre)
    bf = theta0(torch.bfloat16)
    got = run_ck(5, sg_term, SG_TERMS, bf, cfg(12), str(tmp_path / "bf"), chunk_size=4,
                 inv_mass=pre)
    assert tree_leaves(got.samples)[0].dtype == torch.bfloat16
    assert_same(got, run(5, sg_term, SG_TERMS, bf, cfg(12), inv_mass=pre))


# --- parallel tempering and thermodynamic integration -----------------------------

# name -> (log_prob, start, num_ensembles, num_temps)
PT = {
    "single-K3": (log_prob, start, None, 3),
    "ensembles-K4": (log_prob, start, 2, 4),
    "tree-K4": (tree_log_prob, tree_start, None, 4),
    "tree-ensembles-K3": (tree_log_prob, tree_start, 2, 3),
}


def pt_config(name, num_samples, **kw):
    """Ladder and step-size adaptation over burn 20: the chunkings of 7 and
    16 draws put a boundary inside the burn window and at an odd draw (the
    swap parity)."""
    fields = dict(num_steps_per_sample=3, step_size=0.3, num_temps=PT[name][3], max_temp=10.0,
                  burn=20, adapt_ladder=True, adapt_step_size=True)
    return tht.PTConfig(num_samples=num_samples, **dict(fields, **kw))


def pt_straight(name, num_samples):
    lp, theta0, ens, _ = PT[name]
    if ens is None:
        return tht.run_parallel_tempering(5, lp, theta0(), pt_config(name, num_samples))
    return tht.run_pt_chains(5, lp, theta0(), pt_config(name, num_samples), ens)


def pt_checkpointed(name, num_samples, ckpt_dir, chunk, **kw):
    lp, theta0, ens, _ = PT[name]
    return ck.run_pt_checkpointed(5, lp, theta0(), pt_config(name, num_samples), ckpt_dir,
                                  chunk_size=chunk, num_ensembles=ens, **kw)


@pytest.mark.parametrize("name", sorted(PT))
def test_pt_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    want = plain(pt_straight(name, 40))
    for chunk in (7, 16):
        d = str(tmp_path / f"c{chunk}")
        assert_same(plain(pt_checkpointed(name, 25, d, chunk)), plain(pt_straight(name, 25)))
        assert_same(plain(pt_checkpointed(name, 40, d, chunk)), want)


def test_pt_refuses_a_changed_option_a_jax_directory_and_mesh(tmp_path, jax_written_dir,
                                                               mesh_cluster):
    d = str(tmp_path / "a")
    pt_checkpointed("single-K3", 8, d, 4)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_pt_checkpointed(5, log_prob, start(), pt_config("single-K3", 8, max_temp=20.0), d)
    with pytest.raises(ValueError, match="fingerprint"):  # the same ladder as two ensembles
        ck.run_pt_checkpointed(5, log_prob, start(), pt_config("single-K3", 8), d,
                               num_ensembles=2)
    pt_checkpointed("single-K3", 12, d, 4, resume=True)  # num_samples is cosmetic
    j = str(tmp_path / "jax")
    shutil.copytree(jax_written_dir, j)
    with pytest.raises(ValueError, match="fingerprint"):
        pt_checkpointed("single-K3", 8, j, 4)
    with pytest.raises(ValueError, match="pass num_ensembles"):
        pt_checkpointed("single-K3", 8, str(tmp_path / "m"), 4, mesh=object())
    # mesh=: resumed equals run_pt_sharded, itself run_pt_chains bit for bit
    _assert_mesh_resumes(mesh_cluster, "pt")
    want = _flatten(plain(tht.run_pt_chains(5, log_prob, start(), MESH_PT, MESH_CHAINS)))
    got = _mesh_result(mesh_cluster, "pt", "full")
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with pytest.raises(ValueError, match="replicas"):
        ck.run_pt_checkpointed(5, log_prob, torch.zeros(4, 2),
                               tht.PTConfig(num_samples=8, num_temps=8), str(tmp_path / "r"))


def ti_prior(t):
    flat = torch.cat([t["a"], t["b"].reshape(-1)]) if isinstance(t, dict) else t
    return -0.5 * torch.sum(flat ** 2)


def ti_lik(t):
    return tree_log_prob(t) if isinstance(t, dict) else log_prob(t)


def ti_config(num_samples):
    return tht.TIConfig(num_samples=num_samples, num_steps_per_sample=3, step_size=0.3,
                        num_temps=4, burn=20)


TI_STARTS = {"flat": start, "tree": tree_start, "bfloat16": lambda: start(torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(TI_STARTS))
def test_ti_resume_equals_the_straight_run_at_two_chunkings(name, tmp_path):
    """Chunks of 7 and 16 split the dual-averaging window (burn 20); a
    bfloat16 state keeps its dtype through the files."""
    theta0 = TI_STARTS[name]
    want = tht.run_ti(5, ti_prior, ti_lik, theta0(), ti_config(40))
    for chunk in (7, 16):
        d = str(tmp_path / f"c{chunk}")
        assert_same(ck.run_ti_checkpointed(5, ti_prior, ti_lik, theta0(), ti_config(25), d,
                                           chunk_size=chunk),
                    tht.run_ti(5, ti_prior, ti_lik, theta0(), ti_config(25)))
        got = ck.run_ti_checkpointed(5, ti_prior, ti_lik, theta0(), ti_config(40), d,
                                     chunk_size=chunk)
        assert_same(got, want)
    assert tree_leaves(want.samples)[0].dtype == tree_leaves(theta0())[0].dtype


def test_ti_resume_from_a_longer_completed_run_truncates(tmp_path, jax_written_dir):
    d = str(tmp_path / "long")
    ck.run_ti_checkpointed(5, ti_prior, ti_lik, start(), ti_config(40), d, chunk_size=16)
    short = ck.run_ti_checkpointed(5, ti_prior, ti_lik, start(), ti_config(30), d, chunk_size=16)
    want = tht.run_ti(5, ti_prior, ti_lik, start(), ti_config(30))
    assert short.samples.shape == (10, 4)
    assert_same(short, want)
    j = str(tmp_path / "jax")
    shutil.copytree(jax_written_dir, j)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_ti_checkpointed(5, ti_prior, ti_lik, start(), ti_config(30), j)
    with pytest.raises(RuntimeError, match="burn"):
        ck.run_ti_checkpointed(5, ti_prior, ti_lik, start(), ti_config(20), str(tmp_path / "b"))


def barker_config(num_samples, **kw):
    # burn 20 puts the Welford window [5, 15) and the scale switch at 15 across chunks
    return tht.BarkerConfig(num_samples=num_samples, burn=20, step_size=0.8, adapt_scale=True,
                            **kw)


GRADIENT_FREE_STARTS = {"flat": start, "tree": tree_start,
                        "bfloat16": lambda: start(torch.bfloat16)}


def barker_pair(name, num_samples, ckpt_dir, chunk, **kw):
    lp = tree_log_prob if name == "tree" else log_prob
    theta0 = GRADIENT_FREE_STARTS[name]
    return (ck.run_barker_checkpointed(5, lp, theta0(), barker_config(num_samples, **kw),
                                       ckpt_dir, chunk_size=chunk),
            tht.run_barker(5, lp, theta0(), barker_config(num_samples, **kw)))


def stretch_pair(name, num_samples, ckpt_dir, chunk, **kw):
    lp = tree_log_prob if name == "tree" else log_prob
    theta0 = GRADIENT_FREE_STARTS[name]
    cfg = tht.StretchConfig(num_samples=num_samples, **kw)
    return (ck.run_stretch_checkpointed(5, lp, theta0(), cfg, ckpt_dir, chunk_size=chunk,
                                        num_walkers=8),
            tht.run_stretch(5, lp, theta0(), cfg, num_walkers=8))


@pytest.mark.parametrize("sampler", ["barker", "stretch"])
@pytest.mark.parametrize("name", sorted(GRADIENT_FREE_STARTS))
def test_gradient_free_resume_equals_the_straight_run_at_two_chunkings(sampler, name, tmp_path):
    """A run stopped after 25 draws and resumed to 40 equals the straight
    run, at chunks of 7 and 16 (Barker's adaptation windows cross them); a
    bfloat16 state keeps its dtype through the files."""
    pair = barker_pair if sampler == "barker" else stretch_pair
    for chunk in (7, 16):
        d = str(tmp_path / f"c{chunk}")
        assert_same(*pair(name, 25, d, chunk))
        got, want = pair(name, 40, d, chunk)
        assert_same(got, want)
        assert "chunk_00000025.npz" in os.listdir(d)  # the second call resumed at draw 25
    assert tree_leaves(want.samples)[0].dtype == tree_leaves(GRADIENT_FREE_STARTS[name]())[0].dtype


def test_gradient_free_thin_and_longer_directories(tmp_path):
    got, want = barker_pair("flat", 40, str(tmp_path / "b"), 9, thin=2)
    assert_same(got, want)
    assert got.samples.shape == (20, 4)
    got, want = stretch_pair("flat", 40, str(tmp_path / "s"), 9, thin=4)
    assert_same(got, want)
    assert got.samples.shape == (10, 8, 4)
    # a directory left by a longer completed run gives exactly the requested
    # draws (its final state is the longer run's, as in the JAX package)
    short, want = stretch_pair("flat", 32, str(tmp_path / "s"), 9, thin=4)
    assert same_bits(short.samples, want.samples)
    assert_same(short.stats, want.stats)


def test_gradient_free_refuse_a_changed_option_and_a_jax_directory(tmp_path, jax_written_dir):
    d = str(tmp_path / "b")
    barker_pair("flat", 25, d, 10)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_barker_checkpointed(5, log_prob, start(), barker_config(40, thin=5), d)
    with pytest.raises(ValueError, match="fingerprint"):  # another start dtype
        ck.run_barker_checkpointed(5, log_prob, start(torch.float64), barker_config(40), d)
    d = str(tmp_path / "s")
    stretch_pair("flat", 25, d, 10)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_stretch_checkpointed(5, log_prob, start(), tht.StretchConfig(num_samples=40),
                                    d, num_walkers=10)
    with pytest.raises(ValueError, match="fingerprint"):
        ck.run_stretch_checkpointed(5, log_prob, start(), tht.StretchConfig(num_samples=40, a=3.0),
                                    d, num_walkers=8)
    for runner in ("barker", "stretch"):
        j = str(tmp_path / f"jax_{runner}")
        shutil.copytree(jax_written_dir, j)
        with pytest.raises(ValueError, match="fingerprint"):
            if runner == "barker":
                ck.run_barker_checkpointed(5, log_prob, start(), barker_config(40), j)
            else:
                ck.run_stretch_checkpointed(5, log_prob, start(), tht.StretchConfig(num_samples=40),
                                            j, num_walkers=8)
    with pytest.raises(RuntimeError, match="burn"):
        ck.run_barker_checkpointed(5, log_prob, start(), barker_config(20), str(tmp_path / "x"))


if __name__ == "__main__":
    mesh_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
