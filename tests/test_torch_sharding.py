"""The port's ``parallel/sharding.py`` on multi-rank gloo groups.

One spawned cluster runs every multi-rank case: four processes form a
4-rank group (the 2x2 mesh and the 4-rank chains mesh), then two of them a
2-rank group (chains=2 and data=2).  Each rank saves its global result;
the tests compare rank 0's against the port's unsharded runner on the same
seed (every rank must hold the same result):

* chains-only meshes bit for bit (each chain draws what it draws unsharded);
* data meshes within 1e-5 (the all-reduce reassociates the sums; the JAX
  package's own class, tests/test_multihost.py);
* the pooled ensembles (ChEES, pooled NUTS) in float64, within 1e-9.

``make_psum_log_prob`` and ``run_svgd_sharded`` are also held against the
JAX package's, inside ``shard_map`` on 2 of the 8 fake CPU devices that
tests/conftest.py sets up.  Run ``python tests/test_torch_sharding.py
<rank> <port4> <port2> <dir>`` to be one worker of the cluster.
"""

import dataclasses
import os
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
from hamiltorch_tpu_torch.parallel import sharding as sh  # noqa: E402

LAUNCH_TIMEOUT = 120.0
CHAINS = 4
SCALES = [1.0, 2.0, 0.5]
ROWS = 16
N_TERMS, BATCH = 4, 8


def gauss_lp(t):
    s = torch.tensor(SCALES, dtype=t.dtype)
    return -0.5 * torch.sum((t / s) ** 2)


def tree_lp(t):
    return -0.5 * torch.sum(t["a"] ** 2) - 0.125 * torch.sum(t["b"] ** 2)


def regression(dtype=torch.float32):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(ROWS, 3))
    y = x @ np.array([0.5, -1.0, 0.25]) + 0.3 * rng.normal(size=ROWS)
    return torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)


def loglik_shard(t, xs, ys):
    return -0.5 * torch.sum((xs @ t - ys) ** 2)


def log_prior(t):
    return -0.125 * torch.sum(t**2)


def TREE0():
    return {"a": torch.zeros(1), "b": torch.zeros(2)}


def tree_loglik(p, xs, ys):
    # a tree state through the data-summed potential (raveled, leaf order a, b)
    return loglik_shard(torch.cat([p["a"], p["b"]]), xs, ys)


def tree_prior(p):
    return log_prior(torch.cat([p["a"], p["b"]]))


def full_lp(dtype=torch.float32):
    x, y = regression(dtype)
    return lambda t: log_prior(t) + loglik_shard(t, x, y)


def sg_data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N_TERMS, BATCH, 3)).astype(np.float32)
    y = (x @ np.array([0.5, -1.0, 0.25], np.float32)).astype(np.float32)
    return torch.tensor(x), torch.tensor(y)


def sg_term(t, m, d):
    return -0.5 * torch.sum((d[0][m] @ t - d[1][m]) ** 2)


def sg_term_local(t, m, d):
    return sg_term(t, m, d) + log_prior(t) / N_TERMS


HMC = tht.MCMCConfig(num_samples=6, num_steps_per_sample=3, step_size=0.3)
HMC_DATA = tht.MCMCConfig(num_samples=6, num_steps_per_sample=3, step_size=0.1)
NUTS = tht.NUTSConfig(num_samples=5, step_size=0.4, max_tree_depth=4)
NUTS_DATA = tht.NUTSConfig(num_samples=4, step_size=0.15, max_tree_depth=4)
NUTS_POOLED = tht.NUTSConfig(num_samples=12, step_size=0.4, burn=8, max_tree_depth=4,
                             adapt_step_size=True)
CHEES = tht.ChEESConfig(num_samples=12, step_size=0.3, burn=8)
CHEES_DATA = tht.ChEESConfig(num_samples=8, step_size=0.1, burn=5)
MCLMC = tht.MCLMCConfig(num_samples=6, tune_steps=4)
MAMS = tht.MAMSConfig(num_samples=6, num_steps_per_sample=3, burn=3)
BARKER = tht.BarkerConfig(num_samples=6, burn=3)
STRETCH = tht.StretchConfig(num_samples=5)
PT = tht.PTConfig(num_samples=6, num_steps_per_sample=3, step_size=0.2, num_temps=3)
TI = tht.TIConfig(num_samples=6, num_steps_per_sample=3, step_size=0.1, num_temps=4, burn=2)
SGLD = tht.SGLDConfig(num_samples=6, step_size=1e-3)
SGHMC = tht.SGHMCConfig(num_samples=6, step_size=1e-3)
CSG = tht.CSGMCMCConfig(num_cycles=2, cycle_length=5, step_size=1e-3, exploration_frac=0.6)
SVGD = tht.SVGDConfig(num_steps=8, step_size=0.05)
SVGD_PARTICLES = 8
PSUM_THETAS = np.array([[0.1, -0.2, 0.3], [1.0, 0.5, -0.5], [-0.3, 0.0, 0.7]], np.float32)


def f64(t):
    return torch.as_tensor(t, dtype=torch.float64)


# name -> (world, (chains, data), sharded(mesh, inputs), reference(inputs), mode)
# mode: "exact" (bit for bit), "close" (1e-5), "f64" (float64, 1e-9)
CASES = {
    "hmc_c2": (2, (2, 1), lambda m, _: sh.run_hmc_chains_sharded(
        3, gauss_lp, torch.zeros(3), HMC, m, CHAINS),
        lambda _: tht.run_hmc_chains(3, gauss_lp, torch.zeros(3), HMC, CHAINS), "exact"),
    "hmc_c2d2": (4, (2, 2), lambda m, _: sh.run_hmc_chains_sharded(
        3, gauss_lp, torch.zeros(3), HMC, m, CHAINS),
        lambda _: tht.run_hmc_chains(3, gauss_lp, torch.zeros(3), HMC, CHAINS), "exact"),
    "hmc_tree_c4": (4, (4, 1), lambda m, _: sh.run_hmc_chains_sharded(
        4, tree_lp, {"a": torch.zeros(2), "b": torch.ones(3)}, HMC, m, CHAINS),
        lambda _: tht.run_hmc_chains(4, tree_lp, {"a": torch.zeros(2), "b": torch.ones(3)},
                                     HMC, CHAINS), "exact"),
    "nuts_c2": (2, (2, 1), lambda m, _: sh.run_nuts_chains_sharded(
        5, gauss_lp, torch.zeros(3), NUTS, m, CHAINS),
        lambda _: tht.run_nuts_chains(5, gauss_lp, torch.zeros(3), NUTS, CHAINS), "exact"),
    "rmhmc_c2": (2, (2, 1), lambda m, _: sh.run_rmhmc_chains_sharded(
        6, gauss_lp, torch.zeros(3), tht.MCMCConfig(num_samples=3, num_steps_per_sample=2,
                                                    step_size=0.2), m, CHAINS),
        lambda _: tht.run_rmhmc_chains(6, gauss_lp, torch.zeros(3), tht.MCMCConfig(
            num_samples=3, num_steps_per_sample=2, step_size=0.2), CHAINS), "exact"),
    "mclmc_c2": (2, (2, 1), lambda m, _: sh.run_mclmc_sharded(
        7, gauss_lp, torch.zeros(3), MCLMC, m, CHAINS),
        lambda _: tht.run_mclmc_chains(7, gauss_lp, torch.zeros(3), MCLMC, CHAINS), "exact"),
    "mams_c2": (2, (2, 1), lambda m, _: sh.run_mams_sharded(
        8, gauss_lp, torch.zeros(3), MAMS, m, CHAINS),
        lambda _: tht.run_mams_chains(8, gauss_lp, torch.zeros(3), MAMS, CHAINS), "exact"),
    "barker_c2d2": (4, (2, 2), lambda m, _: sh.run_barker_sharded(
        9, gauss_lp, torch.zeros(3), BARKER, m, CHAINS),
        lambda _: tht.run_barker_chains(9, gauss_lp, torch.zeros(3), BARKER, CHAINS), "exact"),
    "stretch_c2": (2, (2, 1), lambda m, _: sh.run_stretch_sharded(
        10, gauss_lp, torch.zeros(3), STRETCH, m, 4, num_walkers=8),
        lambda _: _stack_stretch(10, 4), "exact"),
    "pt_c2": (2, (2, 1), lambda m, _: sh.run_pt_sharded(
        11, gauss_lp, torch.zeros(3), PT, m, CHAINS),
        lambda _: tht.run_pt_chains(11, gauss_lp, torch.zeros(3), PT, CHAINS), "exact"),
    # data meshes: the full-batch run on the gathered data
    "hmc_data_d2": (2, (1, 2), lambda m, _: sh.sample_chains_sharded(
        12, loglik_shard, log_prior, *regression(), torch.zeros(3), HMC_DATA, m, CHAINS),
        lambda _: tht.run_hmc_chains(12, full_lp(), torch.zeros(3), HMC_DATA, CHAINS), "close"),
    "hmc_data_c2d2": (4, (2, 2), lambda m, _: sh.sample_chains_sharded(
        12, loglik_shard, log_prior, *regression(), torch.zeros(3), HMC_DATA, m, CHAINS),
        lambda _: tht.run_hmc_chains(12, full_lp(), torch.zeros(3), HMC_DATA, CHAINS), "close"),
    "nuts_data_d2": (2, (1, 2), lambda m, _: sh.sample_nuts_chains_sharded(
        13, loglik_shard, log_prior, *regression(), torch.zeros(3), NUTS_DATA, m, CHAINS),
        lambda _: tht.run_nuts_chains(13, full_lp(), torch.zeros(3), NUTS_DATA, CHAINS),
        "close"),
    "mclmc_data_d2": (2, (1, 2), lambda m, _: sh.sample_mclmc_sharded(
        14, loglik_shard, log_prior, *regression(), torch.zeros(3), MCLMC, m, CHAINS),
        lambda _: tht.run_mclmc_chains(14, full_lp(), torch.zeros(3), MCLMC, CHAINS), "close"),
    # float64: the trajectory's float32 energy change is a difference of two
    # much larger potentials, so in float32 a reassociated sum moved it by
    # 8e-4 of itself
    "mams_data_d2": (2, (1, 2), lambda m, _: sh.sample_mams_sharded(
        15, loglik_shard, log_prior, *regression(torch.float64), f64(torch.zeros(3)), MAMS, m, CHAINS),
        lambda _: tht.run_mams_chains(15, full_lp(torch.float64), f64(torch.zeros(3)), MAMS,
                                      CHAINS), "close"),
    "pt_data_d2": (2, (1, 2), lambda m, _: sh.sample_pt_sharded(
        16, loglik_shard, log_prior, *regression(), torch.zeros(3), PT, m, 2),
        lambda _: tht.run_pt_chains(16, full_lp(), torch.zeros(3), PT, 2), "close"),
    "ti_data_d2": (2, (1, 2), lambda m, _: sh.run_ti_sharded(
        17, log_prior, loglik_shard, *regression(), torch.zeros(3), TI, m),
        lambda _: tht.run_ti(17, log_prior, lambda t: loglik_shard(t, *regression()), torch.zeros(3),
                             TI), "close"),
    "sgld_data_c2d2": (4, (2, 2), lambda m, _: sh.run_sgld_sharded(
        18, sg_term, log_prior, N_TERMS, torch.zeros(3), SGLD, m, CHAINS, sg_data()),
        lambda _: tht.run_sgld_chains(18, sg_term_local, N_TERMS, torch.zeros(3), SGLD, CHAINS,
                                      data=sg_data()), "close"),
    "sghmc_data_d2": (2, (1, 2), lambda m, _: sh.run_sghmc_sharded(
        19, sg_term, log_prior, N_TERMS, torch.zeros(3), SGHMC, m, CHAINS, sg_data()),
        lambda _: tht.run_sghmc_chains(19, sg_term_local, N_TERMS, torch.zeros(3), SGHMC,
                                       CHAINS, data=sg_data()), "close"),
    "csgmcmc_data_d2": (2, (1, 2), lambda m, _: sh.run_csgmcmc_sharded(
        20, sg_term, log_prior, N_TERMS, torch.zeros(3), CSG, m, CHAINS, sg_data()),
        lambda _: tht.run_csgmcmc_chains(20, sg_term_local, N_TERMS, torch.zeros(3), CSG,
                                         CHAINS, data=sg_data()), "close"),
    "svgd_data_d2": (2, (1, 2), lambda m, inp: sh.run_svgd_sharded(
        21, loglik_shard, log_prior, *regression(), torch.zeros(3), SVGD, m, SVGD_PARTICLES,
        _noise=inp["svgd_noise"]),
        lambda inp: tht.run_svgd(21, full_lp(), torch.zeros(3), SVGD, SVGD_PARTICLES,
                                 _noise=inp["svgd_noise"]), "close"),
    "svgd_tree_data_d2": (2, (1, 2), lambda m, inp: sh.run_svgd_sharded(
        21, tree_loglik, tree_prior, *regression(), TREE0(), SVGD, m, SVGD_PARTICLES,
        _noise=inp["svgd_noise"]),
        lambda inp: tht.run_svgd(21, lambda p: tree_prior(p) + tree_loglik(p, *regression()), TREE0(),
                                 SVGD, SVGD_PARTICLES, _noise=inp["svgd_noise"]), "close"),
    # pooled ensembles, float64
    "chees_c2": (2, (2, 1), lambda m, _: sh.run_chees_sharded(
        22, gauss_lp, f64(torch.zeros(3)), CHEES, m, CHAINS),
        lambda _: tht.run_chees(22, gauss_lp, f64(torch.zeros(3)), CHEES, CHAINS), "f64"),
    "chees_mass_c2d2": (4, (2, 2), lambda m, _: sh.run_chees_sharded(
        23, gauss_lp, f64(torch.zeros(3)), dataclasses.replace(CHEES, adapt_mass=True), m,
        CHAINS),
        lambda _: tht.run_chees(23, gauss_lp, f64(torch.zeros(3)),
                                dataclasses.replace(CHEES, adapt_mass=True), CHAINS), "f64"),
    "chees_data_c2d2": (4, (2, 2), lambda m, _: sh.sample_chees_sharded(
        24, loglik_shard, log_prior, *regression(torch.float64), f64(torch.zeros(3)), CHEES_DATA, m,
        CHAINS),
        lambda _: tht.run_chees(24, full_lp(torch.float64), f64(torch.zeros(3)), CHEES_DATA,
                                CHAINS), "f64"),
    "nuts_pooled_c2": (2, (2, 1), lambda m, _: sh.run_nuts_ensemble_sharded(
        25, gauss_lp, f64(torch.zeros(3)), dataclasses.replace(NUTS_POOLED, adapt_mass=True),
        m, CHAINS),
        lambda _: tht.run_nuts_ensemble(25, gauss_lp, f64(torch.zeros(3)),
                                        dataclasses.replace(NUTS_POOLED, adapt_mass=True),
                                        CHAINS), "f64"),
    "nuts_pooled_data_c2d2": (4, (2, 2), lambda m, _: sh.sample_nuts_ensemble_sharded(
        26, loglik_shard, log_prior, *regression(torch.float64), f64(torch.zeros(3)),
        dataclasses.replace(NUTS_POOLED, step_size=0.15), m, CHAINS),
        lambda _: tht.run_nuts_ensemble(26, full_lp(torch.float64), f64(torch.zeros(3)),
                                        dataclasses.replace(NUTS_POOLED, step_size=0.15),
                                        CHAINS), "f64"),
}


def _stack_stretch(key, ensembles):
    runs = [tht.run_stretch(sh.stretch_ensemble_key(key, e), gauss_lp, torch.zeros(3), STRETCH,
                            num_walkers=8) for e in range(ensembles)]
    return sh._map_paths(lambda path, _: torch.stack([sh._get(r, path) for r in runs]),
                         runs[0])


def flatten(obj) -> dict:
    """Every tensor of a result as a numpy array, keyed by its path."""
    out = {}

    def put(path, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out["/".join(str(p) for p in path)] = t.numpy()
        return t

    sh._map_paths(put, obj)
    return out


def _psum_values(mesh):
    """Port's data-summed potential: value and gradient, batched and single."""
    x, y = regression()
    xs, ys = sh._data_shard(mesh, torch.device("cpu"), x, y)
    lp = sh.make_psum_log_prob(loglik_shard, log_prior, xs, ys, mesh.get_group("data"))
    thetas = torch.tensor(PSUM_THETAS)
    from hamiltorch_tpu_torch.ops.potential import value_and_grad

    vals, grads = torch.func.vmap(value_and_grad(lp))(thetas)
    v1, g1 = value_and_grad(lp)(thetas[1])
    return {"vals": vals.numpy(), "grads": grads.numpy(), "v1": v1.numpy(), "g1": g1.numpy()}


def _errors(world):
    """The JAX error cases, on this world's meshes: message or ''."""
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)

    catch("bad_mesh", lambda: sh.make_mesh(chains=3, data=1, device="cpu"))
    mesh = sh.make_mesh(chains=world, data=1, device="cpu")
    catch("chains", lambda: sh.run_hmc_chains_sharded(0, gauss_lp, torch.zeros(3), HMC, mesh, 3))
    catch("pooled_chains", lambda: sh.run_chees_sharded(0, gauss_lp, torch.zeros(3), CHEES,
                                                        mesh, 3))
    mesh = sh.make_mesh(chains=1, data=world, device="cpu")
    x, y = regression()
    catch("data", lambda: sh.sample_chains_sharded(0, loglik_shard, log_prior, x[:-1], y[:-1],
                                                   torch.zeros(3), HMC, mesh, 2))
    catch("sg_data", lambda: sh.run_sgld_sharded(0, sg_term, log_prior, N_TERMS, torch.zeros(3),
                                                 SGLD, mesh, 2, (sg_data()[0][:, :-1],)))
    return out


def worker(rank: int, port4: int, port2: int, outdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    inputs = {k: torch.tensor(v) for k, v in inputs.items()}
    for world, port in ((4, port4), (2, port2)):
        if rank >= world:
            break
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        results = {}
        for name, (w, shape, sharded, _, _) in CASES.items():
            if w != world:
                continue
            mesh = sh.make_mesh(*shape, device="cpu")
            t0 = time.perf_counter()
            for k, v in flatten(sharded(mesh, inputs)).items():
                results[f"{name}::{k}"] = v
            results[f"{name}::seconds"] = np.array(time.perf_counter() - t0)
        if world == 2:
            for k, v in _psum_values(sh.make_mesh(1, 2, device="cpu")).items():
                results[f"psum::{k}"] = v
        for k, v in _errors(world).items():
            results[f"errors{world}::{k}"] = np.array(v)
        np.savez(os.path.join(outdir, f"w{world}_r{rank}.npz"), **results)
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_svgd_noise():
    import jax

    return np.asarray(jax.random.normal(jax.random.key(21), (SVGD_PARTICLES, 3), np.float32))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Spawn the 4-process cluster once; return {world: [per-rank dicts]}."""
    outdir = str(tmp_path_factory.mktemp("sharding"))
    np.savez(os.path.join(outdir, "inputs.npz"), svgd_noise=_jax_svgd_noise())
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("CUDA_VISIBLE_DEVICES", None)
    ports = (str(_free_port()), str(_free_port()))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), *ports, outdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    logs, failed = [], False
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
    assert not failed, "\n---\n".join((log or "")[-3000:] for log in logs)
    return {w: [dict(np.load(os.path.join(outdir, f"w{w}_r{r}.npz"))) for r in range(w)]
            for w in (4, 2)}


def _case(cluster, name):
    world = CASES[name][0]
    ranks = cluster[world]
    prefix = f"{name}::"
    got = [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)} for r in ranks]
    for other in got[1:]:  # every rank holds the same global result
        assert other.keys() == got[0].keys()
        for k in got[0]:
            if k != "seconds":
                np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)
    return got[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_runner_matches_the_local_runner(cluster, name):
    """Every ported sharded runner against the port's local runner on the
    same seed: chains-only meshes bit for bit, data meshes within 1e-5,
    pooled ensembles within 1e-9 in float64."""
    _, _, _, reference, mode = CASES[name]
    got = _case(cluster, name)
    inputs = {"svgd_noise": torch.tensor(_jax_svgd_noise())}
    want = flatten(reference(inputs))
    assert set(want) == set(got) - {"seconds"}, name
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if mode == "exact" or w.dtype == bool or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            tol = 1e-9 if mode == "f64" else 1e-5
            scale = max(float(np.max(np.abs(w))), 1.0) if w.size else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=k)


def test_psum_log_prob_is_the_full_batch_potential_and_jax_s(cluster):
    """The data-summed potential on a 2-rank data mesh: value and gradient
    equal the full-batch ones (not twice the local gradient) and the JAX
    package's ``make_psum_log_prob`` inside ``shard_map`` on 2 of the fake
    devices, within 1e-6 relative."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from hamiltorch_tpu.parallel.sharding import make_psum_log_prob as jmake

    got = {k[len("psum::"):]: v for k, v in cluster[2][0].items() if k.startswith("psum::")}
    lp = full_lp()
    from hamiltorch_tpu_torch.ops.potential import value_and_grad

    vals, grads = torch.func.vmap(value_and_grad(lp))(torch.tensor(PSUM_THETAS))
    scale = float(np.abs(grads.numpy()).max())
    np.testing.assert_allclose(got["vals"], vals.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["grads"], grads.numpy(), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got["v1"], vals[1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["g1"], grads[1].numpy(), rtol=0, atol=1e-6 * scale)
    # the naive sum would double the likelihood's gradient: far from it
    x, y = regression()
    ll_grad = torch.func.vmap(torch.func.grad(lambda t: loglik_shard(t, x, y)))(
        torch.tensor(PSUM_THETAS))
    assert np.abs(got["grads"] - (grads + ll_grad).numpy()).max() > 1e3 * 1e-6 * scale

    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("chains", "data"))
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def local(th, xs, ys):
        f = jmake(lambda t, a, b: -0.5 * jnp.sum((a @ t - b) ** 2),
                  lambda t: -0.125 * jnp.sum(t**2), xs, ys)
        return jax.vmap(jax.value_and_grad(f))(th)

    jv, jg = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                                   out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(PSUM_THETAS), xj, yj)
    np.testing.assert_allclose(got["vals"], np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(got["grads"], np.asarray(jg), rtol=0, atol=1e-6 * scale)


def test_svgd_sharded_matches_jax_s(cluster):
    """``run_svgd_sharded`` on a 2-rank data mesh from JAX's initial cloud
    against the JAX package's ``run_svgd_sharded`` on 2 fake devices."""
    import jax
    import jax.numpy as jnp

    from hamiltorch_tpu.parallel.sharding import make_mesh as jmesh, run_svgd_sharded as jsvgd
    from hamiltorch_tpu.svgd import SVGDConfig as JC

    got = _case(cluster, "svgd_data_d2")
    x, y = regression()
    r = jsvgd(jax.random.key(21), lambda t, a, b: -0.5 * jnp.sum((a @ t - b) ** 2),
              lambda t: -0.125 * jnp.sum(t**2), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
              jnp.zeros(3), JC(num_steps=SVGD.num_steps, step_size=SVGD.step_size),
              jmesh(1, 2, devices=jax.devices()[:2]), num_particles=SVGD_PARTICLES)
    want = np.asarray(r.particles)
    np.testing.assert_allclose(got["particles"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got["bandwidth_trace"], np.asarray(r.bandwidth_trace), rtol=1e-5)
    assert int(got["num_rejected"]) == int(r.num_rejected) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_the_jax_error_cases(cluster, world):
    """A mesh that does not match the group, chains that do not divide the
    chain ranks (independent and pooled), and data that does not divide
    the data ranks raise the JAX package's messages."""
    errs = {k.split("::")[1]: str(v) for k, v in cluster[world][0].items()
            if k.startswith(f"errors{world}::")}
    assert errs["bad_mesh"] == f"mesh 3x1 needs 3 devices, have {world}"
    assert errs["chains"] == f"num_chains=3 not divisible by {world} devices"
    assert errs["pooled_chains"] == f"num_chains=3 not divisible by {world} devices"
    assert errs["data"] == f"data length {ROWS - 1} not divisible by mesh data={world}"
    assert "divisible by mesh data" in errs["sg_data"]


def test_one_rank_group_starts_on_request():
    """Without a process group, a 1x1 CPU mesh starts a one-rank gloo group;
    a chains-sharded run on it is the local run bit for bit."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("chains", "data")
        got = sh.run_hmc_chains_sharded(3, gauss_lp, torch.zeros(3), HMC, mesh, CHAINS)
        want = tht.run_hmc_chains(3, gauss_lp, torch.zeros(3), HMC, CHAINS)
        for k, v in flatten(want).items():
            np.testing.assert_array_equal(flatten(got)[k], v, err_msg=k)
        with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
            sh.make_mesh(1, 2, device="cpu")
    finally:
        dist.destroy_process_group()
    # a mesh dimension name needs a live mesh
    with pytest.raises(ValueError, match="needs a mesh"):
        sh.resolve_group("data")


def test_progress_is_ignored_with_a_message(capsys):
    cfg = dataclasses.replace(HMC, progress_every=2)
    assert sh._warn_progress_ignored(cfg).progress_every == 0
    assert "ignored" in capsys.readouterr().err
    assert sh._warn_progress_ignored(HMC) is HMC


def test_derive_chain_keys_are_the_global_indices():
    assert list(sh.derive_chain_keys(5, 4)) == [0, 1, 2, 3]
    assert list(sh.derive_chain_keys(5, 4)[2:4]) == [2, 3]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
