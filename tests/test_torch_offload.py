"""Host offload of the trace (``store_on_GPU=False``) and progress lines.

``run_hmc_host_offload`` runs the chain in chunks and moves each chunk's
trace to the host.  Each draw's noise is keyed on (seed, chain, global draw
index) and every chunk continues the last one's state, dual averaging and
windowed-warmup carry, so the trace equals ``run_hmc``'s bit for bit at any
chunking, thinned or not, with ``adapt_mass`` too (an eager loop does the
same operations in the same order either way; the JAX package allows ~1 ulp
there, where its chunked and unchunked programs compile differently).  The
JAX package's own offload runner is held against its ``run_hmc`` the same
way, at its stated tolerance, so the two packages make the same promise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamiltorch_tpu as jht
import hamiltorch_tpu_torch as tht
from hamiltorch_tpu_torch.utils import progress
from hamiltorch_tpu_torch.utils.pytree import tree_leaves

STDS = torch.tensor([0.5, 1.0, 2.0])


def gauss(t):
    return -0.5 * torch.sum((t / STDS) ** 2)


def gauss_tree(p):
    return -0.5 * torch.sum((p["a"] / 0.5) ** 2) - 0.5 * torch.sum(p["b"] ** 2)


def same_bits(a, b):
    """Equal tensors, bit for bit: a NaN (a diverged draw's energy) equals a
    NaN with the same bits at the same place."""
    if torch.equal(a, b):
        return True
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.is_floating_point() and a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])))


def assert_same_result(got, want):
    assert got.samples.device.type == "cpu"
    assert torch.equal(got.samples, want.samples)
    for name in want.stats._fields:
        assert same_bits(getattr(got.stats, name), getattr(want.stats, name)), name
    assert torch.equal(got.final_step_size, want.final_step_size)
    assert torch.equal(got.final_state.theta, want.final_state.theta)
    torch.testing.assert_close(got.acc_rate, want.acc_rate, rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [1, 3, 7, 256])
@pytest.mark.parametrize("thin", [1, 2])
@pytest.mark.parametrize("adapt", [False, True])
def test_offload_matches_run_hmc_bit_for_bit(chunk, thin, adapt):
    kw = dict(num_samples=24, num_steps_per_sample=4, step_size=0.4, thin=thin)
    if adapt:
        kw.update(burn=8, adapt_step_size=True)
    cfg = tht.MCMCConfig(**kw)
    want = tht.run_hmc(5, gauss, torch.ones(3), cfg)
    got = tht.run_hmc_host_offload(5, gauss, torch.ones(3), cfg, chunk_size=chunk)
    assert_same_result(got, want)


@pytest.mark.parametrize("adapt_mass", ["diag", "dense"])
@pytest.mark.parametrize("chunk", [7, 50])
def test_offload_with_windowed_warmup(adapt_mass, chunk):
    """The chunks continue the warmup's Welford moments, metric and window
    schedule; the port's chunked trace is its unchunked one, bit for bit."""
    cfg = tht.MCMCConfig(num_samples=200, num_steps_per_sample=5, step_size=0.3, burn=150,
                         adapt_step_size=True, adapt_mass=adapt_mass)
    want = tht.run_hmc(6, gauss, torch.ones(3), cfg)
    got = tht.run_hmc_host_offload(6, gauss, torch.ones(3), cfg, chunk_size=chunk)
    assert_same_result(got, want)
    for a, b in zip(tree_leaves(got.final_warm), tree_leaves(want.final_warm)):
        assert torch.equal(a, b)


def test_jax_offload_makes_the_same_promise():
    """The reference's runner against its own run_hmc, at its stated
    tolerance for adapt_mass (~1 ulp at window ends); bit for bit without."""
    lp = lambda t: -0.5 * jnp.sum((t / jnp.array([0.5, 1.0, 2.0])) ** 2)  # noqa: E731
    key = jax.random.key(6)
    for kw, exact in ((dict(), True), (dict(burn=150, adapt_step_size=True, adapt_mass="diag"),
                                       False)):
        cfg = jht.MCMCConfig(num_samples=200, num_steps_per_sample=5, step_size=0.3, **kw)
        want = np.asarray(jht.run_hmc(key, lp, jnp.ones(3), cfg).samples)
        got = jht.run_hmc_host_offload(key, lp, jnp.ones(3), cfg, chunk_size=50).samples
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_offload_on_a_tree_and_rerun_is_bitwise():
    tree = {"a": torch.zeros(2), "b": torch.ones(3)}
    cfg = tht.MCMCConfig(num_samples=10, num_steps_per_sample=3, step_size=0.3)
    want = tht.run_hmc(2, gauss_tree, tree, cfg)
    first = tht.run_hmc_host_offload(2, gauss_tree, tree, cfg, chunk_size=4)
    again = tht.run_hmc_host_offload(2, gauss_tree, tree, cfg, chunk_size=4)
    for k in tree:
        assert first.samples[k].device.type == "cpu"
        assert torch.equal(first.samples[k], want.samples[k])
        assert torch.equal(first.samples[k], again.samples[k])


@pytest.mark.parametrize("burn,thin,sampler", [(0, 1, "HMC"), (4, 2, "HMC"), (6, 1, "HMC_NUTS")])
def test_sample_store_on_gpu_false(burn, thin, sampler):
    kw = dict(num_samples=20, num_steps_per_sample=3, step_size=0.3, burn=burn, thin=thin,
              sampler=getattr(tht.Sampler, sampler), key=3, verbose=False, debug=2)
    on_device, aux = tht.sample(gauss, torch.ones(3), **kw)
    offloaded, aux_off = tht.sample(gauss, torch.ones(3), store_on_GPU=False, **kw)
    assert offloaded.device.type == "cpu"
    assert torch.equal(offloaded, on_device)
    np.testing.assert_allclose(aux_off, aux, rtol=1e-6)


def test_progress_lines(capsys, monkeypatch):
    monkeypatch.setattr(progress, "_REFRESH", -1.0)  # a line at every update
    plain = tht.sample(gauss, torch.ones(3), num_samples=12, key=1, verbose=False)
    capsys.readouterr()
    got = tht.sample(gauss, torch.ones(3), num_samples=12, key=1, progress_every=5)
    assert torch.equal(got, plain)  # the lines change no draw
    out = capsys.readouterr().out
    header, cols, rest = out.split("\n", 2)
    assert header == "Sampling" and cols.startswith("Time spent")
    counts = re.findall(r"\| +(\d+)/12 \|", rest)
    assert counts == ["0", "5", "10", "11"]  # every 5th draw, then the last line
    assert re.search(r"   \r\nAcceptance Rate \d\.\d\d\n$", rest)  # the bar ends its line


def test_progress_lines_restart_per_chunk(capsys, monkeypatch):
    """Each offload chunk is a run of its own: the bar restarts, as the
    JAX package's does per chunk."""
    monkeypatch.setattr(progress, "_REFRESH", -1.0)
    cfg = tht.MCMCConfig(num_samples=8, num_steps_per_sample=2, step_size=0.3, progress_every=2)
    tht.run_hmc_host_offload(0, gauss, torch.ones(3), cfg, chunk_size=4)
    out = capsys.readouterr().out
    assert out.count("Sampling\n") == 2
    assert re.findall(r"\| +(\d+)/4 \|", out) == ["0", "2", "3"] * 2


def banana(t):
    return -0.5 * (t[0] ** 2 / 4.0) - 0.5 * ((t[1] - 0.1 * (t[0] ** 2 - 4.0)) ** 2) / 0.5


@pytest.mark.parametrize("chunk", [3, 64])
@pytest.mark.parametrize("integrator", ["IMPLICIT", "EXPLICIT"])
def test_rmhmc_offload_matches_run_rmhmc_bit_for_bit(integrator, chunk):
    kw = dict(integrator=getattr(tht.Integrator, integrator), metric=tht.Metric.SOFTABS,
              softabs_const=1e2, jitter=0.05, fixed_point_max_iterations=4)
    cfg = tht.MCMCConfig(num_samples=8, num_steps_per_sample=2, step_size=0.4, burn=3,
                         adapt_step_size=True)
    want = tht.run_rmhmc(5, banana, torch.tensor([0.4, -0.2]), cfg, **kw)
    got = tht.samplers.run_rmhmc_host_offload(5, banana, torch.tensor([0.4, -0.2]), cfg,
                                              chunk_size=chunk, **kw)
    assert_same_result(got, want)


SPLIT_DATA = torch.tensor(np.random.RandomState(0).randn(3, 4, 3), dtype=torch.float32)


def split_term(t, m, data):
    return -0.5 * torch.sum((t - data[m]) ** 2) / 3.0 + 0.1 * torch.sum(torch.sin(t))


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("integrator", ["SPLITTING", "SPLITTING_RAND", "SPLITTING_KMID"])
def test_split_offload_matches_the_straight_run_bit_for_bit(integrator, chunk):
    kw = dict(integrator=getattr(tht.Integrator, integrator), data=SPLIT_DATA,
              inv_mass=torch.tensor([0.8, 1.3, 1.0]))
    cfg = tht.MCMCConfig(num_samples=10, num_steps_per_sample=2, step_size=0.5, thin=2)
    want = tht.samplers.run_split_hmc_stacked(5, split_term, 3, torch.zeros(3), cfg, **kw)
    got = tht.samplers.run_split_hmc_host_offload(5, split_term, 3, torch.zeros(3), cfg,
                                                  chunk_size=chunk, **kw)
    assert_same_result(got, want)
