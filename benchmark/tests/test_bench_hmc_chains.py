"""The entry ``hmc_chains`` (the port's ``run_hmc_chains``) on a tiny cell.

``bench_chains.chains_copy`` adds the cell ``module_tiny.chains_tiny`` (a
conv -> FRN -> swish -> pool -> linear classifier, 3 chains) to a copy of
the benchmark from new files only.  On the CPU: the copy of the port's
noise streams draws what the port draws, bit for bit; the float64
reference computes the port's posterior and sampler (both in float64);
the cell keeps the layout's rules; the port itself and the float64
stand-in come out correct; each planted fault and the TF32 control come
out not correct.  Marked ``gpu`` (skipping without a CUDA device): the
streams and the cell on the card.
"""

import functools
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from bench_chains import CELL, chains_copy
from bench_tiny import entry_of, run_tiny, tiny_copy
from test_bench_layout import _digests, check_cell, check_chips, check_config

from benchmark import core
from benchmark.reference import hmc_chains as ref
from benchmark.reference import numerics, streams
from hamiltorch_tpu_torch.models.bnn import define_model_log_prob
from hamiltorch_tpu_torch.samplers.driver import MCMCConfig
from hamiltorch_tpu_torch.samplers.hmc import run_hmc_chains
from hamiltorch_tpu_torch.utils.rng import draw_noise

SEEDS = [11, 2**31 + 5, 3_000_000_019]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return chains_copy(tmp_path_factory.mktemp("chains"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same_noise(seed, dtype, device):
    for chains, dim in ((1, 1), (5, 37)):
        for n in (0, 1, 9, 2**33 + 1):
            want = draw_noise(seed, n, chains, dim, dtype, device)
            got = streams.draw_noise(seed, n, chains, dim, dtype, device)
            assert all(torch.equal(a, b) for a, b in zip(want, got)), (seed, n, chains)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_streams_draw_the_ports_noise(seed, dtype):
    _same_noise(seed, dtype, "cpu")


def _problem(bench, seed):
    c = core.Cell.find(CELL, bench)
    data = core.load_module("inputs", c.config["model"]).make(c.config, c.traffic["chains"], seed,
                                                              "cpu")
    return c, data


def test_reference_posterior_is_the_ports_in_float64(bench):
    c, d = _problem(bench, 5)
    module = d["module"].double()
    theta = d["theta"].double()
    lp = define_model_log_prob(module, c.config["model_loss"], d["x"], d["y"],
                               tau_list=c.config["prior_precision"],
                               tau_out=c.config["tau_out"], device="cpu")[0]
    want = torch.func.vmap(torch.func.grad_and_value(lp))(theta)
    got = ref.Posterior(module, d["x"], d["y"], {**c.config, "reference_rows": 100})(theta)
    torch.testing.assert_close(got[0], want[1], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(got[1], want[0], rtol=1e-10, atol=1e-10)


def test_reference_sampler_is_the_ports_in_float64(bench):
    c, d = _problem(bench, 7)
    module, theta, t = d["module"].double(), d["theta"].double(), c.traffic
    lp = define_model_log_prob(module, c.config["model_loss"], d["x"], d["y"],
                               tau_list=c.config["prior_precision"],
                               tau_out=c.config["tau_out"], device="cpu")[0]
    config = MCMCConfig(num_samples=4, num_steps_per_sample=t["steps"], step_size=0.1)
    res = run_hmc_chains(123, lp, theta, config, t["chains"])
    chain, lanes, count, h0, h1 = ref.hmc(123, ref.Posterior(module, d["x"], d["y"], c.config),
                                          theta, 4, t["steps"], 0.1, torch.float64)
    assert chain.tolist() == list(range(t["chains"]))
    assert 0 < count.sum() < 4 * t["chains"]  # both outcomes of the Metropolis test
    torch.testing.assert_close(res.final_state.theta, lanes, rtol=0, atol=1e-10)
    torch.testing.assert_close(res.acc_rate, count / 4)
    torch.testing.assert_close(res.stats.energy_old, h0, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(res.stats.energy_new, h1, rtol=1e-12, atol=1e-9)


def test_control_rounds_every_products_operands():
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(2, 3, 5, 5, generator=gen), torch.randn(4, 3, 3, 3, generator=gen)
    a, b = torch.randn(6, 7, generator=gen), torch.randn(7, 2, generator=gen)
    g = torch.randn(2, 4, 5, 5, generator=gen)
    r = numerics.to_tf32
    want = (F.conv2d(r(x), r(w), None, 1, 1), F.linear(r(a), r(b.T)), torch.matmul(r(a), r(b)),
            torch.nn.grad.conv2d_input(x.shape, r(w), r(g), 1, 1))
    x.requires_grad_(True)
    with ref.TF32Products():
        conv = F.conv2d(x, w, None, 1, 1)
        got = (conv, F.linear(a, b.T), a @ b, torch.autograd.grad(conv, x, g)[0])
        with pytest.raises(NotImplementedError):
            torch.einsum("ij,jk->ik", a, b)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert not torch.equal(want[2], a @ b)


def test_the_cell_is_added_from_new_files_only(bench, tmp_path):
    """Every file of a copy without the cell is in the copy with it, unchanged,
    but BENCHMARK.json."""
    tiny_copy(tmp_path)
    before, after = _digests(tmp_path), _digests(bench.parent)
    assert all(after[path] == digest for path, digest in before.items())
    assert set(after) - set(before) == {Path("benchmark", kind, name) for kind, name in (
        ("configs", "module_tiny.json"), ("traffic", "chains_tiny.json"),
        ("limits", f"{CELL}.json"))}


def test_the_cell_keeps_the_layout(bench):
    spec = json.loads(bench.read_text())
    check_cell(CELL, bench)
    check_config(next(c for c in spec["configs"] if c["name"] == "module_tiny"), bench)
    check_chips(spec)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_port_is_correct(bench, seed):
    result = run_tiny(bench, CELL, None, seed=seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"theta_gap", "acc_gap", "energy_gap"}
    assert result["metrics"]["grad_evals_per_s"]["value"] > 0


def _fault(sound, fault):
    @functools.wraps(sound)  # keeps the stand-in's ``posterior``
    def run(key, log_prob_fn, theta0, *args):
        out = sound(key, log_prob_fn, theta0, *args)
        theta = out.final_state.theta
        if fault == "unchanged":
            out.final_state.theta = theta0.clone()
        elif fault == "half":
            theta[: len(theta) // 2] = theta0[: len(theta) // 2]
        elif fault == "altered":
            k = int((theta - theta0).abs().argmax())
            theta.view(-1)[k] = theta0.reshape(-1)[k]
        elif fault == "zeroed":
            out.acc_rate = torch.zeros_like(out.acc_rate)
        elif fault == "energy":  # the last draw's energy left from the draw before
            out.stats.energy_new[0, -1] = out.stats.energy_new[0, -2]
        return out

    return run


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered", "zeroed", "energy"])
def test_fault_is_caught(bench, fault):
    sound = entry_of(bench, CELL).Cell.stand_in("float64")
    result = run_tiny(bench, CELL, sound if fault is None else _fault(sound, fault))
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(bench, seed):
    control = entry_of(bench, CELL).Cell.stand_in("tf32")
    result = run_tiny(bench, CELL, control, seed=seed)
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streams_draw_the_ports_noise_on_the_card(card, dtype):
    for seed in SEEDS:
        _same_noise(seed, dtype, "cuda:0")


@pytest.mark.gpu
def test_the_cell_on_the_card(card, bench):
    """The port through the harness on the card, with cuDNN's TF32 off (the
    float32 the configuration states)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = core.run(CELL, 2**31 + 11, 1.0, False, device="cuda:0", bench_file=bench,
                          log=lambda line: None)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
