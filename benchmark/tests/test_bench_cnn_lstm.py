"""The cell ``cnn_lstm_imdb.hmc_c1_l10``: its entry ``hmc_chains_blocked``, its
reference network and its counts, on a tiny CNN-LSTM cell on the CPU.

``bench_cnn_lstm.cnn_lstm_copy`` adds the cell ``cnn_lstm_tiny.cnn_lstm_tiny``
(every layer of the IMDB CNN-LSTM at a vocabulary of 300, 8-wide
embeddings, 6 filters and 5 cells over 64 reviews of 29 tokens, 2 chains;
the port's likelihood in blocks of 24 rows, the reference's in blocks of
40) to a copy of the benchmark from new files only.  On the CPU: the entry
is found from new files; the real port on blocks comes out correct and,
traced, reports its potential's host time and counts the recurrence's
steps and the embedding's ids; the float64 stand-in comes out correct and
each planted fault and the TF32 control come out not correct; the counts
hold at the cell's sizes, the operations against ``torch.utils.flop_counter``
on the reference network.
"""

import functools
import json
from pathlib import Path

import pytest
import torch
from bench_cnn_lstm import CELL, REAL, cnn_lstm_copy
from bench_tiny import ROOT, entry_of, run_tiny, tiny_copy
from test_bench_layout import _digests, check_cell, check_chips, check_config
from torch.utils.flop_counter import FlopCounterMode

from benchmark import core
from benchmark.metrics import counts_cnn_lstm as counts
from benchmark.reference.cnn_lstm_imdb import CNNLSTMIMDB
from hamiltorch_tpu_torch.models import cnn_lstm_imdb
from hamiltorch_tpu_torch.utils import profiling

SEEDS = [11, 2**31 + 5, 3_000_000_019]
CONFIG = json.loads((ROOT / "benchmark/configs/cnn_lstm_imdb.json").read_text())


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return cnn_lstm_copy(tmp_path_factory.mktemp("cnn_lstm"))


def test_the_cell_is_added_from_new_files_only(bench, tmp_path):
    """Every file of a copy without the tiny cell is in the copy with it,
    unchanged, but BENCHMARK.json; the entry is found by its name alone."""
    tiny_copy(tmp_path)
    before, after = _digests(tmp_path), _digests(bench.parent)
    assert all(after[path] == digest for path, digest in before.items())
    assert set(after) - set(before) == {Path("benchmark", kind, name) for kind, name in (
        ("configs", "cnn_lstm_tiny.json"), ("traffic", "cnn_lstm_tiny.json"),
        ("limits", f"{CELL}.json"))}
    c = core.Cell.find(CELL, bench)
    assert c.traffic["entry"] == "hmc_chains_blocked" and c.config["model"] == "cnn_lstm_imdb"


@pytest.mark.parametrize("bench_file", ["tiny", "real"])
def test_the_cells_keep_the_layout(bench, bench_file):
    bench_file = bench if bench_file == "tiny" else ROOT / "BENCHMARK.json"
    cell = CELL if bench_file == bench else REAL
    spec = json.loads(Path(bench_file).read_text())
    check_cell(cell, bench_file)
    name = core.Cell.find(cell, bench_file).config["name"]
    check_config(next(c for c in spec["configs"] if c["name"] == name), bench_file)
    check_chips(spec)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_port_is_correct(bench, seed):
    result = run_tiny(bench, CELL, None, seed=seed)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"theta_gap", "acc_gap", "energy_gap"}
    assert result["metrics"]["grad_evals_per_s"]["value"] > 0


def test_a_traced_run_reads_the_ports_potential_and_counters(bench):
    """On the CPU no device metric reads anything; the potential's spans do,
    and the recorder holds the window's review-steps and ids.  (A run is one
    process in the benchmark; here the recorder is emptied between runs.)"""
    profiling.reset()
    port = run_tiny(bench, CELL, None, trace=True)
    assert port["correct"], port["checks"]
    assert set(port["metrics"]) == {"potential_host_ms.imdb"}
    assert port["metrics"]["potential_host_ms.imdb"]["value"] > 0
    c = core.Cell.find(CELL, bench)
    ctx = core.Context(c.config, c.traffic, {}, port["attempted"], 1.0, [], {})
    lstm = core.load_module("metrics", "lstm_roofline_pct.imdb", c.bench)
    grads = port["attempted"] * c.traffic["chains"] * (c.traffic["draws"] * c.traffic["steps"] + 1)
    assert lstm.review_steps(ctx) == grads * c.config["n_data"] * counts.steps(c.config)
    assert profiling.counters()["cnn_lstm.tokens"] == grads * c.config["n_data"] * 29
    profiling.reset()
    stand_in = entry_of(bench, CELL).Cell.stand_in("float64")
    assert run_tiny(bench, CELL, stand_in, trace=True)["metrics"] == {}
    assert lstm.review_steps(ctx) is None


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


def test_reference_network_has_the_ports_parameters():
    with torch.device("meta"):
        port, plain = cnn_lstm_imdb(), CNNLSTMIMDB()
    assert [p.shape for p in port.parameters()] == [p.shape for p in plain.parameters()]
    assert counts.cnn_lstm_params(CONFIG) == CONFIG["parameters"] == 2_700_098
    assert sum(p.numel() for p in plain.parameters()) == 2_700_098


@pytest.mark.parametrize("fn, want", [
    (counts.steps, 24),
    (counts.conv_macs, 3_932_160),
    (counts.lstm_step_macs, 98_304),
    (counts.review_macs, 6_291_712),
    (lambda c: counts.gradient_flops(c, 1), 943_756_800_000),
    (lambda c: counts.conv_flops(c, 25_000), 6 * 25_000 * 3_932_160),
    (lambda c: counts.lstm_flops(c, 24 * 25_000), 6 * 25_000 * 2_359_296),
    (lambda c: counts.lstm_gate_bytes(c, 24 * 25_000), 20 * 4 * 128 * 24 * 25_000),
    (lambda c: counts.embed_bytes(c, 2_500_000, 1), 2_500_000 * 2 * (8 + 512) + 2 * 10_240_000),
])
def test_counts_at_the_cells_sizes(fn, want):
    assert fn(CONFIG) == want


def test_gradient_flops_match_the_flop_counter():
    """Forward and backward of the reference network on 2 reviews of random
    ids: the convolution, the LSTM's products and the head, each with its
    two backward products, but the first step's product with the zero
    state, whose input gradient autograd does not compute (the count takes
    every step whole)."""
    module = CNNLSTMIMDB()
    ids = torch.randint(0, CONFIG["vocab"], (2, CONFIG["seq_len"])).double()
    with FlopCounterMode(display=False) as fc:
        module(ids).sum().backward()
    zero_state = 2 * 2 * 4 * CONFIG["hidden"] ** 2
    assert fc.get_total_flops() == counts.gradient_flops({**CONFIG, "n_data": 2}, 1) - zero_state
