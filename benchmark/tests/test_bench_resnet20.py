"""The cell ``resnet20_frn.hmc_c1``: its entry ``hmc_chains_blocked``, its
reference network and its counts, on a tiny ResNet-20-FRN cell on the CPU.

``bench_resnet.resnet_copy`` adds the cell ``resnet_tiny.resnet_tiny``
(every layer of ResNet-20-FRN at widths 4, 8, 8 over 64 images of 3x8x8,
2 chains; the port's likelihood in blocks of 24 rows, the reference's in
blocks of 40) to a copy of the benchmark from new files only.  On the
CPU: the entry is found from new files; the real port on blocks comes out
correct and reports its potential's host time when traced; the float64
stand-in comes out correct and each planted fault and the TF32 control
come out not correct; the counts hold at the cell's sizes, the FLOPs
against ``torch.utils.flop_counter`` on the reference network.
"""

import functools
import json
from pathlib import Path

import pytest
import torch
from bench_resnet import CELL, REAL, resnet_copy
from bench_tiny import ROOT, entry_of, run_tiny, tiny_copy
from test_bench_layout import _digests, check_cell, check_chips, check_config
from torch.utils.flop_counter import FlopCounterMode

from benchmark import core
from benchmark.metrics import counts_resnet20 as counts
from benchmark.reference.resnet20_frn import ResNet20FRN
from hamiltorch_tpu_torch.models import resnet20_frn_swish
from hamiltorch_tpu_torch.utils import profiling

SEEDS = [11, 2**31 + 5, 3_000_000_019]
CONFIG = json.loads((ROOT / "benchmark/configs/resnet20_frn.json").read_text())


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return resnet_copy(tmp_path_factory.mktemp("resnet"))


def test_the_cell_is_added_from_new_files_only(bench, tmp_path):
    """Every file of a copy without the tiny cell is in the copy with it,
    unchanged, but BENCHMARK.json; the entry is found by its name alone."""
    tiny_copy(tmp_path)
    before, after = _digests(tmp_path), _digests(bench.parent)
    assert all(after[path] == digest for path, digest in before.items())
    assert set(after) - set(before) == {Path("benchmark", kind, name) for kind, name in (
        ("configs", "resnet_tiny.json"), ("traffic", "resnet_tiny.json"),
        ("limits", f"{CELL}.json"))}
    c = core.Cell.find(CELL, bench)
    assert c.traffic["entry"] == "hmc_chains_blocked"
    entry = core.load_module("entries", c.traffic["entry"], c.bench)
    assert entry.Cell.PORT == "hamiltorch_tpu_torch.samplers.hmc:run_hmc_chains"


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


def test_a_traced_run_reads_the_ports_potential(bench):
    """On the CPU no device metric reads anything; the potential's spans do.
    (A run is one process in the benchmark; here the recorder is emptied
    between two runs in one.)"""
    profiling.reset()
    port = run_tiny(bench, CELL, None, trace=True)
    assert port["correct"], port["checks"]
    assert set(port["metrics"]) == {"potential_host_ms.resnet20"}
    assert port["metrics"]["potential_host_ms.resnet20"]["value"] > 0
    profiling.reset()
    stand_in = entry_of(bench, CELL).Cell.stand_in("float64")
    assert run_tiny(bench, CELL, stand_in, trace=True)["metrics"] == {}


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
    port, plain = resnet20_frn_swish(), ResNet20FRN()
    assert [p.shape for p in port.parameters()] == [p.shape for p in plain.parameters()]
    assert counts.resnet20_params(CONFIG) == CONFIG["parameters"] == 273_754
    assert sum(p.numel() for p in plain.parameters()) == 273_754


@pytest.mark.parametrize("fn, want", [
    (lambda c: counts.resnet20_macs(c), 40_813_184),
    (lambda c: counts.resnet20_gradient_flops(c, 1), 50_000 * (6 * 40_813_184 - 2 * 442_368)),
    (lambda c: counts.resnet20_norm_act_bytes(c, 1),
     50_000 * 4 * (5 * 188_416 + 5 * 188_416 + 6 * 86_016)),
])
def test_counts_at_the_cells_sizes(fn, want):
    assert fn(CONFIG) == want


def test_gradient_flops_match_the_flop_counter():
    """Forward and backward of the reference network on 2 images, the images
    needing no gradient: convolutions, their two backward products and the
    head's three."""
    module = ResNet20FRN()
    with FlopCounterMode(display=False) as fc:
        module(torch.randn(2, 3, 32, 32)).sum().backward()
    assert fc.get_total_flops() == counts.resnet20_gradient_flops({**CONFIG, "n_data": 2}, 1)
