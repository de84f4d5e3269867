"""BENCHMARK.json against the contract's form, every file it names, and a
cell, a traffic mix and a metric added as new files being found."""

import hashlib
import json
import re

import pytest
from bench_tiny import ROOT, entry_of, run_tiny, tiny_copy

from benchmark import core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "grad_evals_per_s", "chain_draws_per_s", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads(cell):
    c = core.Cell.find(cell)
    assert c.chips == 1 and {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    entry = core.load_module("entries", c.traffic["entry"])
    assert entry.Cell.PORT.startswith("hamiltorch_tpu_torch.kernels.")
    assert set(c.limits["limits"]) and c.limits["margin"] >= 0
    core.load_module("inputs", c.config["model"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == [] and data["dtype"] == "float32"


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_files(metric):
    module = core.load_module("metrics", metric["name"])
    assert module.MOVES == metric["moves"] and callable(module.read)
    for cell in metric["workloads"]:
        reported = {m["name"] for m in core.Cell.find(cell).end_to_end}
        assert metric["moves"] in reported


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_traffic_and_metric_are_found_from_new_files(tmp_path):
    bench_file = tiny_copy(tmp_path)
    before = _digests(tmp_path)
    b = tmp_path / "benchmark"
    (b / "traffic" / "hmc_other.json").write_text(json.dumps(
        dict(entry="gaussian_hmc", chains=3, draws=4, steps=3, step_size=0.022)))
    (b / "limits" / "gauss_tiny.hmc_other.json").write_text(
        (b / "limits" / "gauss_tiny.gauss_tiny.json").read_text())
    (b / "metrics" / "calls_per_window.gauss.py").write_text(
        'MOVES = "chain_draws_per_s"\n\n\ndef read(ctx):\n    return float(ctx.calls)\n')
    spec = json.loads(bench_file.read_text())
    spec["workloads"].append(dict(name="gauss_tiny.hmc_other", config="gauss_tiny",
                                  traffic="hmc_other", chips=1, why="added"))
    spec["per_layer"].append(dict(name="calls_per_window.gauss", unit="calls", better="higher",
                                  source="program_counter", layer="whole step",
                                  moves="chain_draws_per_s",
                                  workloads=["gauss_tiny.hmc_other"]))
    for m in spec["end_to_end"]:
        if m["name"] == "chain_draws_per_s":
            m["workloads"].append("gauss_tiny.hmc_other")
    bench_file.write_text(json.dumps(spec))
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items()), "no file that was there changed"
    stand_in = entry_of(bench_file, "gauss_tiny.hmc_other").Cell.stand_in("float64")
    plain = run_tiny(bench_file, "gauss_tiny.hmc_other", stand_in)
    assert plain["correct"] and plain["metrics"]["chain_draws_per_s"]["value"] > 0
    traced = run_tiny(bench_file, "gauss_tiny.hmc_other", stand_in, trace=True)
    assert traced["metrics"]["calls_per_window.gauss"]["value"] == traced["attempted"]
    assert list(traced)[-1] == "checks"
