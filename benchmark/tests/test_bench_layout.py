"""BENCHMARK.json against the contract's form, every file it names, and a
cell, a traffic mix and a metric added as new files being found.

The checks of a cell, a configuration and the chip counts are functions
of a BENCHMARK.json, so that a copy with cells added (``bench_chains``)
is held to them too, and each is shown to refuse what it must on a copy
made to break it."""

import hashlib
import json
import re
from pathlib import Path

import pytest
from bench_tiny import ROOT, entry_of, run_tiny, tiny_copy

from benchmark import core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = re.compile(r"^hamiltorch_tpu_torch(\.[A-Za-z_]\w*)+:[A-Za-z_]\w*$")


def check_cell(cell: str, bench_file: Path = ROOT / "BENCHMARK.json"):
    """The cell's files load, it reports set-up, a rate and a per-layer
    metric, and its entry names a callable of the checkout's port."""
    c = core.Cell.find(cell, bench_file)
    assert c.chips in (1, 4)
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    entry = core.load_module("entries", c.traffic["entry"], c.bench)
    assert PORT.match(entry.Cell.PORT), f"{entry.Cell.PORT!r} is not in hamiltorch_tpu_torch"
    assert callable(core.resolve(entry.Cell.PORT))  # raises where the port is not the checkout's
    assert set(c.limits["limits"]) and c.limits["margin"] >= 0
    core.load_module("inputs", c.config["model"])


def check_config(config: dict, bench_file: Path = ROOT / "BENCHMARK.json"):
    """The file matches its BENCHMARK.json entry; every key of ``reduced``
    is a key of the file, and a cut states each reduced key's published
    value and the deployment whose share it is."""
    data = json.loads((Path(bench_file).parent / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] and data["dtype"] == "float32"
    assert all(key in data for key in data["reduced"])
    if data["reduced"]:
        assert set(data["reduced"]) <= set(data.get("published", {})), "published values"
        assert str(data.get("deployment", "")).strip(), "the deployment it is a share of"


def check_chips(spec: dict):
    """1 or 4 chips a cell, and at most max(1, cells // 4) cells on four."""
    chips = [w["chips"] for w in spec["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


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
    check_chips(SPEC)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads(cell):
    check_cell(cell)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    check_config(config)


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


@pytest.fixture
def bench(tmp_path):
    return tiny_copy(tmp_path)


def _edit(bench_file: Path, edit) -> dict:
    spec = json.loads(bench_file.read_text())
    edit(spec)
    bench_file.write_text(json.dumps(spec))
    return spec


@pytest.mark.parametrize("port", [
    "hamiltorch_tpu.samplers.hmc:run_hmc_chains",  # the JAX package: never imported
    "hamiltorch_tpu_torch_other.samplers:run",
    "torch.nn.functional:linear",
    "hamiltorch_tpu_torch.samplers.hmc",
    "hamiltorch_tpu_torch.samplers.hmc:no_such_entry",
])
def test_an_entry_outside_the_port_is_refused(bench, port):
    b = bench.parent / "benchmark"
    entries = b / "entries"
    source = (entries / "gaussian_hmc.py").read_text()
    (entries / "outside.py").write_text(source.replace(
        'PORT = "hamiltorch_tpu_torch.kernels.gaussian_hmc:gaussian_hmc"', f"PORT = {port!r}"))
    mix = json.loads((b / "traffic" / "gauss_tiny.json").read_text())
    (b / "traffic" / "outside.json").write_text(json.dumps({**mix, "entry": "outside"}))
    (b / "limits" / "gauss_tiny.outside.json").write_text(
        (b / "limits" / "gauss_tiny.gauss_tiny.json").read_text())
    _edit(bench, lambda s: s["workloads"].append(dict(
        name="gauss_tiny.outside", config="gauss_tiny", traffic="outside", chips=1, why="x")))
    check_cell("gauss_tiny.gauss_tiny", bench)
    loaded = core.banned_modules()
    with pytest.raises((AssertionError, AttributeError)):
        check_cell("gauss_tiny.outside", bench)
    assert core.banned_modules() == loaded


@pytest.mark.parametrize("in_spec, in_file, ok", [
    ([], {}, True),
    (["n_data"], {"reduced": ["n_data"], "published": {"n_data": 60000},
                  "deployment": "8 chips, each with an eighth of the rows"}, True),
    (["n_data"], {}, False),  # the two files differ
    ([], {"reduced": ["n_data"]}, False),
    (["n_data"], {"reduced": ["n_data"]}, False),  # no published value or deployment
    (["n_data"], {"reduced": ["n_data"], "published": {"n_data": 60000}}, False),
    (["n_data"], {"reduced": ["n_data"], "deployment": "8 chips"}, False),
    (["rows"], {"reduced": ["rows"], "published": {"rows": 1}, "deployment": "8 chips"},
     False),  # a key the file does not have
])
def test_a_cut_is_held_to_its_statement(bench, in_spec, in_file, ok):
    """``bnn_flagship`` in the copy with ``reduced`` set to ``in_spec`` in
    BENCHMARK.json and the keys ``in_file`` written over its file's."""
    config = next(c for c in json.loads(bench.read_text())["configs"]
                  if c["name"] == "bnn_flagship")
    config["reduced"] = in_spec
    path = bench.parent / config["file"]
    path.write_text(json.dumps({**json.loads(path.read_text()), **in_file}))
    if ok:
        check_config(config, bench)
    else:
        with pytest.raises(AssertionError):
            check_config(config, bench)


@pytest.mark.parametrize("four, ok", [(0, True), (1, True), (2, False)])
def test_four_chip_cells_keep_to_the_quota(bench, four, ok):
    """The copy has 5 cells, so max(1, 5 // 4) = 1 may take four chips."""

    def edit(spec):
        assert len(spec["workloads"]) == 5
        for w in spec["workloads"][:four]:
            w["chips"] = 4

    spec = _edit(bench, edit)
    if ok:
        check_chips(spec)
    else:
        with pytest.raises(AssertionError):
            check_chips(spec)
    spec["workloads"][-1]["chips"] = 2
    with pytest.raises(AssertionError):
        check_chips(spec)
