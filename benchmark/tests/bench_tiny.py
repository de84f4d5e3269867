"""A copy of the benchmark with tiny cells, for the CPU tests.

``tiny_copy(tmp)`` copies BENCHMARK.json and benchmark/ into ``tmp`` and
adds, as new files and new entries only, one tiny configuration per
model (the Gaussian keeps its 250 dimensions: at fewer the TF32 control
strays less than the limits set at the cell's size), one tiny traffic mix
per entry and a cell of each, with the limits
of the real cell it stands for.  Each cell runs on the CPU in well under
a second with the plain reference standing in for the port's entry.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny cell: (config, its changes, traffic, traffic's parameters, real cell)
TINY = {
    "bnn_tiny.hmc_tiny": ("bnn_tiny", dict(in_dim=12, hidden=8, n_data=20), "hmc_tiny",
                          dict(entry="bnn_hmc", chains=3, draws=3, steps=4, step_size=0.02),
                          "bnn_flagship.hmc_fused"),
    "gauss_tiny.gauss_tiny": ("gauss_tiny", {}, "gauss_tiny",
                              dict(entry="gaussian_hmc", chains=4, draws=200, steps=10,
                                   step_size=0.022), "gauss_wishart250.hmc_c4"),
}
BASE_CONFIG = {"bnn_tiny": "bnn_flagship", "gauss_tiny": "gauss_wishart250"}


def tiny_copy(tmp: Path) -> Path:
    """The copy's BENCHMARK.json, with the tiny cells added."""
    tmp = Path(tmp)
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    for cell, (config, sizes, traffic, mix, real) in TINY.items():
        base = json.loads((b / "configs" / f"{BASE_CONFIG[config]}.json").read_text())
        (b / "configs" / f"{config}.json").write_text(json.dumps({**base, **sizes,
                                                                  "name": config}))
        (b / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        shutil.copy(b / "limits" / f"{real}.json", b / "limits" / f"{cell}.json")
        spec["workloads"].append(dict(name=cell, config=config, traffic=traffic, chips=1,
                                      why="tiny"))
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if real in metric.get("workloads", []):
                metric["workloads"].append(cell)
    out = tmp / "BENCHMARK.json"
    out.write_text(json.dumps(spec))
    return out


def run_tiny(bench_file: Path, cell: str, program, trace: bool = False, seed: int = 2**31 + 7,
             seconds: float = 0.2):
    from benchmark import core

    return core.run(cell, seed, seconds, trace, device="cpu", program=program,
                    bench_file=bench_file, log=lambda line: None)


def entry_of(bench_file: Path, cell: str):
    from benchmark import core

    c = core.Cell.find(cell, bench_file)
    return core.load_module("entries", c.traffic["entry"], c.bench)
