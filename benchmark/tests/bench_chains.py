"""A copy of the benchmark with a tiny cell on the port's general HMC.

``chains_copy(tmp)`` makes ``bench_tiny.tiny_copy(tmp)`` and adds, as new
files and new entries only, the files under ``chains_tiny/``: the
configuration ``module_tiny`` (a conv -> FRN -> swish -> pool -> linear
classifier, whose inputs are ``benchmark/inputs/conv_frn_classifier.py``:
``core.Entry`` loads inputs from the checkout's benchmark, not the copy's),
the traffic mix
``chains_tiny`` on the entry ``hmc_chains`` and the cell ``CELL`` with its
limits, reporting ``grad_evals_per_s``, ``setup_s`` and
``device_idle_pct.bnn``.  BENCHMARK.json itself gains no cell.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_tiny import tiny_copy

CELL = "module_tiny.chains_tiny"
FILES = Path(__file__).resolve().parent / "chains_tiny"
METRICS = ("grad_evals_per_s", "device_idle_pct.bnn")  # setup_s is every cell's


def chains_copy(tmp: Path) -> Path:
    """The copy's BENCHMARK.json, with the tiny cells and ``CELL`` added."""
    bench_file = tiny_copy(tmp)
    bench = Path(tmp) / "benchmark"
    for path in FILES.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            shutil.copy(path, bench / path.relative_to(FILES))
    cfg = json.loads((FILES / "configs" / "module_tiny.json").read_text())
    spec = json.loads(bench_file.read_text())
    spec["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                file="benchmark/configs/module_tiny.json",
                                reduced=cfg["reduced"], why="tiny"))
    spec["workloads"].append(dict(name=CELL, config=cfg["name"], traffic="chains_tiny", chips=1,
                                  why="tiny"))
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if metric["name"] in METRICS:
            metric["workloads"].append(CELL)
    bench_file.write_text(json.dumps(spec))
    return bench_file
