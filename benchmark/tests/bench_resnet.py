"""A copy of the benchmark with a tiny ResNet-20-FRN cell on the blocked entry.

``resnet_copy(tmp)`` makes ``bench_tiny.tiny_copy(tmp)`` and adds, as new
files and new entries only, the files under ``resnet_tiny/``: the
configuration ``resnet_tiny`` (every layer of ResNet-20-FRN with swish at
widths 4, 8, 8 over 64 images of 3x8x8, in blocks of 24 rows for the port
and of 40 for the reference; its inputs are
``benchmark/inputs/resnet20_frn.py``), the traffic mix ``resnet_tiny`` on
the entry ``hmc_chains_blocked`` and the cell ``CELL`` with its limits,
reporting ``grad_evals_per_s``, ``setup_s`` and the per-layer metrics of
``resnet20_frn.hmc_c1``.  BENCHMARK.json itself gains no cell.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_tiny import tiny_copy

CELL = "resnet_tiny.resnet_tiny"
REAL = "resnet20_frn.hmc_c1"
FILES = Path(__file__).resolve().parent / "resnet_tiny"


def resnet_copy(tmp: Path) -> Path:
    """The copy's BENCHMARK.json, with the tiny cells and ``CELL`` added."""
    bench_file = tiny_copy(tmp)
    bench = Path(tmp) / "benchmark"
    for path in FILES.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            shutil.copy(path, bench / path.relative_to(FILES))
    cfg = json.loads((FILES / "configs" / "resnet_tiny.json").read_text())
    spec = json.loads(bench_file.read_text())
    spec["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                file="benchmark/configs/resnet_tiny.json",
                                reduced=cfg["reduced"], why="tiny"))
    spec["workloads"].append(dict(name=CELL, config=cfg["name"], traffic="resnet_tiny", chips=1,
                                  why="tiny"))
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if REAL in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    bench_file.write_text(json.dumps(spec))
    return bench_file
