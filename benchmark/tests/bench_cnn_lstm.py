"""A copy of the benchmark with a tiny IMDB CNN-LSTM cell on the blocked entry.

``cnn_lstm_copy(tmp)`` makes ``bench_tiny.tiny_copy(tmp)`` and adds, as new
files and new entries only, the files under ``cnn_lstm_tiny/``: the
configuration ``cnn_lstm_tiny`` (every layer of the CNN-LSTM at a
vocabulary of 300, 8-wide embeddings, 6 filters and 5 cells over 64
reviews of 29 tokens, in blocks of 24 rows for the port and of 40 for the
reference; its inputs are ``benchmark/inputs/cnn_lstm_imdb.py``), the
traffic mix ``cnn_lstm_tiny`` on the entry ``hmc_chains_blocked`` and the
cell ``CELL`` with its limits, reporting ``grad_evals_per_s``, ``setup_s``
and the per-layer metrics of ``cnn_lstm_imdb.hmc_c1_l10``.  BENCHMARK.json
itself gains no cell.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_tiny import tiny_copy

CELL = "cnn_lstm_tiny.cnn_lstm_tiny"
REAL = "cnn_lstm_imdb.hmc_c1_l10"
FILES = Path(__file__).resolve().parent / "cnn_lstm_tiny"


def cnn_lstm_copy(tmp: Path) -> Path:
    """The copy's BENCHMARK.json, with the tiny cells and ``CELL`` added."""
    bench_file = tiny_copy(tmp)
    bench = Path(tmp) / "benchmark"
    for path in FILES.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            shutil.copy(path, bench / path.relative_to(FILES))
    cfg = json.loads((FILES / "configs" / "cnn_lstm_tiny.json").read_text())
    spec = json.loads(bench_file.read_text())
    spec["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                file="benchmark/configs/cnn_lstm_tiny.json",
                                reduced=cfg["reduced"], why="tiny"))
    spec["workloads"].append(dict(name=CELL, config=cfg["name"], traffic="cnn_lstm_tiny",
                                  chips=1, why="tiny"))
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if REAL in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    bench_file.write_text(json.dumps(spec))
    return bench_file
