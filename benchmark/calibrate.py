"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--control] [--seconds 2]

runs the cell, in one process, once per seed over a short window at the
cell's own load, and prints one JSON line per seed with every number that
each checked call gave.  With --control the plain reference computed with
TF32 products stands in the port's entry: the step below the float32 that
the configurations state, which has to come out not correct.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell.find(args.workload)
    entry = core.load_module("entries", cell.traffic["entry"], cell.bench)
    program = entry.Cell.stand_in("tf32") if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = []
        result = core.run(args.workload, seed, args.seconds, False, device="cuda:0",
                          program=program, log=lambda line: None, readings=readings)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"], "calls": result["attempted"],
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
