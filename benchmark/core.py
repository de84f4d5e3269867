"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric is found by name:

    configs/<config>.json    the configuration's sizes; its ``model`` names
                             inputs/<model>.py, which makes the inputs on
                             the device from the seed
    traffic/<traffic>.json   the mix: its ``entry`` and the entry's parameters
    entries/<entry>.py       one call of a port entry, what it counts, and
                             the comparison with the plain reference
    limits/<cell>.json       the limit of each number compared, and the
                             readings each was set from
    metrics/<metric>.py      a per-layer metric's reader (``read(ctx)``),
                             the end-to-end metric it ``MOVES``, and its
                             kernel-name ``PATTERNS``

An end-to-end metric ``<counter>_per_s`` is the sum of the entry's counter
over the window's calls over the window's seconds; ``setup_s`` is the time
from the process's start to the window's.

The window is a closed loop: one client calls the cell's entry back to
back, each call continuing the chains from the state the call before
returned, whole calls only, until ``seconds`` have passed; it ends with a
synchronize.  The client waits for a call to finish before it queues the
one IN_FLIGHT after it, so that the window ends with the host's clock
and not a queue of calls later.  A traced run then makes HOST_PROBES more
calls with the profiler off, each after a synchronize, and times each on
the host: the wrapper's own host time, with neither the profiler's cost
nor a wait for a full launch queue in it.  Then the first call and one
later call drawn from the seed (a reservoir over the window's calls) are
compared with the reference.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import importlib.util
import json
import math
import random
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "hamiltorch_tpu")
_MASK64 = 2**64 - 1
IN_FLIGHT = 2  # calls the client may have queued on the device beyond the one running
HOST_PROBES = 8  # calls a traced run times on the host after its window


def call_seed(seed: int, k: int) -> int:
    """The seed of call ``k`` of a run (SplitMix64 of the run's seed and k)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (k + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def finite_or_max(v) -> float:
    """v, or the largest float where v is not finite (the result line is JSON)."""
    v = float(v)
    return v if math.isfinite(v) else sys.float_info.max


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench: Path = BENCH):
    """``<kind>/<name>.py`` (names may hold dots) as a module."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"benchmark_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(target: str):
    """``package.module:attribute`` imported from the checkout."""
    module_name, attr = target.split(":")
    module = importlib.import_module(module_name)
    top = sys.modules[module_name.split(".")[0]]
    where = Path(top.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"{module_name.split('.')[0]} was imported from {where}, "
                           f"outside the checkout {ROOT}")
    return getattr(module, attr)


class Entry:
    """Calls of one port entry (``entries/<entry>.py`` subclasses it as ``Cell``).

    The inputs come from ``inputs/<model>.py`` (the configuration's
    ``model``); the chains' state starts at the inputs' ``theta``.  Each call
    runs under its own seed from the state the call before returned; a
    subclass gives ``PORT``, ``_run``, ``_next`` (the state a call's output
    continues from), ``counts``, ``check`` and ``stand_in``.
    """

    PORT = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fn):
        self.cfg, self.traffic, self.seed, self.fn = cfg, traffic, seed, fn
        self.data = load_module("inputs", cfg["model"]).make(cfg, traffic["chains"], seed, device)
        self.state = self.data["theta"]

    def _run(self, rec: dict):
        raise NotImplementedError

    def _next(self, out):
        raise NotImplementedError

    def call(self, k: int) -> dict:
        """Call ``k`` of the run: its seed, the state it starts from and its
        output; the state moves on to the output."""
        rec = {"seed": call_seed(self.seed, k), "theta": self.state}
        rec["out"] = self._run(rec)
        self.state = self._next(rec["out"])
        return rec

    def warm(self):
        """One call at the cell's shapes, under a seed no counted call has,
        leaving the state where it was."""
        state = self.state
        self.call(-1)
        self.state = state

    def release(self):
        self.state = None


@dataclass
class Cell:
    """A cell of BENCHMARK.json with everything its name leads to."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    bench: Path

    @classmethod
    def find(cls, workload: str, bench_file: Path | None = None) -> "Cell":
        bench_file = bench_file or ROOT / "BENCHMARK.json"
        spec = json.loads(Path(bench_file).read_text())
        bench = Path(bench_file).resolve().parent / spec["paths"][0]
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {bench_file}; there are {sorted(cells)}")
        w = cells[workload]

        def here(m):
            return workload in m.get("workloads", [workload])

        e2e = [m for m in spec["end_to_end"] if here(m)]
        reported = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"] if here(m) and m["moves"] in reported]
        return cls(workload, load_json("configs", w["config"], bench),
                   load_json("traffic", w["traffic"], bench), w["chips"], e2e, layer,
                   load_json("limits", workload, bench), bench)


class Spans:
    """Host spans of the run (name, start, end on the host clock), and the
    same spans in the profiler's trace while one records."""

    def __init__(self):
        self.done = []
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = (torch.profiler.record_function(name) if self.tracing
                else contextlib.nullcontext())
        start = time.perf_counter()
        with mark:
            yield
        self.done.append((name, start, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.done if n == name)


@dataclass
class Context:
    """What a per-layer metric reads."""

    cfg: dict
    traffic: dict
    counts: dict  # per call
    calls: int
    window_s: float
    host_call_s: list
    peaks: dict
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        program=None, bench_file=None, started=None, log=None, readings=None) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``program`` replaces the port's entry (the tests and the control);
    ``started`` is the process's start on the host clock; ``readings``, a
    list, gets every number each checked call gave.
    """
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    started = time.perf_counter() if started is None else started
    spans = Spans()
    spans.done.append(("process start", started, time.perf_counter()))
    cell = Cell.find(workload, bench_file)
    entry = load_module("entries", cell.traffic["entry"], cell.bench)
    with spans("import"):
        fn = program or resolve(entry.Cell.PORT)
    with spans("inputs"):
        state = entry.Cell(cell.config, cell.traffic, seed, device, fn)
        _sync(device)
    with spans("warm-up"):  # builds or loads the kernel on a checkout's first run
        state.warm()
        _sync(device)

    cuda = torch.device(device).type == "cuda"
    launched0 = getattr(fn, "launches", None)
    setup_s = time.perf_counter() - started
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        spans.tracing = True
    rng = random.Random(seed)
    first, kept, calls = None, None, 0
    in_flight = collections.deque()
    with spans("window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with spans("call"):
                rec = state.call(calls)
            if cuda:  # the client runs at most IN_FLIGHT calls ahead of the device
                in_flight.append(torch.cuda.Event())
                in_flight[-1].record()
                if len(in_flight) > IN_FLIGHT:
                    in_flight.popleft().synchronize()
            if calls == 0:
                first = rec
            elif rng.random() * calls < 1.0:
                kept = rec
            rec = None
            calls += 1
            if time.perf_counter() >= deadline:
                break
        with spans("sync"):
            _sync(device)
        window_s = time.perf_counter() - t0
    traced = None
    if prof is not None:
        spans.tracing = False
        prof.__exit__(None, None, None)
        from benchmark import tracing

        with spans("trace reduction"):
            traced = tracing.reduce(prof.profiler.kineto_results.events())
        prof = None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launched = None if launched0 is None else fn.launches - launched0
    host = []
    if trace:  # the wrapper's host time, with the profiler off and the device idle
        for k in range(HOST_PROBES):
            _sync(device)
            t_call = time.perf_counter()
            state.call(calls + k)
            host.append(time.perf_counter() - t_call)
        _sync(device)
    counts = state.counts()
    state.release()

    # the comparison with the reference, after the window and the peak
    limits = cell.limits["limits"]
    worst, failed_calls, info = {}, 0, {}
    with spans("check"):
        for rec in (first, kept):
            if rec is None:
                continue
            numbers = state.check(rec, cell.limits)
            if readings is not None:
                readings.append(numbers)
            bad = False
            for name, value in numbers.items():
                if name in limits:
                    worst[name] = max(worst.get(name, -math.inf), value)
                    bad |= not value <= limits[name]
                else:
                    info.setdefault(name, []).append(value)
            failed_calls += bad
        first = kept = None
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in limits}
    if launched is not None:
        checks["calls_not_launched"] = {"value": calls - launched, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for name, values in info.items():
        log(f"info {name}: {values}")
    log("spans (s): " + ", ".join(f"{n} {spans.seconds(n):.3f}" for n in
                                  ("process start", "import", "inputs", "warm-up", "check",
                                   "trace reduction")))

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"].endswith("_per_s"):
                value = calls * counts[m["name"][:-len("_per_s")]] / window_s
            else:
                raise ValueError(f"no rule for the end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = Context(cell.config, cell.traffic, counts, calls, traced.window_s, host,
                      json.loads((cell.bench / "peaks.json").read_text()), traced.busy_s,
                      traced.kernels)
        matched = set()
        for m in cell.per_layer:
            module = load_module("metrics", m["name"], cell.bench)
            value = module.read(ctx)
            for pat in getattr(module, "PATTERNS", ()):
                matched |= {k for k in ctx.kernels if re.search(pat, k)}
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        other = {k: s for k, s in ctx.kernels.items() if k not in matched}
        log(f"device time of kernels no metric of this cell names (s): {other}")

    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": calls,
              "failed": failed_calls + (0 if launched is None else max(0, calls - launched)),
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.top_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return result
