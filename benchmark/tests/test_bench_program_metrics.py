"""The per-layer metrics that read the port's own recorder
(``benchmark/metrics/program.py``): each on a recorder filled by hand gives
the value its definition gives, none reads an empty recorder or one that
does not hold a span a call, and a traced tiny run with the reference
standing in for the port stays correct and reports none of them."""

import json
import time

import pytest
import torch
from bench_tiny import ROOT, entry_of, run_tiny, tiny_copy

from benchmark.core import Context, load_module
from hamiltorch_tpu_torch.utils import profiling

PEAKS = json.loads((ROOT / "benchmark/peaks.json").read_text())
NAMES = ("wrapper_host_ms.bnn", "launches_per_grad.bnn", "idle_us_per_launch.bnn",
         "bwd_epilogue_pct.bnn", "grid_barrier_pct.gauss")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _ctx(calls, **kw):
    base = dict(cfg={}, traffic={}, counts={"gradients": 501}, calls=calls, window_s=10.0,
                host_call_s=[], peaks=PEAKS, busy_s=9.86)
    return Context(**{**base, **kw})


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def _fill(entry, calls, launches, launch_ns, span_ns):
    """``calls`` recorded calls of ``entry``, each a top-level span of about
    ``span_ns`` with its C entry's accounting."""
    with profiling.recording():
        for _ in range(calls):
            with profiling.annotate(entry):
                stats = profiling.launch_stats()
                stats[:] = [launches, launch_ns, 1_000, 0]
                profiling.record_launch_stats(entry, stats)
                t_end = time.perf_counter_ns() + span_ns
                while time.perf_counter_ns() < t_end:
                    pass
    return [s for s in profiling.spans() if s.name == entry]


def test_bnn_readers_on_a_recorder_filled_by_hand():
    spans = _fill("bnn_hmc", 3, 1539, 200_000, 1_000_000)
    with profiling.recording():
        phases = profiling.device_counters("bnn_backward", ("products_cycles", "epilogue_cycles"),
                                           "cpu")
        phases += torch.tensor([750, 250])
    ctx = _ctx(3)
    host_ms = (sum(s.end_ns - s.start_ns for s in spans) - 3 * 200_000) / 3 / 1e6
    assert _read("wrapper_host_ms.bnn", ctx) == pytest.approx(host_ms)
    assert 0.8 <= _read("wrapper_host_ms.bnn", ctx) <= 5
    assert _read("launches_per_grad.bnn", ctx) == pytest.approx(1539 / 501)
    assert _read("idle_us_per_launch.bnn", ctx) == pytest.approx(1e6 * 0.14 / (3 * 1539))
    assert _read("bwd_epilogue_pct.bnn", ctx) == pytest.approx(25.0)


def test_grid_barrier_share_on_a_recorder_filled_by_hand():
    _fill("gaussian_hmc", 2, 2, 5_000, 10_000)
    with profiling.recording():
        phases = profiling.device_counters(
            "dense_grid", ("product_cycles", "epilogue_cycles", "barrier_cycles",
                           "between_draws_cycles"), "cpu")
        phases += torch.tensor([500, 200, 250, 50])
    assert _read("grid_barrier_pct.gauss", _ctx(2)) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_from_an_empty_or_partial_record(name):
    assert _read(name, _ctx(3)) is None
    entry = "gaussian_hmc" if name.endswith(".gauss") else "bnn_hmc"
    _fill(entry, 3, 1539, 200_000, 1_000)
    with profiling.recording():
        for kernel, phases in (("bnn_backward", ("products_cycles", "epilogue_cycles")),
                               ("dense_grid", ("product_cycles", "epilogue_cycles",
                                               "barrier_cycles", "between_draws_cycles"))):
            profiling.device_counters(kernel, phases, "cpu").add_(1)
    assert _read(name, _ctx(3)) is not None
    assert _read(name, _ctx(4)) is None  # a call of the window left unrecorded
    assert _read(name, _ctx(2)) is None  # a span of no call of the window


def test_nested_spans_of_the_entry_are_not_calls():
    with profiling.recording():
        with profiling.annotate("outer"):
            _fill("bnn_hmc", 1, 9, 10, 10)
    assert _read("launches_per_grad.bnn", _ctx(1)) is None


@pytest.mark.parametrize("cell", ["bnn_tiny.hmc_tiny", "gauss_tiny.gauss_tiny"])
def test_a_traced_run_of_the_stand_in_reports_none_of_them(tmp_path, cell):
    bench = tiny_copy(tmp_path)
    stand_in = entry_of(bench, cell).Cell.stand_in("float64")
    result = run_tiny(bench, cell, stand_in, trace=True)
    assert result["correct"], result["checks"]
    assert not set(NAMES) & set(result["metrics"])
