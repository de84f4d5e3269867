"""The port's in-memory recorder, ``hamiltorch_tpu_torch/utils/profiling.py``:
spans and their nesting, host and device counters, a C entry's launch
accounting, recording under ``torch.profiler`` on the profile's clock, the
bounded span buffer, and the cost of a span while nothing records.  The
fused kernels' own spans and counters on the card are in
``tests/test_torch_gpu.py``."""

import statistics
import time

import pytest
import torch

from hamiltorch_tpu_torch.kernels import bnn_hmc, bnn_mclmc, gaussian_hmc
from hamiltorch_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def by_name(spans):
    return {s.name: s for s in spans}


def test_spans_nest_with_parent_and_call_ids():
    with profiling.recording():
        with profiling.annotate("outer"):
            with profiling.annotate("outer.a"):
                with profiling.annotate("outer.a.b"):
                    pass
            with profiling.annotate("outer.c"):
                pass
        with profiling.annotate("second"):
            pass
    spans = profiling.spans()
    assert [s.name for s in spans] == ["outer.a.b", "outer.a", "outer.c", "outer", "second"]
    s = by_name(spans)
    assert s["outer"].parent is None and s["second"].parent is None
    assert s["outer.a"].parent == s["outer.c"].parent == s["outer"].id
    assert s["outer.a.b"].parent == s["outer.a"].id
    assert {x.call for x in spans if x.name.startswith("outer")} == {s["outer"].id}
    assert s["second"].call == s["second"].id != s["outer"].id
    for x in spans:
        assert x.start_ns <= x.end_ns
    assert s["outer"].start_ns <= s["outer.a"].start_ns <= s["outer.a.b"].end_ns
    assert s["outer.a"].end_ns <= s["outer.c"].start_ns <= s["outer.c"].end_ns <= s["outer"].end_ns


def test_a_span_closes_on_an_exception():
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.annotate("raises"):
                raise ValueError("inside")
        with profiling.annotate("after"):
            pass
    s = by_name(profiling.spans())
    assert s["after"].parent is None and s["raises"].parent is None


def test_recording_restores_the_switch():
    with profiling.recording():
        with profiling.recording():
            with profiling.annotate("inner"):
                pass
        with profiling.annotate("outer"):
            pass
    with profiling.annotate("off"):
        pass
    assert [s.name for s in profiling.spans()] == ["inner", "outer"]


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened while nothing records")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    with profiling.annotate("off"):
        profiling.count("off.count", 5)
        profiling.record_launch_stats("off", (3, 2, 1, 0))
    assert profiling.launch_stats() is None
    assert profiling.device_counters("k", ("a",), "cpu") is None
    assert profiling.spans() == [] and profiling.counters() == {}
    with profiling.recording():  # on, but no profile: still no range
        with profiling.annotate("on"):
            pass
    assert [s.name for s in profiling.spans()] == ["on"]


def test_records_under_a_profile_with_the_same_nesting():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("top"):
            with profiling.annotate("top.child"):
                torch.ones(8) + 1
    with profiling.annotate("after"):
        pass
    assert [s.name for s in profiling.spans()] == ["top.child", "top"]
    s = by_name(profiling.spans())
    assert s["top.child"].parent == s["top"].id
    events = {e.name: e for e in prof.events() if e.name in ("top", "top.child")}
    assert set(events) == {"top", "top.child"}
    assert events["top.child"].cpu_parent is not None
    assert events["top.child"].cpu_parent.name == "top"


def test_spans_share_the_profile_clock():
    """Each span's start minus its trace event's start is one offset for
    every span (the two clocks differ by a constant), within 50 us."""
    names = [f"span{i}" for i in range(12)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in names:
            with profiling.annotate(name):
                time.sleep(0.002)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    assert set(starts) == set(names)
    offsets = [s.start_ns - starts[s.name] for s in profiling.spans()]
    assert len(offsets) == len(names)
    assert max(offsets) - min(offsets) <= 50_000


def test_host_and_device_counters_and_reset():
    with profiling.recording():
        profiling.count("calls")
        profiling.count("calls", 4)
        dev = profiling.device_counters("kern", ("a_cycles", "b_cycles"), "cpu")
        assert dev.dtype == torch.int64 and dev.tolist() == [0, 0]
        dev += torch.tensor([3, 7])
        again = profiling.device_counters("kern", ("a_cycles", "b_cycles"), "cpu")
        assert again is dev
        again[1] += 1
    assert profiling.counters() == {"calls": 5, "kern.a_cycles": 3, "kern.b_cycles": 8}
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == []


def test_launch_stats_become_counters_and_a_prologue_span():
    with profiling.recording():
        with profiling.annotate("entry"):
            stats = profiling.launch_stats()
            assert len(stats) == len(profiling.LAUNCH_STATS) and list(stats) == [0, 0, 0, 0]
            now = time.perf_counter_ns()
            stats[:] = [17, 2500, 900, now]  # what a C entry writes
            profiling.record_launch_stats("entry", stats)
    assert profiling.counters() == {"entry.kernel_launches": 17, "entry.launch_ns": 2500,
                                    "entry.prologue_ns": 900}
    s = by_name(profiling.spans())
    assert s["entry.prologue"].parent == s["entry"].id
    assert (s["entry.prologue"].start_ns, s["entry.prologue"].end_ns) == (now, now + 900)


def test_the_span_buffer_drops_its_oldest_spans():
    extra = 5
    with profiling.recording():
        for i in range(profiling.SPAN_LIMIT + extra):
            with profiling.annotate("s"):
                pass
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_LIMIT
    assert spans[-1].id - spans[0].id == profiling.SPAN_LIMIT - 1


def test_a_span_costs_at_most_2_us_while_off():
    times = []
    for _ in range(10_000):
        t0 = time.perf_counter_ns()
        with profiling.annotate("off"):
            pass
        times.append(time.perf_counter_ns() - t0)
    assert statistics.median(times) <= 2_000
    assert profiling.spans() == []


def cpu_calls():
    x, y = torch.randn(6, 3), torch.randn(6, 1)
    w1, b1, w2, b2 = torch.randn(2, 3, 4), torch.randn(2, 4), torch.randn(2, 4), torch.randn(2)
    u = torch.randn(2, 3 * 4 + 2 * 4 + 1)
    return {
        "bnn_hmc": lambda: bnn_hmc(1, x, y, w1, b1, w2, b2, 2, 2, 1e-3),
        "bnn_mclmc": lambda: bnn_mclmc(1, x, y, w1, b1, w2, b2, u, 2, 1e-3, 1.0),
        "gaussian_hmc": lambda: gaussian_hmc(1, torch.zeros(3, 2), torch.ones(2), 2, 2, 0.1),
    }


@pytest.mark.parametrize("entry", ["bnn_hmc", "bnn_mclmc", "gaussian_hmc"])
def test_wrappers_span_their_calls_on_the_cpu_path(entry):
    """A recorded call is one top-level span with its prepare child; the
    plain version launches nothing, so no enqueue span and no counter."""
    call = cpu_calls()[entry]
    off = call()
    assert profiling.spans() == []
    with profiling.recording():
        on = call()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    spans = profiling.spans()
    assert [s.name for s in spans] == [f"{entry}.prepare", entry]
    assert spans[0].parent == spans[1].id and spans[1].parent is None
    assert profiling.counters() == {}
