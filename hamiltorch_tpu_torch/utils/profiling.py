"""Profiling and throughput observability.

Counterpart of ``hamiltorch_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` capture of the enclosed block
  (the CPU, and the card when there is one) written to ``logdir`` as a
  trace that TensorBoard and Perfetto load; kernel times by name come from
  the yielded profiler's ``key_averages()``;
* ``annotate(name)``: a span of the recorder below, which also marks the
  phase in that trace;
* ``timed()``: wall seconds of the block, read after the card has finished
  the work the block queued;
* ``throughput(result, seconds, ...)``: draws per second, grad-steps per
  second, divergences and acceptance of an ``MCMCResult``.

The recorder keeps the port's own spans and counters in memory.  It records
while an operator has turned it on (``with recording():``) and whenever a
``torch.profiler`` profile is recording; otherwise each ``annotate``,
``count``, ``device_counters`` and ``launch_stats`` is one flag check that
allocates nothing.  While a profile records, every span also opens a
profiler range of its name (``torch.profiler.record_function``'s, at
function scope), so the program's spans lie in the profile's trace beside
the device's kernels, on the host's side of it only.

* a span (``annotate``) has a name, a start and an end from
  ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux, the clock the C
  entries stamp with), its own id, its parent's id (None at the top) and a
  call id shared by every span of one top-level call; ``spans()`` lists the
  finished ones, at most ``SPAN_LIMIT`` of them, the oldest dropped first;
* a host counter (``count``) is a running sum under a name;
* device counters: ``device_counters(kernel, names, device)`` is a small
  int64 tensor on the card that a kernel adds its counters into (by
  ``atomicAdd``), one per counted kernel and device; it is read only by
  ``counters()``, which copies every device counter to the host with one
  synchronize a device and returns them beside the host counters, as
  ``{"<kernel>.<name>": value}``;
* ``launch_stats()`` / ``record_launch_stats(entry, stats)``: the host array
  a C entry fills with its launch accounting (``csrc/common.cuh``'s ``HostStat``)
  and its reading into the counters ``<entry>.kernel_launches``,
  ``<entry>.launch_ns``, ``<entry>.prologue_ns`` and the span
  ``<entry>.prologue`` (in memory only: a profile's ranges cannot be opened
  after the fact);
* ``reset()`` empties the recorder.

Nothing but ``counters()`` synchronizes, and nothing is written out: the
profile's trace (``trace``) holds the spans when a profile records.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

SPAN_LIMIT = 100_000
# the layout of a C entry's launch accounting (kernels/csrc/common.cuh's HostStat)
LAUNCH_STATS = ("kernel_launches", "launch_ns", "prologue_ns", "entry_ns")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int


_on = False
_profiling = torch.autograd._profiler_enabled
_spans: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_counts: dict = {}
_device: dict = {}  # (kernel, device) -> (names, int64 tensor)
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans


@contextlib.contextmanager
def recording():
    """Record in the enclosed block (an operator's switch; a profile that
    records turns the recorder on by itself)."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("name", "start", "id", "parent", "call", "mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.mark = None
        if _profiling():
            # a range of function scope: record_function's user scope would
            # also put the span on the device's timeline, over the kernels
            # it launched, as if it were device work
            self.mark = torch._C._profiler._RecordFunctionFast(self.name)
            self.mark.__enter__()
        stack = _stack()
        self.id = next(_ids)
        self.parent, self.call = (stack[-1].id, stack[-1].call) if stack else (None, self.id)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        _spans.append(Span(self.name, self.start, end, self.id, self.parent, self.call))
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` over the enclosed block while the recorder
    records (and a profiler range of it while a profile records); otherwise
    a shared no-op context."""
    return _Span(name) if _on or _profiling() else _OFF


def _add_span(name: str, start_ns: int, end_ns: int):
    """A finished span, timed elsewhere on the same clock, as a child of
    the innermost open span."""
    if not (_on or _profiling()):
        return
    stack = _stack()
    own = next(_ids)
    parent, call = (stack[-1].id, stack[-1].call) if stack else (None, own)
    _spans.append(Span(name, int(start_ns), int(end_ns), own, parent, call))


def count(name: str, n: int = 1):
    """Adds n to the host counter ``name`` while the recorder records."""
    if _on or _profiling():
        _counts[name] = _counts.get(name, 0) + n


def device_counters(kernel: str, names: tuple, device) -> Optional[torch.Tensor]:
    """While the recorder records, ``kernel``'s int64 counters on ``device``
    (one slot a name, zero at first use), for its launch to add into;
    otherwise None."""
    if not (_on or _profiling()):
        return None
    key = (kernel, torch.device(device))
    got = _device.get(key)
    if got is None:
        got = _device[key] = (tuple(names), torch.zeros(len(names), dtype=torch.int64,
                                                        device=device))
    return got[1]


def launch_stats():
    """While the recorder records, a zeroed host array for a C entry's
    launch accounting (``LAUNCH_STATS``); otherwise None."""
    if not (_on or _profiling()):
        return None
    return (ctypes.c_longlong * len(LAUNCH_STATS))()


def record_launch_stats(entry: str, stats):
    """Counters and the prologue span of a C entry's filled ``launch_stats()``."""
    if stats is None:
        return
    got = dict(zip(LAUNCH_STATS, stats))
    for name in LAUNCH_STATS[:3]:
        count(f"{entry}.{name}", got[name])
    _add_span(f"{entry}.prologue", got["entry_ns"], got["entry_ns"] + got["prologue_ns"])


def spans() -> list:
    """The finished spans, oldest first."""
    return list(_spans)


def counters() -> dict:
    """The host counters and the device counters, ``{name: int}``."""
    out = dict(_counts)
    by_device = collections.defaultdict(list)
    for (kernel, device), (names, values) in _device.items():
        by_device[device].append((kernel, names, values))
    for entries in by_device.values():
        read = iter(torch.cat([v for _, _, v in entries]).tolist())  # the one synchronize
        for kernel, names, _ in entries:
            for name in names:
                out[f"{kernel}.{name}"] = out.get(f"{kernel}.{name}", 0) + next(read)
    return out


def reset():
    """Forgets every span and counter."""
    _spans.clear()
    _counts.clear()
    _device.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block into ``logdir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


@contextlib.contextmanager
def timed():
    """Yield a dict whose 'seconds' is filled on exit.

    PyTorch returns from a CUDA call before the card has run it, so the
    exit synchronises the card before it reads the clock; without that the
    timer would measure how long the host took to queue the work."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0


def throughput(result, seconds: float, num_steps_per_sample: Optional[int] = None) -> dict:
    """Throughput counters from an MCMCResult (one chain or a chain axis)."""
    accepted = result.stats.accepted
    chains = 1 if accepted.ndim == 1 else int(accepted.shape[0])
    draws = int(accepted.shape[-1])
    out = {
        "chains": chains,
        "draws_per_chain": draws,
        "samples_per_sec": chains * draws / seconds,
        "divergences": int(torch.sum(result.stats.divergent)),
        "acc_rate": float(torch.mean(torch.as_tensor(result.stats.accepted, dtype=torch.float32))),
    }
    if num_steps_per_sample is not None:
        out["grad_steps_per_sec"] = out["samples_per_sec"] * num_steps_per_sample
    return out
