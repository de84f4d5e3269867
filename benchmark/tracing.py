"""Reduction of a ``torch.profiler`` trace of the measured window.

Reads the profiler's raw events (kept in memory; nothing is written) and
returns the device time by kernel name, the device's busy time (the union
of kernels, copies and sets on the device), and the idle gaps, each
labelled by the host span (``torch.profiler.record_function``, recorded by
the harness around each call and the closing synchronize) that was open
when the gap began.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
SPANS = ("window", "call", "sync")  # the harness's own spans inside the window


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]


def _kind(e) -> str:
    """"host" (a span of the harness), "device" (a kernel, copy or set on
    the device) or "" (anything else: operators, runtime calls, syncs)."""
    on_device = str(e.device_type()).endswith("CUDA")
    name = e.name()
    kind = getattr(e, "activity_type", None)
    kind = str(kind()).lower().rsplit(".", 1)[-1] if kind is not None else None
    if name in SPANS:
        return "" if on_device else "host"
    if not on_device:
        return ""
    if kind is not None:
        return "device" if kind in DEVICE_KINDS else ""
    return "" if "sync" in name.lower() else "device"


def _span_ns(e) -> tuple:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # short name -> device seconds
    gaps: list = field(default_factory=list)  # [(label, seconds)], longest first

    def top_ops(self, k: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.kernels.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> list:
        return [[n, s] for n, s in self.gaps[:k]]


def reduce(events) -> Trace:
    """A ``Trace`` of the events inside the host span named ``window``."""
    window, host, device, seen = None, [], [], {}
    for e in events:
        kind = _kind(e)
        if kind == "host":
            span = (*_span_ns(e), e.name())
            if e.name() == WINDOW:
                window = span
            else:
                host.append(span)
        elif kind == "device":
            device.append((*_span_ns(e), e.name()))
        elif len(seen) < 40:
            seen.setdefault((str(e.device_type()), e.name()[:40]), 0)
    if window is None:
        raise RuntimeError(f"the trace has no host span named 'window'; other events: {seen}")
    ws, we, _ = window
    out = Trace(window_s=(we - ws) / 1e9)
    intervals = []
    for start, end, name in device:
        start, end = max(start, ws), min(end, we)
        if end <= start:
            continue
        key = short_name(name)
        out.kernels[key] = out.kernels.get(key, 0.0) + (end - start) / 1e9
        intervals.append((start, end))
    intervals.sort()
    host.sort()
    starts = [s for s, _, _ in host]

    def label(t):  # the harness's spans inside the window do not nest
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < host[i][1]:
            return host[i][2]
        return "between spans"

    busy, cursor, gaps = 0, ws, []
    for start, end in intervals:
        if start > cursor:
            gaps.append((label(cursor), (start - cursor) / 1e9))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if we > cursor:
        gaps.append((label(cursor), (we - cursor) / 1e9))
    out.busy_s = busy / 1e9
    out.gaps = sorted(gaps, key=lambda g: -g[1])
    return out
