"""Readers of the port's own recorder (``hamiltorch_tpu_torch/utils/profiling.py``).

While the traced window's profile records, the recorder holds the port's
spans and counters of the window's calls, and nothing of the warm-up or of
the calls made after the window.  Each reader returns None where it holds
nothing to read: a port without the recorder, the CPU path, a stand-in for
the port, or a record that does not hold one top-level span of the entry a
call of the window (a share is never reported from a partial record).
"""

from __future__ import annotations


def _recorder():
    try:
        from hamiltorch_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "counters") else None


def calls(ctx, entry: str):
    """The window's top-level spans of ``entry``, one a call, or None."""
    rec = _recorder()
    if rec is None:
        return None
    spans = [s for s in rec.spans() if s.name == entry and s.parent is None]
    return spans if spans and len(spans) == ctx.calls else None


def counters(ctx, entry: str, names):
    """The recorder's counters ``names`` summed over the window's calls of
    ``entry``, or None where a call or a counter is missing."""
    if calls(ctx, entry) is None:
        return None
    got = _recorder().counters()
    return [got[n] for n in names] if all(n in got for n in names) else None


def share_pct(ctx, entry: str, kernel: str, part: str, phases):
    """100 x ``kernel``'s ``part`` counter over the sum of its ``phases``."""
    values = counters(ctx, entry, [f"{kernel}.{p}" for p in phases])
    if values is None or sum(values) <= 0:
        return None
    return 100.0 * values[list(phases).index(part)] / sum(values)
