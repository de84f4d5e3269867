"""Throughput-reporting progress bar.

Counterpart of ``hamiltorch_tpu/utils/progress.py``, after the reference's
progress bar (reference: hamiltorch/util.py:25-89): time spent / remaining /
bar / count / draws per second, refresh-limited to 0.25 s, with an optional
rejection column.

The JAX driver is one compiled scan, so its ``scan_progress`` reaches the
host through ``jax.debug.callback`` after probing that the backend has host
callbacks.  The port's driver is an eager host loop: the hook is a plain
Python call per draw that reads the draw index and the host clock and no
device value, so it adds no device sync.  There is nothing to probe.
"""

from __future__ import annotations

import sys
import time

_REFRESH = 0.25


class ProgressBar:
    def __init__(self, message: str, num_iters: int, iter_name: str = "Samples",
                 rejections: bool = False):
        if num_iters < 1:
            raise ValueError("num_iters must be a positive integer")
        self.num_iters = num_iters
        self.iter_name = iter_name
        self.rejections = rejections
        self.t0 = time.time()
        self.prev = 0.0
        self.width = len(str(num_iters))
        print(message)
        cols = (f"Time spent  | Time remain.| Progress             | "
                f"{iter_name.ljust(self.width * 2 + 1)} | {iter_name}/sec")
        if rejections:
            cols += " | Rejected Samples"
        print(cols)
        sys.stdout.flush()

    @staticmethod
    def _dhms(total_seconds: float) -> str:
        d, r = divmod(total_seconds, 86400)
        h, r = divmod(r, 3600)
        m, s = divmod(r, 60)
        return f"{int(d)}d:{int(h):02}:{int(m):02}:{int(s):02}"

    def _bar(self, i: int) -> str:
        filled = int(round(20 * i / self.num_iters))
        return "#" * filled + "-" * (20 - filled)

    def update(self, i: int, rejections=None):
        dur = time.time() - self.t0
        if dur - self.prev <= _REFRESH and i < self.num_iters - 1:
            return
        self.prev = dur
        rate = (i + 1) / max(dur, 1e-9)
        line = (
            f"{self._dhms(dur)} | {self._dhms((self.num_iters - i) / rate)} | "
            f"{self._bar(i)} | {str(i).rjust(self.width)}/{self.num_iters} | {rate:,.2f}"
        )
        if rejections is not None:
            line += f" | {rejections:,.2f}"
        print(line + "   ", end="\r")
        sys.stdout.flush()

    def end(self, message: str | None = None):
        self.update(self.num_iters - 1)
        print()
        if message:
            print(message)


def scan_progress(num_samples: int, every: int = 50, message: str = "Sampling"):
    """A hook for the driver's loop: ``hook(n)`` with the run-local draw
    index ``n`` updates a bar every ``every`` draws; ``hook.end()`` prints
    the last line.

    As in the JAX package the bar is built lazily and anew whenever the
    index restarts (each chunk of a chunked run counts from 0)."""
    state = {"bar": None, "last": -1}

    def hook(n: int):
        if n % every:
            return
        if state["bar"] is None or n <= state["last"]:
            state["bar"] = ProgressBar(message, num_samples)
        state["last"] = n
        state["bar"].update(n)

    def end():
        if state["bar"] is not None:
            state["bar"].end()
            state["bar"] = None

    hook.end = end
    return hook
