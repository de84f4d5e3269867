"""Profiling and throughput observability.

Counterpart of ``hamiltorch_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` capture of the enclosed block
  (the CPU, and the card when there is one) written to ``logdir`` as a
  trace that TensorBoard and Perfetto load; kernel times by name come from
  the yielded profiler's ``key_averages()``;
* ``annotate(name)``: a ``torch.profiler.record_function`` range that marks
  a phase in that trace;
* ``timed()``: wall seconds of the block, read after the card has finished
  the work the block queued;
* ``throughput(result, seconds, ...)``: draws per second, grad-steps per
  second, divergences and acceptance of an ``MCMCResult``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


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


def annotate(name: str):
    return torch.profiler.record_function(name)


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
