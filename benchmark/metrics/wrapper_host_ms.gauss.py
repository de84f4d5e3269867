"""Host time of one call into kernels/gaussian_hmc.py (_plan, scratch, the
ctypes call, one cooperative launch), in ms: calls made after the traced
window with the profiler off, each after a synchronize."""

from benchmark.metrics.readers import host_ms as read  # noqa: F401

MOVES = "chain_draws_per_s"
