"""The algorithms' operation and byte counts at the cells' sizes, and the
readers built on them."""

import json

import pytest
from bench_tiny import ROOT

from benchmark.core import Context
from benchmark.metrics import counts, readers

FLAGSHIP = json.loads((ROOT / "benchmark/configs/bnn_flagship.json").read_text())
PEAKS = json.loads((ROOT / "benchmark/peaks.json").read_text())


def test_flagship_sizes():
    assert counts.bnn_params(FLAGSHIP) == FLAGSHIP["parameters"] == 100_609


@pytest.mark.parametrize("fn, args, want", [
    (counts.bnn_gradient_flops, (FLAGSHIP, 64), 26_306_674_688),
    (counts.bnn_gradient_bytes, (FLAGSHIP, 64), 4 * (1024 * 785 + 2 * 64 * 100_609)),
    (counts.gaussian_flops, (250, 1024, 100, 10), 129_024_000_000),
    (counts.gaussian_flops, (250, 4, 1000, 10), 5_040_000_000),
    (counts.gaussian_bytes, (250, 1024, 100), 103_674_000),
    (counts.gaussian_bytes, (250, 4, 1000), 4 * (250 * 250 + 4 * 250 + 4_000 * 250)),
])
def test_counts(fn, args, want):
    assert fn(*args) == want


def _ctx(**kw):
    base = dict(cfg={}, traffic={}, counts={}, calls=1, window_s=2.0, host_call_s=[],
                peaks=PEAKS)
    return Context(**{**base, **kw})


def test_roofline_takes_the_larger_bound_over_matching_kernels():
    ctx = _ctx(busy_s=1.0, kernels={"forward_kernel<3>": 0.2, "backward_kernel": 0.3,
                                    "other_kernel": 5.0})
    pats = (r"^forward_kernel\b", r"^backward_kernel\b")
    flops = 0.1 * 495e12  # 0.1 s at the peak
    assert readers.roofline_pct(ctx, pats, flops, 0) == pytest.approx(20.0)
    assert readers.roofline_pct(ctx, pats, flops, 3.35e12) == pytest.approx(200.0)
    assert readers.roofline_pct(ctx, (r"^none\b",), flops, 0) is None


def test_whole_step_idle_and_host_readers():
    ctx = _ctx(busy_s=1.5, host_call_s=[0.001, 0.003])
    assert readers.mfu_pct(ctx, 495e12) == pytest.approx(50.0)
    assert readers.idle_pct(ctx) == pytest.approx(25.0)
    assert readers.host_ms(ctx) == pytest.approx(2.0)
    assert readers.idle_pct(_ctx()) is None and readers.mfu_pct(_ctx(), 1.0) is None
