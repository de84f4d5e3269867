"""The control comes out not correct: the plain reference computed with
TF32 products (the step below the float32 the configurations state), put
in the port's place, at tiny sizes on the CPU under the limits of the
real cells ``bench_tiny.TINY`` names.  On the card, at the cells' own
sizes, ``benchmark/calibrate.py --control`` reads it (PERF.md gives the
readings; at 1,024 chains the control flips decisions, which a tiny cell
has too few of to show)."""

import pytest
from bench_tiny import TINY, entry_of, run_tiny, tiny_copy


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_019])
def test_control_is_not_correct(bench, cell, seed):
    control = entry_of(bench, cell).Cell.stand_in("tf32")
    result = run_tiny(bench, cell, control, seed=seed)
    assert result["correct"] is False, result["checks"]

