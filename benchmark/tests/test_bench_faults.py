"""A run with the timed path broken underneath comes out not correct.

The plain reference, computed in float64 and handed back in float32 as
the port's entries hand back their results, stands in for the port: with
it a run is correct.  Each fault a sampler cell can have then breaks it:
a call that returns its state unchanged, half of the chains left out (they
keep their state), and one answer altered where it is produced (one
parameter, or one element of one draw, left where it was), and the
acceptance a call returns beside its state never computed, left at 0.
The look for
a card is skipped: the runs are on the CPU at tiny sizes.
"""

import pytest
import torch
from bench_tiny import TINY, entry_of, run_tiny, tiny_copy


def _bnn_fault(sound, fault):
    def run(seed, x, y, *args, **kw):
        theta = args[:4]
        out = list(sound(seed, x, y, *args, **kw))
        if fault == "unchanged":
            out[:4] = [t.clone() for t in theta]
        elif fault == "half":
            half = theta[0].shape[0] // 2
            for new, old in zip(out[:4], theta):
                new[:half] = old[:half]
        elif fault == "altered":
            w1 = out[0].reshape(out[0].shape[0], -1)
            moved = (w1 - theta[0].reshape(w1.shape)).abs()
            c, k = divmod(int(moved.argmax()), w1.shape[1])
            w1[c, k] = theta[0].reshape(w1.shape)[c, k]
        elif fault == "zeroed":
            out[4] = torch.zeros_like(out[4])
        return tuple(out)

    return run


def _gauss_fault(sound, fault):
    def run(seed, theta0, *args, **kw):
        out, acc = sound(seed, theta0, *args, **kw)
        if fault == "unchanged":
            out[:] = theta0[:, None]
        elif fault == "half":
            out[: theta0.shape[0] // 2] = theta0[: theta0.shape[0] // 2, None]
        elif fault == "altered":
            prev = torch.cat((theta0[:, None], out[:, :-1]), dim=1)
            c, n, k = torch.nonzero(out != prev)[-1].tolist()
            out[c, n, k] = prev[c, n, k]
        elif fault == "zeroed":
            acc = torch.zeros_like(acc)
        return out, acc

    return run


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered", "zeroed"])
def test_fault_is_caught(bench, cell, fault):
    sound = entry_of(bench, cell).Cell.stand_in("float64")
    wrap = _gauss_fault if cell.startswith("gauss") else _bnn_fault
    result = run_tiny(bench, cell, sound if fault is None else wrap(sound, fault))
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"

