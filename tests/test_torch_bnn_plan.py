"""The work plan of the BNN gradient's persistent GEMMs, on the CPU.

``kernels/bnn_grad.py::_plan`` decides how many blocks each GEMM of
``csrc/bnn_grad.cuh`` runs (at most one an SM), and ``_walk`` is the list
of tiles a block takes, the same list the kernel walks (block b takes tiles
b, b + grid, ...): in the forward both consumer warpgroups work on each of
its tiles, in the backward they take alternate ones.  Every tile of both
GEMMs must be taken exactly once, each walk must run in chain order, and no
walk may be longer than the fewest tiles a block can have at one block an
SM.  The tile sizes must be the kernel's.
"""

import re
from pathlib import Path

import pytest

from hamiltorch_tpu_torch.kernels import bnn_grad
from hamiltorch_tpu_torch.kernels.bnn_grad import CONSUMERS, _plan, _walk

HEADER = Path(bnn_grad.__file__).parent / "csrc" / "bnn_grad.cuh"

# (N, I, H, C): the flagship; one chain; more tiles than SMs with a tail at
# small N; ragged N and I; wider hidden layers
SHAPES = [(1024, 784, 128, 64), (1024, 784, 128, 1), (100, 784, 128, 133), (100, 784, 128, 200),
          (1000, 784, 128, 4), (1023, 50, 128, 3), (1024, 50, 128, 8), (200, 785, 128, 5),
          (200, 784, 256, 2), (1000, 785, 384, 5)]
SM_COUNTS = [132, 114, 8, 1]


def gemms(shape, sm_count):
    """(name, tiles, grid, tiles a chain, the walkers of a block) of both GEMMs."""
    n, i_dim, h, c = shape
    plan = _plan(n, i_dim, h, c, sm_count)
    return [("forward", plan.fwd_tiles, plan.fwd_grid, plan.fwd_tiles // c, [None]),
            ("backward", plan.bwd_tiles, plan.bwd_grid, plan.bwd_tiles // c, range(CONSUMERS))]


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_tile_is_walked_once_in_chain_order(shape, sm_count):
    for name, tiles, grid, per_chain, walkers in gemms(shape, sm_count):
        assert 1 <= grid <= min(sm_count, tiles), name
        walks = [_walk(tiles, grid, block, w) for block in range(grid) for w in walkers]
        assert sorted(t for walk in walks for t in walk) == list(range(tiles)), name
        for walk in walks:
            assert walk == sorted(walk), name
            chains = [t // per_chain for t in walk]
            assert chains == sorted(chains), name
        longest = max(len(range(block, tiles, grid)) for block in range(grid))
        assert longest == -(-tiles // sm_count), name


@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_are_counted_as_the_kernel_counts_them(shape):
    n, i_dim, h, c = shape
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (bnn_grad.FWD_ROWS, bnn_grad.BWD_HIDDEN, bnn_grad.BWD_INPUTS, CONSUMERS) == (
        const("FNC"), const("BWD_MB") * const("BM"), const("BNB"), const("CONSUMERS"))
    plan = _plan(n, i_dim, h, c, 132)
    assert plan.fwd_tiles == c * -(-n // const("FNC"))
    assert plan.bwd_tiles == c * (h // (const("BWD_MB") * const("BM"))) * -(-i_dim // const("BNB"))


def test_flagship_walks_are_even():
    """64 chains at N=1024, I=784, H=128: 512 forward and 896 backward
    tiles, 4 and 7 a block on 128 blocks of a 132-SM card."""
    plan = _plan(1024, 784, 128, 64, 132)
    assert (plan.fwd_tiles, plan.bwd_tiles, plan.fwd_grid, plan.bwd_grid) == (512, 896, 128, 128)
    assert {len(_walk(512, 128, b)) for b in range(128)} == {4}
    assert {len(_walk(896, 128, b)) for b in range(128)} == {7}
