"""The plain references: Philox against its published answers, the
normals' layout, the BNN gradient against autograd, and HMC on a
one-dimensional Gaussian worked out by hand."""

import math

import pytest
import torch
from bench_tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.reference import bnn, gaussian, philox


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = philox.philox(*(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in got) == want


def _box_muller(w0, w1):
    u0, u1 = ((w0 >> 8) + 0.5) / 2**24, ((w1 >> 8) + 0.5) / 2**24
    r = math.sqrt(-2 * math.log(u0))
    return r * math.cos(2 * math.pi * u1), r * math.sin(2 * math.pi * u1)


def test_normals_layout():
    key = philox.seed_key(2**40 + 17)
    assert key == (17, 256)
    chains = torch.tensor([0, 5])
    pairs = philox.pair_normals(key, 3, chains, 5, 2)
    quads = philox.quad_normals(key, torch.tensor([3]), chains, 7)[0]
    for i, c in enumerate((0, 5)):
        w = [int(t) for t in philox.philox(torch.tensor([2]), 3, torch.tensor([c]), 2, key)]
        assert pairs[i, 4].item() == pytest.approx(_box_muller(w[0], w[1])[0], rel=1e-12)
        w = [int(t) for t in philox.philox(torch.tensor([1]), 3, torch.tensor([c]), 0, key)]
        want = _box_muller(w[0], w[1]) + _box_muller(w[2], w[3])
        assert quads[i, 4:7].tolist() == pytest.approx(want[:3], rel=1e-12)
    u = philox.log_uniform(key, 3, chains)
    w = int(philox.philox(torch.tensor([0]), 3, torch.tensor([5]), 1, key)[0])
    assert u[1].item() == pytest.approx(math.log(((w >> 8) + 0.5) / 2**24), rel=1e-12)


def test_bnn_gradient_against_autograd():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(9, 5, generator=gen, dtype=torch.float64)
    y = torch.randn(9, 1, generator=gen, dtype=torch.float64)
    theta = [torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
             for s in ((2, 5, 4), (2, 4), (2, 4), (2,))]
    grads, logp = bnn.grads_and_logp(x, y, theta, 10.0, "float64")
    w1, b1, w2, b2 = theta
    o = torch.tanh(x @ w1 + b1[:, None]) @ w2[..., None] + b2[:, None, None]
    want = -5.0 * ((o[..., 0] - y[:, 0]) ** 2).sum(1) - 0.5 * sum(
        (t.reshape(2, -1) ** 2).sum(1) for t in theta)
    assert torch.allclose(logp, want)
    auto = torch.autograd.grad(want.sum(), theta)
    for g, a in zip(grads, auto):
        assert torch.allclose(g, a)


def test_gaussian_hmc_by_hand():
    """One chain, D=1, two draws of one leapfrog step, against the
    arithmetic done here in Python floats."""
    seed, eps, prec, mu, th = 99, 0.7, 2.0, 0.5, 1.25
    key = philox.seed_key(seed)
    draws = list(gaussian.hmc(seed, torch.tensor([[th]]), torch.tensor([[prec]]),
                              torch.tensor([mu]), 2, 1, eps))
    for n, got, m, accept, _ in draws:
        w = [int(t) for t in philox.philox(torch.tensor([0]), n, torch.tensor([0]), 0, key)]
        z = _box_muller(w[0], w[1])[0]
        g0 = -(th - mu) * prec
        p = z + 0.5 * eps * g0
        th1 = th + eps * p
        g1 = -(th1 - mu) * prec
        p1 = p + 0.5 * eps * g1
        h0 = 0.5 * z * z + 0.5 * prec * (th - mu) ** 2
        h1 = 0.5 * p1 * p1 + 0.5 * prec * (th1 - mu) ** 2
        w = int(philox.philox(torch.tensor([0]), n, torch.tensor([0]), 1, key)[0])
        margin = (h0 - h1) - math.log(((w >> 8) + 0.5) / 2**24)
        assert m.item() == pytest.approx(margin, rel=1e-9, abs=1e-12)
        th = th1 if margin >= 0 else th
        assert bool(accept) == (margin >= 0) and got.item() == pytest.approx(th, rel=1e-12)


def test_hmc_lanes_follow_both_outcomes_of_a_close_decision():
    gen = torch.Generator().manual_seed(5)
    x, y = torch.randn(7, 3, generator=gen), torch.randn(7, 1, generator=gen)
    theta = (0.1 * torch.randn(2, 3, 4, generator=gen), torch.zeros(2, 4),
             0.1 * torch.randn(2, 4, generator=gen), torch.zeros(2))
    chain, _, _ = bnn.hmc(1, x, y, theta, 3, 2, 0.05, 1.0)
    assert chain.tolist() == [0, 1]
    chain, lanes, wide = bnn.hmc(1, x, y, theta, 3, 2, 0.05, 1.0, margin=1e9, max_lanes=2)
    assert chain.tolist() == [0, 1, 0, 1]  # every decision is close: one split a chain
    for c in (0, 1):  # the copies took opposite first decisions, so they end apart
        assert not torch.equal(lanes[0][c], lanes[0][c + 2])

