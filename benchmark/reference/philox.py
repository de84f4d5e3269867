"""Counter-based random numbers as the port's kernels draw them, in plain PyTorch.

A frozen copy of the definition the kernels use (Philox4x32-10 keyed on the
64-bit seed, a uniform in (0, 1) from the top 24 bits of a word, two
standard normals from two words by Box-Muller), written over int64
tensors that hold unsigned 32-bit values.  The normals and the logs of the
uniforms are returned in float64; the kernels compute them in float32 with
the same inputs, so the two agree to float32 rounding.

Streams (the fourth counter word): 0 for momenta, 1 for the Metropolis
uniform, 2 for MCLMC's refresh normals.  The first counter word indexes
elements, the second the draw of the call, the third the chain.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def seed_key(seed: int) -> tuple:
    """The Philox key of a seed, as the kernels take it (its low 64 bits)."""
    s = int(seed) & (2**64 - 1)
    return s & MASK, s >> 32


def _mulhilo(a: torch.Tensor, m: int):
    """High and low words of a * m for a in [0, 2^32), without int64 overflow."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    lo_lo = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (lo_lo >> 16)
    lo = ((mid & 0xFFFF) << 16) | (lo_lo & 0xFFFF)
    hi = a_hi * m_hi + (mid >> 16)
    return hi & MASK, lo


def philox(c0, c1, c2, c3, key: tuple):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) (int64 tensors or ints
    that broadcast) under ``key``; four int64 tensors of words."""
    k0, k1 = key
    like = next(c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor))
    c0, c1, c2, c3 = (c if isinstance(c, torch.Tensor) else torch.full_like(like, c)
                      for c in (c0, c1, c2, c3))
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
    return c0, c1, c2, c3


def uniform01(word: torch.Tensor) -> torch.Tensor:
    """A uniform in (0, 1), never 0 or 1, from the top 24 bits (float64)."""
    return ((word >> 8).double() + 0.5) / 16777216.0


def box_muller(w0: torch.Tensor, w1: torch.Tensor):
    """Two standard normals from two words (float64)."""
    rad = torch.sqrt(-2.0 * torch.log(uniform01(w0)))
    angle = 2.0 * math.pi * uniform01(w1)
    return rad * torch.cos(angle), rad * torch.sin(angle)


def pair_normals(key, draw: int, chains: torch.Tensor, dims: int, stream: int) -> torch.Tensor:
    """(len(chains), dims) normals: elements 2q and 2q + 1 of a chain from the
    first two words of the draw at counter (q, draw, chain, stream)."""
    q = torch.arange((dims + 1) // 2, dtype=torch.int64, device=chains.device)
    w = philox(q[None, :], draw, chains[:, None].to(torch.int64), stream, key)
    z0, z1 = box_muller(w[0], w[1])
    return torch.stack((z0, z1), dim=-1).reshape(chains.numel(), -1)[:, :dims]


def quad_normals(key, draws, chains: torch.Tensor, dims: int) -> torch.Tensor:
    """(len(draws), len(chains), dims) normals: elements 4q .. 4q + 3 of a
    chain in a draw from all four words of the draw at counter (q, draw,
    chain, 0).  ``draws`` is a 1-D int64 tensor."""
    q = torch.arange((dims + 3) // 4, dtype=torch.int64, device=chains.device)
    w = philox(q[None, None, :], draws[:, None, None], chains[None, :, None].to(torch.int64), 0,
               key)
    lo0, lo1 = box_muller(w[0], w[1])
    hi0, hi1 = box_muller(w[2], w[3])
    z = torch.stack((lo0, lo1, hi0, hi1), dim=-1)
    return z.reshape(len(draws), chains.numel(), -1)[:, :, :dims]


def log_uniform(key, draws, chains: torch.Tensor) -> torch.Tensor:
    """log of each chain's Metropolis uniform in each draw (float64): (len(draws),
    len(chains)) for a 1-D tensor of draws, (len(chains),) for one draw."""
    one = not isinstance(draws, torch.Tensor)
    draws = torch.as_tensor([draws] if one else draws, dtype=torch.int64, device=chains.device)
    zero = torch.zeros((1, chains.numel()), dtype=torch.int64, device=chains.device)
    words = philox(zero, draws[:, None], chains[None, :].to(torch.int64), 1, key)[0]
    out = torch.log(uniform01(words))
    return out[0] if one else out
