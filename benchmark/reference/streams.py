"""The per-chain noise of the port's general samplers, in plain PyTorch.

A frozen copy of the definition that ``run_hmc_chains`` draws its noise by:
the noise of chain ``c`` at draw ``n`` of a run keyed ``key`` comes from a
``torch.Generator`` on the state's device seeded by a SplitMix64 hash of
(key, c, n), which draws a standard normal over the chain's D parameters
and then one uniform, both in the state's dtype.  Chains are numbered from
0 (an unsharded run).  The numbers are the generator's own, so the copy
draws bit for bit what the port draws on the same device and PyTorch.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def draw_seed(key: int, chain: int, n: int) -> int:
    """The generator seed of chain ``chain`` at draw ``n`` (63 bits)."""
    h = _splitmix64(int(key) & _MASK64)
    h = _splitmix64(h ^ (int(chain) & _MASK64))
    h = _splitmix64(h ^ (int(n) & _MASK64))
    return h >> 1


def draw_noise(key: int, n: int, chains: int, dim: int, dtype, device) -> tuple:
    """``(z, log_u)`` of draw ``n``: (chains, dim) momenta before the mass
    shapes them, and (chains,) logs of the Metropolis uniforms, in ``dtype``."""
    gen = torch.Generator(device=device)
    z = torch.empty((chains, dim), dtype=dtype, device=device)
    u = torch.empty((chains,), dtype=dtype, device=device)
    for c in range(chains):
        gen.manual_seed(draw_seed(key, c, n))
        z[c].normal_(generator=gen)
        u[c:c + 1].uniform_(generator=gen)
    return z, torch.log(u)
