"""Port vs JAX package: dual-averaging step-size adaptation.

The same log acceptance ratios (numpy, with divergences as NaN) go through
both ``da_update``s, the pattern of ``TestAdaptationParity``.  Both run
float32; the log-space recursion agrees to a relative 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hamiltorch_tpu.samplers.adaptation import da_init as j_da_init
from hamiltorch_tpu.samplers.adaptation import da_update as j_da_update
from hamiltorch_tpu_torch.samplers.adaptation import da_init, da_update


def log_ratios(n=60, seed=0):
    rng = np.random.RandomState(seed)
    r = (rng.randn(n) * 0.8 - 0.3).astype(np.float32)
    r[[7, 23]] = np.nan  # divergences count as alpha = 0
    r[[11]] = np.inf
    return r


def test_dual_averaging_sequence_matches():
    j_state, t_state = j_da_init(0.3), da_init(0.3)
    for t, rho in enumerate(log_ratios()):
        j_state = j_da_update(j_state, jnp.asarray(rho), jnp.asarray(t), desired_accept_rate=0.75)
        t_state = da_update(t_state, torch.tensor(rho), t, desired_accept_rate=0.75)
        for name in ("step_size", "log_eps_bar", "h_t", "mu"):
            np.testing.assert_allclose(
                float(getattr(t_state, name)), float(getattr(j_state, name)),
                rtol=1e-5, atol=1e-7, err_msg=f"{name} at t={t}")


def test_batched_state_updates_each_chain_alone():
    ratios = np.stack([log_ratios(seed=s) for s in range(3)], axis=1)  # (T, C)
    batched = da_init(torch.tensor([0.1, 0.3, 1.0]))
    singles = [da_init(e) for e in (0.1, 0.3, 1.0)]
    for t, row in enumerate(ratios):
        batched = da_update(batched, torch.as_tensor(row), t)
        singles = [da_update(s, torch.tensor(r), t) for s, r in zip(singles, row)]
    for c, s in enumerate(singles):
        torch.testing.assert_close(batched.step_size[c], s.step_size)
        torch.testing.assert_close(batched.log_eps_bar[c], s.log_eps_bar)
