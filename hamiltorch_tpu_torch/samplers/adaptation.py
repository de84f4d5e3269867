"""Dual-averaging step-size adaptation (Hoffman & Gelman 2014, Algorithm 5).

Counterpart of ``hamiltorch_tpu/samplers/adaptation.py``: gamma=0.05,
t0=10, kappa=0.75, a non-finite log acceptance ratio counts as alpha = 0,
and all quantities are kept in log space.  The state's tensors may carry a
leading chain axis; every operation is elementwise.
"""

from __future__ import annotations

import dataclasses

import torch

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75


@dataclasses.dataclass(frozen=True)
class DualAveragingState:
    step_size: torch.Tensor  # current step size
    log_eps_bar: torch.Tensor  # running log averaged step size
    h_t: torch.Tensor  # running statistic H_t
    mu: torch.Tensor  # log(10 * eps0), fixed shrinkage target


def da_init(step_size_init, dtype=torch.float32, device=None) -> DualAveragingState:
    eps0 = torch.as_tensor(step_size_init, dtype=dtype, device=device)
    return DualAveragingState(
        step_size=eps0,
        log_eps_bar=torch.zeros_like(eps0),  # eps_bar = 1.0, the reference's init
        h_t=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
    )


def da_update(
    state: DualAveragingState,
    log_accept_ratio: torch.Tensor,
    t,
    desired_accept_rate: float = 0.8,
) -> DualAveragingState:
    """One dual-averaging update; ``t`` is the 0-based iteration index."""
    t = torch.as_tensor(t, device=state.h_t.device).to(state.h_t.dtype) + 1
    lar = torch.as_tensor(log_accept_ratio, dtype=state.h_t.dtype, device=state.h_t.device)
    alpha = torch.where(
        torch.isfinite(lar),
        torch.clamp(torch.exp(torch.clamp(lar, max=0.0)), max=1.0),
        torch.zeros_like(lar),
    )
    eta = 1.0 / (t + T0)
    h_t = (1.0 - eta) * state.h_t + eta * (desired_accept_rate - alpha)
    log_eps = state.mu - torch.sqrt(t) / GAMMA * h_t
    w = t ** (-KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return DualAveragingState(
        step_size=torch.exp(log_eps),
        log_eps_bar=log_eps_bar,
        h_t=h_t,
        mu=state.mu,
    )
