"""Nesterov dual averaging of the step size (the part of
``l2hmc_tpu/dynamics/nuts.py`` the trainer uses: its eps warmup).

The state is four float32 scalars on the device of the acceptance that
drives it, so an update never waits for the host.  The NUTS sampler itself
is ROADMAP queue A item 10.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor


def dual_averaging_init(eps0: float, device=None) -> DualAveragingState:
    log_eps = torch.log(torch.tensor(eps0, dtype=torch.float32,
                                     device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps.clone(),
                              h_bar=zero, t=zero.clone())


def dual_averaging_update(state: DualAveragingState,
                          accept_stat: torch.Tensor, target: float = 0.7,
                          gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveragingState:
    """Nesterov dual averaging on log eps (Hoffman & Gelman 2014, Alg. 5)."""
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = ((1.0 - eta_h) * state.h_bar
             + eta_h * (target - torch.mean(accept_stat)))
    log_eps = state.log_eps_avg - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps_avg,
                              h_bar=h_bar, t=t)
