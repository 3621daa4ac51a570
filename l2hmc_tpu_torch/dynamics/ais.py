"""Annealed importance sampling (port of ``l2hmc_tpu/dynamics/ais.py``).

HMC transitions at interpolated energies ``E_t = (1-b_t) E0 + b_t E1``,
accumulating importance log-weights, with a fresh momentum each transition,
finished by a log-mean-exp estimate of ``log Z1/Z0``.

The interpolated energy is a plain function with no ``force``, so its
gradient goes through autograd: for the Wilson potential of
``ops/wilson.py`` on the card, the backward of its ``autograd.Function``,
which runs the Wilson kernels.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.dynamics.hmc import hmc_transition


@torch.no_grad()
def ais_log_weights(generator: Optional[torch.Generator], x0: torch.Tensor,
                    energy_init: Callable[[torch.Tensor], torch.Tensor],
                    energy_final: Callable[[torch.Tensor], torch.Tensor],
                    num_betas: int = 100, eps: float = 0.1,
                    num_leapfrog: int = 10, draws=None) -> torch.Tensor:
    """Run AIS from ``energy_init`` to ``energy_final``.

    ``x0 (B, d)`` are exact samples from the initial distribution.  Returns
    per-chain log-weights ``(B,)`` whose log-mean-exp estimates
    ``log(Z_final / Z_init)``.  ``draws``, a sequence of ``(v, u)`` per
    transition, replaces the generator's.
    """
    # the ladder in float32, as the reference's jnp.linspace
    betas = np.linspace(0.0, 1.0, num_betas + 1, dtype=np.float32)

    def energy_at(x, b):
        return (1.0 - b) * energy_init(x) + b * energy_final(x)

    x = x0
    logw = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    for i in range(num_betas):
        b_prev, b_curr = float(betas[i]), float(betas[i + 1])
        # importance weight increment: E_{b_prev}(x) - E_{b_curr}(x)
        logw = logw + energy_at(x, b_prev) - energy_at(x, b_curr)
        v, u = draws[i] if draws is not None else (None, None)
        x = hmc_transition(lambda y, b=b_curr: energy_at(y, b), x, 1.0, eps,
                           num_leapfrog, generator, v=v, u=u).x_out
    return logw


def log_mean_exp(logw: torch.Tensor) -> torch.Tensor:
    """``log Z`` estimate from AIS weights."""
    return torch.logsumexp(logw, dim=0) - np.log(logw.shape[0])
