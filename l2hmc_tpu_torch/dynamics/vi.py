"""Variational-inference baselines (port of ``l2hmc_tpu/dynamics/vi.py``).

- :func:`fit_meanfield`: ADVI, a diagonal Gaussian q(x) trained by
  reparameterized ELBO ascent;
- :func:`fit_fullrank`: a full-rank Gaussian q through a Cholesky factor
  whose diagonal passes through softplus (exact for Gaussian targets, so an
  oracle for that family).

The ELBO is ``E_q[-E(x)] + H[q]`` (the target need not be normalized; the
ELBO then lower-bounds ``log Z``), maximized by ``torch.optim.Adam``.  The
standard normals of every step are drawn from ``generator`` unless
injected as ``normals (num_steps, num_samples, dim)``; the fit runs on
their device, else on ``device`` (``None``: the card).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from l2hmc_tpu_torch._device import resolve_device

EnergyFn = Callable[[torch.Tensor], torch.Tensor]


class MeanFieldParams(NamedTuple):
    mu: torch.Tensor
    log_sigma: torch.Tensor


class FullRankParams(NamedTuple):
    mu: torch.Tensor
    chol_raw: torch.Tensor  # lower triangle; diagonal through softplus


def _entropy_diag(log_sigma: torch.Tensor) -> torch.Tensor:
    d = log_sigma.shape[-1]
    return 0.5 * d * (1.0 + np.log(2 * np.pi)) + torch.sum(log_sigma)


def _chol_from_raw(raw: torch.Tensor) -> torch.Tensor:
    diag = F.softplus(torch.diagonal(raw)) + 1e-6
    return torch.tril(raw, diagonal=-1) + torch.diag(diag)


def meanfield_neg_elbo(p: MeanFieldParams, energy_fn: EnergyFn,
                       z: torch.Tensor) -> torch.Tensor:
    """``-ELBO`` of the diagonal Gaussian on standard normals ``z (S, d)``."""
    x = p.mu + torch.exp(p.log_sigma) * z
    return torch.mean(energy_fn(x)) - _entropy_diag(p.log_sigma)


def fullrank_neg_elbo(p: FullRankParams, energy_fn: EnergyFn,
                      z: torch.Tensor) -> torch.Tensor:
    """``-ELBO`` of the full-rank Gaussian on standard normals ``z (S, d)``."""
    chol = _chol_from_raw(p.chol_raw)
    dim = chol.shape[0]
    x = p.mu + z @ chol.T
    entropy = (0.5 * dim * (1.0 + np.log(2 * np.pi))
               + torch.sum(torch.log(torch.diagonal(chol))))
    return torch.mean(energy_fn(x)) - entropy


def _fit(params, neg_elbo, energy_fn, dim, generator, num_steps,
         num_samples, lr, normals, device):
    opt = torch.optim.Adam(list(params), lr=lr)
    elbos = []
    for i in range(num_steps):
        z = (normals[i] if normals is not None else torch.randn(
            (num_samples, dim), generator=generator, device=device))
        opt.zero_grad()
        loss = neg_elbo(params, energy_fn, z)
        loss.backward()
        opt.step()
        elbos.append(-loss.detach())
    return (type(params)(*(p.detach() for p in params)),
            torch.stack(elbos))


def fit_meanfield(energy_fn: EnergyFn, dim: int,
                  generator: Optional[torch.Generator] = None,
                  num_steps: int = 2000, num_samples: int = 64,
                  lr: float = 1e-2, normals: Optional[torch.Tensor] = None,
                  device=None) -> Tuple[MeanFieldParams, torch.Tensor]:
    """ADVI with a diagonal Gaussian from ``mu = 0, sigma = 1``.  Returns
    ``(params, elbo_trace (num_steps,))``, each ELBO the one before its
    step's update."""
    device = (normals.device if normals is not None
              else resolve_device(device))
    params = MeanFieldParams(
        mu=torch.zeros(dim, device=device, requires_grad=True),
        log_sigma=torch.zeros(dim, device=device, requires_grad=True))
    return _fit(params, meanfield_neg_elbo, energy_fn, dim, generator,
                num_steps, num_samples, lr, normals, device)


def fit_fullrank(energy_fn: EnergyFn, dim: int,
                 generator: Optional[torch.Generator] = None,
                 num_steps: int = 3000, num_samples: int = 64,
                 lr: float = 1e-2, normals: Optional[torch.Tensor] = None,
                 device=None) -> Tuple[FullRankParams, torch.Tensor]:
    """Full-rank Gaussian VI from ``mu = 0``, ``chol_raw = I``.  Returns
    ``(params, elbo_trace)``."""
    device = (normals.device if normals is not None
              else resolve_device(device))
    params = FullRankParams(
        mu=torch.zeros(dim, device=device, requires_grad=True),
        chol_raw=torch.eye(dim, device=device).requires_grad_(True))
    return _fit(params, fullrank_neg_elbo, energy_fn, dim, generator,
                num_steps, num_samples, lr, normals, device)


def meanfield_sample(params: MeanFieldParams, generator, n: int,
                     z: Optional[torch.Tensor] = None) -> torch.Tensor:
    if z is None:
        z = torch.randn((n, params.mu.shape[-1]), generator=generator,
                        device=params.mu.device)
    return params.mu + torch.exp(params.log_sigma) * z


def fullrank_sample(params: FullRankParams, generator, n: int,
                    z: Optional[torch.Tensor] = None) -> torch.Tensor:
    if z is None:
        z = torch.randn((n, params.mu.shape[-1]), generator=generator,
                        device=params.mu.device)
    return params.mu + z @ _chol_from_raw(params.chol_raw).T


def fullrank_covariance(params: FullRankParams) -> torch.Tensor:
    chol = _chol_from_raw(params.chol_raw)
    return chol @ chol.T
