"""Lie-group HMC for SU(2) lattice gauge theory in the quaternion
representation (port of ``l2hmc_tpu/dynamics/su2_hmc.py``).

Momenta ``pi (..., Lt, Lx, 2, 3)`` in the su(2) algebra, kinetic ``0.5
|pi|^2``; the position update is the left translation ``U <- exp(i eps
pi . T) U`` (Haar-measure preserving); the force is the gradient of the
action with respect to left-translation coordinates at the identity,
``d/dtheta S(exp(i theta.T) U)`` at ``theta = 0``, by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from l2hmc_tpu_torch.lattice import su2


def _force(links: torch.Tensor, beta) -> torch.Tensor:
    """``dS/dtheta`` of left translation at theta=0; the shape of pi."""
    with torch.enable_grad():
        zero = torch.zeros(links.shape[:-1] + (3,), dtype=links.dtype,
                           device=links.device, requires_grad=True)
        s = torch.sum(su2.wilson_action(su2.qmul(su2.q_exp(zero), links),
                                        beta))
        (g,) = torch.autograd.grad(s, zero)
    return g


def _kinetic(pi: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(pi * pi, dim=(-4, -3, -2, -1))


class SU2HMCOut(NamedTuple):
    links: torch.Tensor
    accept_prob: torch.Tensor
    accept_mask: torch.Tensor


@torch.no_grad()
def su2_hmc_transition(links: torch.Tensor, beta,
                       generator: Optional[torch.Generator], eps,
                       num_steps: int, pi: Optional[torch.Tensor] = None,
                       u: Optional[torch.Tensor] = None) -> SU2HMCOut:
    """One HMC transition for SU(2) links ``(B, Lt, Lx, 2, 4)``; momenta
    ``pi (B, Lt, Lx, 2, 3)`` and accept uniforms ``u (B,)`` drawn from
    ``generator`` unless given."""
    if pi is None:
        pi = torch.randn(links.shape[:-1] + (3,), generator=generator,
                         dtype=links.dtype, device=links.device)
    if u is None:
        u = torch.rand((links.shape[0],), generator=generator,
                       device=links.device)
    h0 = su2.wilson_action(links, beta) + _kinetic(pi)
    uu, p = links, pi
    for _ in range(num_steps):
        p = p - 0.5 * eps * _force(uu, beta)
        uu = su2.qnormalize(su2.qmul(su2.q_exp(eps * p), uu))
        p = p - 0.5 * eps * _force(uu, beta)
    h1 = su2.wilson_action(uu, beta) + _kinetic(p)
    prob = torch.exp(torch.clamp(h0 - h1, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    accept = u < prob
    out = torch.where(accept[:, None, None, None, None], uu, links)
    return SU2HMCOut(links=out, accept_prob=prob,
                     accept_mask=accept.to(links.dtype))


@torch.no_grad()
def su2_hmc_chain(generator: torch.Generator, lt: int, lx: int, beta,
                  num_samples: int, batch: int = 16, eps: float = 0.15,
                  num_steps: int = 5, init: str = "hot", device=None):
    """A chain of SU(2) HMC transitions from a hot (Haar) or cold start;
    returns ``(plaquette trace (T, B), accept trace (T, B))``."""
    links = (su2.random_links(generator, batch, lt, lx, device=device)
             if init == "hot" else su2.cold_links(batch, lt, lx, device))
    plaqs, probs = [], []
    for _ in range(num_samples):
        out = su2_hmc_transition(links, beta, generator, eps, num_steps)
        links = out.links
        plaqs.append(su2.avg_plaquette(links))
        probs.append(out.accept_prob)
    return torch.stack(plaqs), torch.stack(probs)
