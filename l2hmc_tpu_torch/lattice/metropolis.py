"""Checkerboard Metropolis link updates for U(1) (port of
``l2hmc_tpu/lattice/metropolis.py``).

A link's conditional action involves only the two plaquettes that hold it,
so links of equal (site parity, direction) are conditionally independent and
update together: one sweep is four sub-sweeps, one per ``(mu, parity)``
class, each an exact Metropolis step for every link of its class.  Used as
the exact warm start of a sampler evaluation (:func:`thermalize`) and as an
independent oracle (:func:`metropolis_chain`).

With ``P(t,x) = u0(t,x) - u1(t,x) - u0(t,x+1) + u1(t+1,x)``:

- ``u0(t,x)`` sits in ``P(t,x) = theta + A`` and ``P(t,x-1) = B - theta``;
- ``u1(t,x)`` sits in ``P(t,x) = C - theta`` and ``P(t-1,x) = D + theta``;

with A, B, C, D sums of neighbouring links (the rolls below).  Randomness
comes from a ``torch.Generator``, or is injected per sub-sweep.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from l2hmc_tpu_torch.lattice import u1


def _partial_plaqs(links: torch.Tensor,
                   mu: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two plaquette-angle remainders of every link in direction mu.

    Returns ``(r1, r2)`` such that the local action is
    ``-cos(theta + r1) - cos(r2 - theta)`` for mu=0 and
    ``-cos(r1 - theta) - cos(r2 + theta)`` for mu=1.
    """
    u0 = links[..., 0]
    u1_ = links[..., 1]
    roll = torch.roll
    if mu == 0:
        a = -u1_ - roll(u0, -1, dims=-1) + roll(u1_, -1, dims=-2)
        b = (roll(u0, 1, dims=-1) - roll(u1_, 1, dims=-1)
             + roll(roll(u1_, -1, dims=-2), 1, dims=-1))
        return a, b
    c = u0 - roll(u0, -1, dims=-1) + roll(u1_, -1, dims=-2)
    d = (roll(u0, 1, dims=-2) - roll(u1_, 1, dims=-2)
         - roll(roll(u0, -1, dims=-1), 1, dims=-2))
    return c, d


def _action_of(r1, r2, mu: int, theta):
    if mu == 0:
        return -torch.cos(theta + r1) - torch.cos(r2 - theta)
    return -torch.cos(r1 - theta) - torch.cos(r2 + theta)


def local_action(links: torch.Tensor, mu: int,
                 theta: torch.Tensor) -> torch.Tensor:
    """Per-link local Wilson action (the two plaquettes holding the link)."""
    r1, r2 = _partial_plaqs(links, mu)
    return _action_of(r1, r2, mu, theta)


def metropolis_sweep(
    links: torch.Tensor, beta, generator: Optional[torch.Generator] = None,
    proposal_scale: float = 1.0,
    draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full checkerboard sweep of ``links (..., Lt, Lx, 2)``.

    Sub-sweeps run in the order ``(mu, parity) = (0,0), (0,1), (1,0),
    (1,1)``.  Each draws a proposal shift uniform in ``[-proposal_scale,
    proposal_scale)`` and an accept uniform for every link of direction mu
    from ``generator``, unless ``draws`` gives the four ``(prop, u)`` pairs
    in that order (each of the shape ``links[..., 0]``).  Returns the
    wrapped links (a new tensor; the input is not modified) and the mean
    acceptance of the updated classes.
    """
    if draws is not None and len(draws) != 4:
        raise ValueError(f"draws: expected 4 (prop, u) pairs, got {len(draws)}")
    lt, lx = links.shape[-3], links.shape[-2]
    tt = torch.arange(lt, device=links.device)[:, None]
    xx = torch.arange(lx, device=links.device)[None, :]
    parity = (tt + xx) % 2
    links = links.clone()
    acc_sum = torch.zeros((), dtype=links.dtype, device=links.device)
    k = 0
    for mu in (0, 1):
        for par in (0, 1):
            theta_old = links[..., mu]
            if draws is None:
                prop = (torch.rand(theta_old.shape, generator=generator,
                                   dtype=links.dtype, device=links.device)
                        * 2.0 - 1.0) * proposal_scale
                u = torch.rand(theta_old.shape, generator=generator,
                               dtype=links.dtype, device=links.device)
            else:
                prop, u = draws[k]
            k += 1
            theta_new = theta_old + prop
            r1, r2 = _partial_plaqs(links, mu)
            delta = beta * (_action_of(r1, r2, mu, theta_new)
                            - _action_of(r1, r2, mu, theta_old))
            accept = ((u < torch.exp(torch.clamp(-delta, max=0.0)))
                      & (parity == par))
            links[..., mu] = torch.where(accept, theta_new, theta_old)
            acc_sum = acc_sum + 2.0 * torch.mean(accept.to(links.dtype))
    return u1.wrap(links), acc_sum / 4.0


def metropolis_chain(generator: Optional[torch.Generator],
                     shape: u1.LatticeShape, beta, num_sweeps: int,
                     batch: int = 1, proposal_scale: float = 1.0,
                     thin: int = 1, device=None):
    """Run ``num_sweeps`` sweeps from a hot start and record observables
    every ``thin`` sweeps.  Returns ``(plaqs (T, batch), charges (T,
    batch))`` with ``T = num_sweeps // thin``."""
    links = u1.to_links(u1.random_links(generator, batch, shape,
                                        device=device), shape)
    plaqs, charges = [], []
    for _ in range(num_sweeps // thin):
        for _ in range(thin):
            links, _ = metropolis_sweep(links, beta, generator,
                                        proposal_scale)
        obs = u1.observables(u1.to_flat(links), shape)
        plaqs.append(obs["plaqs"])
        charges.append(obs["charges"])
    return torch.stack(plaqs), torch.stack(charges)


def thermalize(generator: Optional[torch.Generator], x: torch.Tensor,
               shape: u1.LatticeShape, beta, num_sweeps: int) -> torch.Tensor:
    """Equilibrate flat configs ``x (batch, x_dim)`` with ``num_sweeps``
    exact checkerboard Metropolis sweeps at ``beta``; returns flat configs.

    The standard lattice warm start for a sampler evaluation: chains far
    from equilibrium relax in O(10^3) cheap local sweeps.
    """
    links = u1.to_links(x, shape)
    with torch.no_grad():
        for _ in range(num_sweeps):
            links, _ = metropolis_sweep(links, beta, generator)
    return u1.to_flat(links)
