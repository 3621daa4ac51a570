"""Plain 2-D U(1) lattice arithmetic: the yardstick's own copy.

Links are ``(B, Lt, Lx, 2)`` angles; ``[..., 0]`` points along t,
``[..., 1]`` along x.  The plaquette ``P(t, x) = U0(t, x) + U1(t+1, x) -
U0(t, x+1) - U1(t, x)`` (periodic), the Wilson action ``S = sum(1 - cos
P)``, its force and the charge ``Q = sum(wrap(P)) / 2 pi``.  A flat state
is the links reshaped to ``(B, 2 Lt Lx)``: ``index = (t Lx + x) 2 + mu``.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Angles into ``[-pi, pi)``."""
    return x - TWO_PI * torch.floor((x + math.pi) / TWO_PI)


def plaquettes(links: torch.Tensor) -> torch.Tensor:
    """``(B, Lt, Lx, 2) -> (B, Lt, Lx)`` plaquette angles."""
    u0, u1 = links[..., 0], links[..., 1]
    return (u0 - u1 - torch.roll(u0, -1, dims=2)
            + torch.roll(u1, -1, dims=1))


def action(links: torch.Tensor) -> torch.Tensor:
    """Wilson action per configuration."""
    return torch.sum(1.0 - torch.cos(plaquettes(links)), dim=(1, 2))


def force(links: torch.Tensor, beta: float) -> torch.Tensor:
    """``d [beta S] / d links``, ``(B, Lt, Lx, 2)``."""
    sp = torch.sin(plaquettes(links))
    g0 = sp - torch.roll(sp, 1, dims=2)
    g1 = torch.roll(sp, 1, dims=1) - sp
    return beta * torch.stack([g0, g1], dim=-1)


def charge(links: torch.Tensor) -> torch.Tensor:
    """Unrounded topological charge per configuration."""
    return torch.sum(wrap(plaquettes(links)), dim=(1, 2)) / TWO_PI


def near_equilibrium(generator: torch.Generator, b: int, lt: int, lx: int,
                     sigma: float) -> torch.Tensor:
    """``b`` configurations near equilibrium, made on the generator's
    device in three calls: normal link angles of width ``sigma`` (a
    plaquette's ``<cos P> ~ exp(-2 sigma^2)``) under a uniform random gauge
    transformation, which keeps every plaquette and spreads the links over
    the circle as an equilibrium ensemble does."""
    dev = generator.device
    a = sigma * torch.randn((b, lt, lx, 2), generator=generator, device=dev)
    g = math.pi * (2.0 * torch.rand((b, lt, lx), generator=generator,
                                    device=dev) - 1.0)
    a[..., 0] += g - torch.roll(g, -1, dims=1)
    a[..., 1] += g - torch.roll(g, -1, dims=2)
    return wrap(a)


def sigma_at(beta_plaquette: float) -> float:
    """The width ``sigma`` whose ``exp(-2 sigma^2)`` is the plaquette
    ``beta_plaquette``."""
    return math.sqrt(-math.log(beta_plaquette) / 2.0)
