"""SU(2) lattice gauge theory in the quaternion representation (port of
``l2hmc_tpu/lattice/su2.py``).

SU(2) elements are unit quaternions ``a = (a0, a1, a2, a3)`` with ``U = a0
I + i a_k sigma_k``, all-real arithmetic:

- product:  ``(a b)_0 = a0 b0 - a.b``, ``(a b)_k = a0 b_k + b0 a_k - (a x
  b)_k``
- dagger:   ``(a0, -a_vec)``
- Re tr U = ``2 a0``; exp(i theta n.sigma/2) = ``(cos(theta/2),
  sin(theta/2) n)``

Links ``(..., Lt, Lx, 2, 4)`` float32; the Wilson action ``S = beta sum (1
- Re tr P / 2)`` with the plaquette orientation of ``lattice/sun.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product in the ``U = a0 + i a.sigma`` convention (the cross product
    enters with a minus sign, opposite to Hamilton quaternions)."""
    a0, av = a[..., :1], a[..., 1:]
    b0, bv = b[..., :1], b[..., 1:]
    s = a0 * b0 - torch.sum(av * bv, dim=-1, keepdim=True)
    v = a0 * bv + b0 * av - torch.linalg.cross(av, bv, dim=-1)
    return torch.cat([s, v], dim=-1)


def qconj(a: torch.Tensor) -> torch.Tensor:
    """Dagger: ``(a0, -a_vec)``."""
    return torch.cat([a[..., :1], -a[..., 1:]], dim=-1)


def q_exp(theta: torch.Tensor) -> torch.Tensor:
    """``exp(i theta . sigma / 2)`` for algebra coordinates ``theta (...,
    3)``: ``(cos(|t|/2), sinc(|t|/2) t / 2)``, smooth at 0."""
    n2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    half = 0.5 * torch.sqrt(n2 + 1e-24)
    return torch.cat([torch.cos(half), torch.sinc(half / np.pi) * 0.5 * theta],
                     dim=-1)


def qnormalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.linalg.norm(a, dim=-1, keepdim=True)


def random_links(generator: Optional[torch.Generator], batch: int, lt: int,
                 lx: int, scale=None, device=None,
                 normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Haar-random (``scale=None``: normalized 4-vectors of normals) or
    near-identity (``q_exp(scale * normals)``) SU(2) links ``(batch, lt,
    lx, 2, 4)``; ``normals`` (last axis 4, or 3 with a scale) drawn from
    ``generator`` unless given."""
    if normals is None:
        device = resolve_device(device)
        shape = (batch, lt, lx, 2, 4 if scale is None else 3)
        normals = torch.randn(shape, generator=generator,
                              device=generator.device if generator is not None
                              else device).to(device)
    if scale is None:
        return qnormalize(normals)
    return q_exp(scale * normals)


def cold_links(batch: int, lt: int, lx: int, device=None) -> torch.Tensor:
    a = torch.zeros((batch, lt, lx, 2, 4), device=resolve_device(device))
    a[..., 0] = 1.0
    return a


def plaquette(links: torch.Tensor) -> torch.Tensor:
    """``P(n) = U0(n) U1(n+0) U0(n+1)^+ U1(n)^+`` as quaternions; links
    ``(..., Lt, Lx, 2, 4)``."""
    u0 = links[..., 0, :]
    u1 = links[..., 1, :]
    u1_tp = torch.roll(u1, -1, dims=-3)   # t+1
    u0_xp = torch.roll(u0, -1, dims=-2)   # x+1
    return qmul(qmul(u0, u1_tp), qmul(qconj(u0_xp), qconj(u1)))


def wilson_action(links: torch.Tensor, beta) -> torch.Tensor:
    """``beta * sum (1 - Re tr P / 2)`` per sample -> ``(...,)``."""
    return beta * torch.sum(1.0 - plaquette(links)[..., 0], dim=(-2, -1))


def avg_plaquette(links: torch.Tensor) -> torch.Tensor:
    """``< Re tr P / 2 >`` per sample."""
    return torch.mean(plaquette(links)[..., 0], dim=(-2, -1))


def su2_plaq_exact(beta: float, n_grid: int = 4096) -> float:
    """Single-plaquette (= 2-D infinite-volume) ``<Re tr P / 2>``: the
    Haar class measure ``sin^2(t) dt`` with weight ``exp(beta cos t)``, by
    trapezoidal quadrature."""
    t = np.linspace(0.0, np.pi, n_grid)
    w = np.sin(t) ** 2 * np.exp(beta * np.cos(t))
    return float(np.trapezoid(np.cos(t) * w, t) / np.trapezoid(w, t))


def to_matrix(a: torch.Tensor) -> torch.Tensor:
    """Quaternion -> complex64 2x2 SU(2) matrix."""
    a = a.to(torch.complex64)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    row0 = torch.stack([a0 + 1j * a3, a2 + 1j * a1], dim=-1)
    row1 = torch.stack([-a2 + 1j * a1, a0 - 1j * a3], dim=-1)
    return torch.stack([row0, row1], dim=-2)
