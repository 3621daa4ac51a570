"""Lie-group HMC for SU(N) lattice gauge theory, matrix representation
(port of ``l2hmc_tpu/dynamics/sun_hmc.py``).

Momenta are algebra coefficients, the position update is the left
translation by ``matrix_exp(i eps pi . T)`` (``torch.linalg.matrix_exp``,
where the reference calls ``jax.scipy.linalg.expm``), and the force is the
autograd gradient of the action with respect to left-translation
coordinates at the identity; links ``(B, Lt, Lx, 2, N, N)`` complex64.

Exact anchor: 2-D SU(N) factorizes over plaquettes, and the
single-plaquette ``<Re tr P / N>`` is a class-function integral over the
maximal torus with the Weyl measure (``sun_plaq_exact``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.lattice.sun import (
    algebra_to_matrix,
    generators,
    random_sun,
    retrace_over_n,
    sun_action,
    sun_plaquette,
)
from l2hmc_tpu_torch.ops.su_matrix import _det_small


def _left_translate(links: torch.Tensor, theta: torch.Tensor,
                    gens: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_exp(1j * algebra_to_matrix(theta, gens)) @ links


def _reunitarize(u: torch.Tensor) -> torch.Tensor:
    """Back to U(N), then to SU(N) by dividing out the determinant's phase
    (the principal n-th root).

    The U(N) factor is the reference's QR with the diagonal phase fix: the
    unique ``Q`` of ``u = Q R`` with ``R``'s diagonal real and positive,
    which Gram-Schmidt on the columns gives directly.  It is formed so, in
    batched elementwise ops, because ``torch.linalg.qr`` on the card
    factors a batch of small matrices one by one
    (``benchmarks/sun_ops_time.py``); the determinant is the closed form
    for N <= 3."""
    cols = []
    for j in range(u.shape[-1]):
        v = u[..., :, j]
        for q in cols:
            v = v - q * torch.sum(torch.conj(q) * v, dim=-1, keepdim=True)
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    q = torch.stack(cols, dim=-1)
    det = _det_small(q)
    return q * (det ** (-1.0 / u.shape[-1]))[..., None, None]


def algebra_force(action_fn, u: torch.Tensor, gens: torch.Tensor,
                  left_translate=_left_translate,
                  create_graph: bool = False) -> torch.Tensor:
    """``d/dtheta sum action_fn(exp(i theta.T) u)`` at ``theta = 0``, shape
    ``u.shape[:-2] + (k,)`` float32; ``create_graph`` keeps it
    differentiable (a train step's force)."""
    with torch.enable_grad():
        zero = torch.zeros(u.shape[:-2] + (gens.shape[0],),
                           dtype=torch.float32, device=u.device,
                           requires_grad=True)
        s = torch.sum(action_fn(left_translate(u, zero, gens)))
        (g,) = torch.autograd.grad(s, zero, create_graph=create_graph)
    return g


class SUNHMCOut(NamedTuple):
    links: torch.Tensor
    accept_prob: torch.Tensor


@torch.no_grad()
def sun_hmc_transition(links: torch.Tensor, beta,
                       generator: Optional[torch.Generator], eps,
                       num_steps: int, n: int,
                       pi: Optional[torch.Tensor] = None,
                       u: Optional[torch.Tensor] = None) -> SUNHMCOut:
    """One HMC transition for SU(N) links ``(B, Lt, Lx, 2, N, N)``; momenta
    ``pi (B, Lt, Lx, 2, k)`` and accept uniforms ``u (B,)`` drawn from
    ``generator`` unless given."""
    gens = generators(n, links.device)
    k = gens.shape[0]
    if pi is None:
        pi = torch.randn(links.shape[:-2] + (k,), generator=generator,
                         device=links.device)
    if u is None:
        u = torch.rand((links.shape[0],), generator=generator,
                       device=links.device)

    def action(v):
        return sun_action(v, beta)

    def kinetic(p):
        return 0.5 * torch.sum(p * p, dim=(-4, -3, -2, -1))

    h0 = action(links) + kinetic(pi)
    uu, p = links, pi
    for _ in range(num_steps):
        p = p - 0.5 * eps * algebra_force(action, uu, gens)
        uu = _reunitarize(_left_translate(uu, eps * p, gens))
        p = p - 0.5 * eps * algebra_force(action, uu, gens)
    h1 = action(uu) + kinetic(p)
    prob = torch.exp(torch.clamp(h0 - h1, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    accept = u < prob
    out = torch.where(accept[:, None, None, None, None, None], uu, links)
    return SUNHMCOut(links=out, accept_prob=prob)


def avg_plaquette(links: torch.Tensor) -> torch.Tensor:
    """``<Re tr P / N>`` per sample of 2-D links."""
    return torch.mean(retrace_over_n(sun_plaquette(links)), dim=(-2, -1))


@torch.no_grad()
def sun_hmc_chain(generator: torch.Generator, n: int, lt: int, lx: int,
                  beta, num_samples: int, batch: int = 8, eps: float = 0.1,
                  num_steps: int = 5, device=None):
    """A chain of SU(N) HMC transitions from ``random_sun(scale=0.5)``
    links; returns ``(<Re tr P / N> trace (T, B), accept trace (T, B))``."""
    links = random_sun(generator, n, (batch, lt, lx, 2), scale=0.5,
                       device=device)
    plaqs, probs = [], []
    for _ in range(num_samples):
        out = sun_hmc_transition(links, beta, generator, eps, num_steps, n)
        links = out.links
        plaqs.append(avg_plaquette(links))
        probs.append(out.accept_prob)
    return torch.stack(plaqs), torch.stack(probs)


def sun_plaq_exact(n: int, beta: float, n_grid: int = 200) -> float:
    """Single-plaquette ``<Re tr P / N>`` for 2-D SU(N) by quadrature.

    Weyl integration over the maximal torus: eigenphases ``t_1..t_{n-1}``
    (``t_n = -sum``), Haar class measure ``|prod_{i<j} (e^{i t_i} -
    e^{i t_j})|^2``, weight ``exp((beta/n) Re tr U)`` for the action
    convention ``S = beta (1 - Re tr P / n)``.
    """
    if n == 2:
        t = np.linspace(0, np.pi, 4096)
        w = np.sin(t) ** 2 * np.exp(beta * np.cos(t))
        return float(np.trapezoid(np.cos(t) * w, t) / np.trapezoid(w, t))
    if n != 3:
        raise NotImplementedError("oracle implemented for N in {2, 3}")
    t = np.linspace(-np.pi, np.pi, n_grid)
    t1, t2 = np.meshgrid(t, t, indexing="ij")
    t3 = -t1 - t2
    z = np.stack([np.exp(1j * t1), np.exp(1j * t2), np.exp(1j * t3)])
    vdm = (
        np.abs(z[0] - z[1]) ** 2
        * np.abs(z[0] - z[2]) ** 2
        * np.abs(z[1] - z[2]) ** 2
    )
    retr = np.cos(t1) + np.cos(t2) + np.cos(t3)
    w = vdm * np.exp(beta * retr / n)
    return float((retr / n * w).sum() / w.sum())
