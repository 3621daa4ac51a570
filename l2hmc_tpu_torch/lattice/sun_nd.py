"""d-dimensional SU(N) lattice gauge fields (port of
``l2hmc_tpu/lattice/sun_nd.py``, its complex forms).

Link fields ``(B, L1, ..., Ld, d, N, N)`` complex64 over any dimension d:
vectorized Wilson and tree-level-Symanzik (rectangle-improved) actions,
gauge transforms, and Lie-group HMC whose exponential and reunitarization
are the matmul-only forms of ``ops/su_matrix.py``.

Anchors: d=2 reduces to ``lattice/sun.py``; at small beta the
strong-coupling value ``<Re tr P / N> = beta/4`` (SU(2)), ``beta/(2
N^2)`` (SU(N>=3)) holds in any dimension; every action is gauge invariant.

The reference's ``*_pairs`` forms (links as float32 (re, im) pairs) exist
because its TPU runtime rejects complex dtypes; CUDA computes complex64,
so they are not ported (ROADMAP "Not to port") and raise here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from l2hmc_tpu_torch.dynamics.sun_hmc import algebra_force
from l2hmc_tpu_torch.lattice.sun import (
    algebra_to_matrix,
    dagger as _dag,
    generators,
    random_sun,
    retrace_over_n as _retr_over_n,
)
from l2hmc_tpu_torch.ops.su_matrix import expm_ih, polar_reunitarize

PAIRS_NOT_PORTED = (
    "the (re, im) pair forms are not ported: the reference needs them only "
    "because its TPU runtime rejects complex dtypes, and CUDA computes "
    "complex64 (ROADMAP.md, \"Not to port\": the *_pairs forms of "
    "lattice/sun_nd.py and SUNL2HMCConfig.real_pairs)")


def _shift(a: torch.Tensor, mu: int, d: int, trailing: int,
           steps: int = 1) -> torch.Tensor:
    """Field value at ``n + steps * e_mu`` (periodic); ``trailing`` is the
    number of non-site trailing axes (2 for ``(..., N, N)``, 3 for links
    ``(..., d, N, N)``)."""
    return torch.roll(a, shifts=-steps, dims=mu - d - trailing)


def num_dims(links: torch.Tensor) -> int:
    """Spacetime dimension d, read off the direction axis."""
    return links.shape[-3]


def random_links_nd(generator: Optional[torch.Generator], n: int, batch: int,
                    dims: Sequence[int], scale: float = 0.5, device=None,
                    normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random near-identity SU(N) links ``(batch, *dims, d, N, N)``."""
    return random_sun(generator, n, (batch, *dims, len(dims)), scale=scale,
                      device=device, normals=normals)


def plaq_field_nd(links: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """``P(n) = U_mu(n) U_nu(n+mu) U_mu(n+nu)^+ U_nu(n)^+``; input ``(...,
    dims, d, N, N)``, output ``(..., dims, N, N)``."""
    d = num_dims(links)
    umu = links[..., mu, :, :]
    unu = links[..., nu, :, :]
    return (umu @ _shift(unu, mu, d, 2) @ _dag(_shift(umu, nu, d, 2))
            @ _dag(unu))


def rect_field_nd(links: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """2x1 rectangle, long side along mu: ``U_mu(n) U_mu(n+mu) U_nu(n+2mu)
    U_mu(n+mu+nu)^+ U_mu(n+nu)^+ U_nu(n)^+``."""
    d = num_dims(links)
    umu = links[..., mu, :, :]
    unu = links[..., nu, :, :]
    umu_nu = _shift(umu, nu, d, 2)
    return (umu @ _shift(umu, mu, d, 2) @ _shift(unu, mu, d, 2, steps=2)
            @ _dag(_shift(umu_nu, mu, d, 2)) @ _dag(umu_nu) @ _dag(unu))


def _site_sum(a: torch.Tensor, d: int) -> torch.Tensor:
    """Sum a per-site field ``(B, *dims)`` over its d site axes."""
    return torch.sum(a, dim=tuple(range(a.ndim - d, a.ndim)))


def wilson_action_nd(links: torch.Tensor, beta) -> torch.Tensor:
    """``beta sum_{mu<nu} sum_n (1 - Re tr P / N)`` per sample ``(B,)``."""
    d = num_dims(links)
    s = 0.0
    for mu in range(d):
        for nu in range(mu + 1, d):
            s = s + _site_sum(1.0 - _retr_over_n(plaq_field_nd(links, mu, nu)),
                              d)
    return beta * s


def improved_action_nd(links: torch.Tensor, beta,
                       c1: float = -1.0 / 12.0) -> torch.Tensor:
    """Tree-level Symanzik-improved action, ``c0 = 1 - 8 c1``, rectangles
    over ordered pairs ``mu != nu``; ``c1 = 0`` is the Wilson action."""
    c0 = 1.0 - 8.0 * c1
    d = num_dims(links)
    s = 0.0
    for mu in range(d):
        for nu in range(mu + 1, d):
            s = s + c0 * _site_sum(
                1.0 - _retr_over_n(plaq_field_nd(links, mu, nu)), d)
    if c1 != 0.0:
        for mu in range(d):
            for nu in range(d):
                if nu == mu:
                    continue
                s = s + c1 * _site_sum(
                    1.0 - _retr_over_n(rect_field_nd(links, mu, nu)), d)
    return beta * s


def avg_plaq_nd(links: torch.Tensor) -> torch.Tensor:
    """``<Re tr P / N>`` averaged over sites and planes, per sample."""
    d = num_dims(links)
    acc, cnt = 0.0, 0
    for mu in range(d):
        for nu in range(mu + 1, d):
            a = _retr_over_n(plaq_field_nd(links, mu, nu))
            acc = acc + torch.mean(a, dim=tuple(range(a.ndim - d, a.ndim)))
            cnt += 1
    return acc / cnt


def gauge_transform_nd(links: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``U_mu(n) -> g(n) U_mu(n) g(n+mu)^+`` with ``g (B, *dims, N, N)``."""
    d = num_dims(links)
    return torch.stack([g @ links[..., mu, :, :] @ _dag(_shift(g, mu, d, 2))
                        for mu in range(d)], dim=-3)


def sun_plaq_strong_coupling(n: int, beta: float) -> float:
    """Leading-order small-beta plaquette (any dimension):
    ``beta <(Re tr U)^2>_Haar / N^2``, with ``<(Re tr U)^2> = 1`` for SU(2)
    and ``1/2`` for SU(N>=3)."""
    return beta / (n * n) if n == 2 else beta / (2.0 * n * n)


def _left_translate(links: torch.Tensor, theta: torch.Tensor,
                    gens: torch.Tensor) -> torch.Tensor:
    return expm_ih(algebra_to_matrix(theta, gens)) @ links


class SUNndHMCOut(NamedTuple):
    links: torch.Tensor
    accept_prob: torch.Tensor


@torch.no_grad()
def sun_nd_hmc_transition(links: torch.Tensor,
                          generator: Optional[torch.Generator], eps,
                          num_steps: int,
                          action_fn: Callable[[torch.Tensor], torch.Tensor],
                          pi: Optional[torch.Tensor] = None,
                          u: Optional[torch.Tensor] = None) -> SUNndHMCOut:
    """One HMC transition for ``(B, *dims, d, N, N)`` links under any gauge
    action ``action_fn(links) -> (B,)``; momenta ``pi (B, *dims, d, k)``
    and accept uniforms ``u (B,)`` drawn from ``generator`` unless given."""
    n = links.shape[-1]
    gens = generators(n, links.device)
    k = gens.shape[0]
    if pi is None:
        pi = torch.randn(links.shape[:-2] + (k,), generator=generator,
                         device=links.device)
    if u is None:
        u = torch.rand((links.shape[0],), generator=generator,
                       device=links.device)

    def kinetic(p):
        return 0.5 * torch.sum(p * p, dim=tuple(range(1, p.ndim)))

    def force(v):
        return algebra_force(action_fn, v, gens, _left_translate)

    h0 = action_fn(links) + kinetic(pi)
    uu, p = links, pi
    for _ in range(num_steps):
        p = p - 0.5 * eps * force(uu)
        uu = polar_reunitarize(_left_translate(uu, eps * p, gens))
        p = p - 0.5 * eps * force(uu)
    h1 = action_fn(uu) + kinetic(p)
    prob = torch.exp(torch.clamp(h0 - h1, max=0.0))
    prob = torch.where(torch.isfinite(prob), prob, torch.zeros_like(prob))
    accept = u < prob
    acc = accept.reshape(accept.shape + (1,) * (links.ndim - 1))
    return SUNndHMCOut(links=torch.where(acc, uu, links), accept_prob=prob)


def make_action(beta, c1: float = 0.0):
    """The Wilson action at ``beta``, or the improved one when ``c1 != 0``."""
    if c1 != 0.0:
        return lambda u: improved_action_nd(u, beta, c1)
    return lambda u: wilson_action_nd(u, beta)


@torch.no_grad()
def sun_nd_hmc_chain(generator: torch.Generator, n: int, dims: Sequence[int],
                     beta, num_samples: int, batch: int = 8, eps: float = 0.1,
                     num_steps: int = 5, c1: float = 0.0,
                     real_pairs: bool = False, device=None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chain of d-dimensional SU(N) HMC transitions from
    ``random_links_nd(scale=0.5)``.  Returns ``(plaq_trace (num_samples,
    batch), accept_probs)``; ``c1 != 0`` samples the improved action."""
    if real_pairs:
        raise NotImplementedError(PAIRS_NOT_PORTED)
    links = random_links_nd(generator, n, batch, dims, scale=0.5,
                            device=device)
    action_fn = make_action(beta, c1)
    plaqs, probs = [], []
    for _ in range(num_samples):
        out = sun_nd_hmc_transition(links, generator, eps, num_steps,
                                    action_fn)
        links = out.links
        plaqs.append(avg_plaq_nd(links))
        probs.append(out.accept_prob)
    return torch.stack(plaqs), torch.stack(probs)


def _pairs_not_ported(*args, **kwargs):
    raise NotImplementedError(PAIRS_NOT_PORTED)


random_links_nd_pairs = plaq_field_nd_pairs = rect_field_nd_pairs = \
    wilson_action_nd_pairs = improved_action_nd_pairs = avg_plaq_nd_pairs = \
    sun_nd_hmc_transition_pairs = _pairs_not_ported
