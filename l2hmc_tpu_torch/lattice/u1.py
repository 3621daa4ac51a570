"""2-D U(1) lattice gauge theory in PyTorch (port of ``l2hmc_tpu/lattice/u1.py``).

Link fields are ``(..., Lt, Lx, 2)`` float32 angles; the flat layout used by
the dynamics is ``(..., 2*Lt*Lx)``.  Every function broadcasts over leading
batch axes.  The exact oracles (plaquette, Wilson loop, topological
susceptibility) are scalar math and are computed in numpy/scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import i0e, i1e

from l2hmc_tpu_torch._device import resolve_device

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class LatticeShape:
    """Static U(1) lattice geometry."""

    time_size: int
    space_size: int
    dim: int = 2  # number of link directions == lattice dimensionality

    @property
    def links_shape(self) -> Tuple[int, int, int]:
        return (self.time_size, self.space_size, self.dim)

    @property
    def num_links(self) -> int:
        return self.time_size * self.space_size * self.dim

    @property
    def num_plaquettes(self) -> int:
        return self.time_size * self.space_size

    @property
    def x_dim(self) -> int:
        """Flat state dimensionality seen by the dynamics."""
        return self.num_links


def to_links(x: torch.Tensor, shape: LatticeShape) -> torch.Tensor:
    """Reshape flat state ``(..., num_links)`` to ``(..., Lt, Lx, 2)``."""
    return x.reshape(*x.shape[:-1], *shape.links_shape)


def to_flat(links: torch.Tensor) -> torch.Tensor:
    """Reshape ``(..., Lt, Lx, 2)`` links to flat ``(..., num_links)``."""
    return links.reshape(*links.shape[:-3], -1)


def plaq_sums(links: torch.Tensor) -> torch.Tensor:
    """``P(t, x) = U0(t, x) - U1(t, x) - U0(t, x+1) + U1(t+1, x)``, periodic.

    ``(..., Lt, Lx, 2) -> (..., Lt, Lx)``.
    """
    u0 = links[..., 0]
    u1 = links[..., 1]
    return (u0 - u1 - torch.roll(u0, shifts=-1, dims=-1)
            + torch.roll(u1, shifts=-1, dims=-2))


def wilson_action(links: torch.Tensor) -> torch.Tensor:
    """Total Wilson action ``S = sum(1 - cos P)`` per sample."""
    return torch.sum(1.0 - torch.cos(plaq_sums(links)), dim=(-2, -1))


def avg_plaquette(links: torch.Tensor) -> torch.Tensor:
    """Average plaquette ``<cos P>`` per sample."""
    return torch.mean(torch.cos(plaq_sums(links)), dim=(-2, -1))


def project_angle(x: torch.Tensor) -> torch.Tensor:
    """Project angles to ``[-pi, pi)``."""
    return x - TWO_PI * torch.floor((x + np.pi) / TWO_PI)


def project_angle_approx(x: torch.Tensor, n_terms: int = 5) -> torch.Tensor:
    """Differentiable Fourier-series surrogate of :func:`project_angle`:
    ``sum_{n=1}^{N-1} (-2/n) (-1)^n sin(n x)`` (``N-1`` terms, as the
    reference keeps)."""
    y = torch.zeros_like(x)
    for n in range(1, n_terms):
        y = y + (-2.0 / n) * ((-1.0) ** n) * torch.sin(n * x)
    return y


def topological_charge(links: torch.Tensor) -> torch.Tensor:
    """Exact topological charge ``Q = sum proj(P) / 2pi`` (near-integer)."""
    return torch.sum(project_angle(plaq_sums(links)), dim=(-2, -1)) / TWO_PI


def topological_charge_approx(links: torch.Tensor,
                              n_terms: int = 5) -> torch.Tensor:
    """Differentiable topological charge via the Fourier surrogate."""
    p = plaq_sums(links)
    return torch.sum(project_angle_approx(p, n_terms), dim=(-2, -1)) / TWO_PI


def charge_diff(x1: torch.Tensor, x2: torch.Tensor,
                shape: LatticeShape) -> torch.Tensor:
    """``|Q(x1) - Q(x2)|`` of flat states with the exact projection."""
    return torch.abs(topological_charge(to_links(x1, shape))
                     - topological_charge(to_links(x2, shape)))


def charge_diff_approx(x1: torch.Tensor, x2: torch.Tensor,
                       shape: LatticeShape, n_terms: int = 5) -> torch.Tensor:
    """``|Q(x1) - Q(x2)|`` with the differentiable surrogate (loss path)."""
    return torch.abs(topological_charge_approx(to_links(x1, shape), n_terms)
                     - topological_charge_approx(to_links(x2, shape), n_terms))


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles into ``[-pi, pi)``."""
    return project_angle(x)


def make_potential_fn(shape: LatticeShape):
    """``U(x) -> per-sample Wilson action`` on flat states (autograd form)."""

    def potential(x: torch.Tensor) -> torch.Tensor:
        return wilson_action(to_links(x, shape))

    return potential


def random_links(generator: Optional[torch.Generator], n: int,
                 shape: LatticeShape, method: str = "uniform",
                 device=None) -> torch.Tensor:
    """Batch of ``n`` flat link configurations in ``[-pi, pi)`` on
    ``device`` (``None``: the first CUDA device; see ``resolve_device``).

    The draw is made on the generator's device and moved.
    ``method='zeros'`` gives a cold start (no randomness drawn).
    """
    device = resolve_device(device)
    if method == "zeros":
        return torch.zeros((n, shape.num_links), dtype=torch.float32,
                           device=device)
    if method != "uniform":
        raise ValueError(f"method={method!r}")
    u = torch.rand((n, shape.num_links), generator=generator,
                   dtype=torch.float32,
                   device=generator.device if generator is not None
                   else device)
    return (u * TWO_PI - np.pi).to(device=device, dtype=torch.float32)


def typical_links(rng: np.random.Generator, n: int, lt: int, lx: int,
                  sigma: float = 0.5) -> np.ndarray:
    """``(n, lt, lx, 2)`` float32 near-equilibrium links, made with numpy.

    Normal link angles of width ``sigma`` (``<cos P> ~ 0.84`` at 0.3) under a
    uniform random gauge transformation g: ``u0 += g - g(t+1)``, ``u1 += g -
    g(s+1)`` leaves every plaquette unchanged and spreads the link angles
    over the circle as in an equilibrium ensemble, where trained
    conditioners accept (on near-zero links they reject everything).
    """
    a = rng.normal(0.0, sigma, (n, lt, lx, 2))
    g = rng.uniform(-np.pi, np.pi, (n, lt, lx))
    a[..., 0] += g - np.roll(g, -1, axis=1)
    a[..., 1] += g - np.roll(g, -1, axis=2)
    return (a - TWO_PI * np.floor((a + np.pi) / TWO_PI)).astype(np.float32)


def wilson_loop_sums(links: torch.Tensor, r: int, t: int) -> torch.Tensor:
    """Angle around every ``t x r`` (time x space) Wilson loop: the box sum
    of the enclosed plaquette angles (abelian Stokes)."""
    p = plaq_sums(links)
    box = torch.zeros_like(p)
    for i in range(t):
        for j in range(r):
            box = box + torch.roll(p, shifts=(-i, -j), dims=(-2, -1))
    return box


def wilson_loop(links: torch.Tensor, r: int, t: int) -> torch.Tensor:
    """Per-sample ``<W(t x r)> = <cos(loop angle)>``."""
    return torch.mean(torch.cos(wilson_loop_sums(links, r, t)), dim=(-2, -1))


def observables(x: torch.Tensor, shape: LatticeShape, beta=None):
    """{actions, plaqs, charges[, plaqs_exact]} from one plaquette pass."""
    p = plaq_sums(to_links(x, shape))
    cos_p = torch.cos(p)
    out = {
        "actions": torch.sum(1.0 - cos_p, dim=(-2, -1)),
        "plaqs": torch.mean(cos_p, dim=(-2, -1)),
        "charges": torch.round(
            torch.sum(project_angle(p), dim=(-2, -1)) / TWO_PI),
    }
    if beta is not None:
        out["plaqs_exact"] = u1_plaq_exact(beta)
    return out


# ---------------------------------------------------------------------------
# Exact oracles (numpy / scipy)
# ---------------------------------------------------------------------------


def u1_plaq_exact(beta) -> float:
    """Infinite-volume average plaquette ``I1(beta)/I0(beta)``."""
    return float(i1e(beta) / i0e(beta))


def wilson_loop_exact(beta, area: int) -> float:
    """Exact 2-D area law ``<W> = (I1/I0)^area`` (infinite volume)."""
    return u1_plaq_exact(beta) ** area


def topological_susceptibility_exact(
    beta: float, num_plaq: int, qmax: int | None = None,
    n_phi: int = 4097, n_k: int = 20001,
) -> float:
    """Exact finite-volume ``<Q^2>`` of 2-D U(1) Wilson theory by quadrature.

    The plaquette angles are iid under ``exp(beta cos phi)`` subject to the
    global constraint ``sum_p proj(phi_p) = 2 pi Q``, so ``P(Q)`` is the
    V-fold convolution of the one-plaquette density on ``2 pi Z``.
    """
    phi = np.linspace(-np.pi, np.pi, n_phi)
    w = np.exp(beta * (np.cos(phi) - 1.0))        # scaled: overflow-safe
    c0 = np.trapezoid(w, phi)
    sig2 = np.trapezoid(phi * phi * w, phi) / c0  # single-plaquette <phi^2>
    v = float(num_plaq)
    k_max = 10.0 / np.sqrt(sig2 * v) + 2.0
    k = np.linspace(0.0, k_max, n_k)
    chat = np.empty_like(k)
    for lo in range(0, n_k, 2048):                # chunked: O(MB) not O(GB)
        kk = k[lo:lo + 2048]
        chat[lo:lo + 2048] = np.trapezoid(
            w[None, :] * np.cos(np.outer(kk, phi)), phi, axis=1) / c0
    pow_v = np.real((chat.astype(np.complex128)) ** num_plaq)
    if qmax is None:
        qmax = int(np.ceil(5.0 * np.sqrt(sig2 * v) / (2.0 * np.pi)) + 3)
    qs = np.arange(-qmax, qmax + 1)
    probs = np.array(
        [np.trapezoid(pow_v * np.cos(2.0 * np.pi * q * k), k) for q in qs])
    probs = np.maximum(probs, 0.0)
    return float(np.sum(qs * qs * probs) / np.sum(probs))
