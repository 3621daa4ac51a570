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


def _charge(x, shape, proj, sharding):
    """``Q = sum proj(P) / 2pi`` per chain of flat states (sharded: of the
    whole lattice, from this rank's slabs)."""
    q = torch.sum(proj(state_plaqs(x, shape, sharding)), dim=(-2, -1))
    return chain_total(q, sharding) / TWO_PI


def charge_diff(x1: torch.Tensor, x2: torch.Tensor,
                shape: LatticeShape, sharding=None) -> torch.Tensor:
    """``|Q(x1) - Q(x2)|`` of flat states with the exact projection; with
    a ``sharding`` (``parallel/spatial.py``), of this rank's slabs."""
    return torch.abs(_charge(x1, shape, project_angle, sharding)
                     - _charge(x2, shape, project_angle, sharding))


def charge_diff_approx(x1: torch.Tensor, x2: torch.Tensor,
                       shape: LatticeShape, n_terms: int = 5,
                       sharding=None) -> torch.Tensor:
    """``|Q(x1) - Q(x2)|`` with the differentiable surrogate (loss path);
    with a ``sharding``, of this rank's slabs (differentiable)."""
    def proj(p):
        return project_angle_approx(p, n_terms)

    return torch.abs(_charge(x1, shape, proj, sharding)
                     - _charge(x2, shape, proj, sharding))


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles into ``[-pi, pi)``."""
    return project_angle(x)


def rect_sums(links: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angle sums around the 2x1 (time-long) and 1x2 (space-long)
    rectangles, with the orientation of :func:`plaq_sums`::

        R_t(n) = u0(n) + u0(n+e0) + u1(n+2e0) - u0(n+e0+e1) - u0(n+e1) - u1(n)
        R_x(n) = u0(n) + u1(n+e0) + u1(n+e0+e1) - u0(n+2e1) - u1(n+e1) - u1(n)

    ``(..., Lt, Lx, 2)`` -> two ``(..., Lt, Lx)``.
    """
    u0 = links[..., 0]
    u1 = links[..., 1]

    def r(a, st, sx):
        return torch.roll(a, shifts=(-st, -sx), dims=(-2, -1))

    rect_t = u0 + r(u0, 1, 0) + r(u1, 2, 0) - r(u0, 1, 1) - r(u0, 0, 1) - u1
    rect_x = u0 + r(u1, 1, 0) + r(u1, 1, 1) - r(u0, 0, 2) - r(u1, 0, 1) - u1
    return rect_t, rect_x


def improved_action(links: torch.Tensor, c1: float = -1.0 / 12.0
                    ) -> torch.Tensor:
    """Tree-level Symanzik-improved action per sample:
    ``S = c0 sum(1 - cos P) + c1 sum(1 - cos R)`` over both rectangle
    orientations, ``c0 = 1 - 8 c1``; ``c1 = 0`` is :func:`wilson_action`."""
    c0 = 1.0 - 8.0 * c1
    s = c0 * torch.sum(1.0 - torch.cos(plaq_sums(links)), dim=(-2, -1))
    if c1 != 0.0:
        rect_t, rect_x = rect_sums(links)
        s = s + c1 * (torch.sum(1.0 - torch.cos(rect_t), dim=(-2, -1))
                      + torch.sum(1.0 - torch.cos(rect_x), dim=(-2, -1)))
    return s


def make_improved_potential_fn(shape: LatticeShape, c1: float = -1.0 / 12.0,
                               sharding=None):
    """``U(x) -> per-sample improved action`` on flat states.  It has no
    ``force``: the dynamics differentiate it by autograd, as the reference
    does with ``jax.grad``.  With a ``sharding``, ``x`` is this rank's slab
    and ``U`` the whole lattice's action (:func:`improved_action_slab`)."""
    if sharding is not None:
        sharding.check_shape(shape)

        def slab_potential(x: torch.Tensor) -> torch.Tensor:
            return improved_action_slab(slab_links(x, sharding), sharding,
                                        c1)

        return slab_potential

    def potential(x: torch.Tensor) -> torch.Tensor:
        return improved_action(to_links(x, shape), c1)

    return potential


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


def wilson_loop(links: torch.Tensor, r: int, t: int,
                sharding=None) -> torch.Tensor:
    """Per-sample ``<W(t x r)> = <cos(loop angle)>``; with a ``sharding``,
    ``links`` is this rank's slab and the mean the whole lattice's."""
    if sharding is None:
        loops = wilson_loop_sums(links, r, t)
    else:
        loops = wilson_loop_sums_slab(links, r, t, sharding)
    n = loops.shape[-2] * loops.shape[-1] * (sharding.n if sharding else 1)
    return chain_total(torch.sum(torch.cos(loops), dim=(-2, -1)),
                       sharding) / n


def creutz_ratio(w_rt, w_r1t1, w_r1t, w_rt1):
    """Creutz ratio ``chi = -log(W(R,T) W(R-1,T-1) / (W(R-1,T) W(R,T-1)))``:
    the string tension, exactly ``-log(I1/I0)`` per unit area in 2-D U(1).
    Tensors or floats (``torch.log`` of a float tensor of them)."""
    return -torch.log(torch.as_tensor(w_rt * w_r1t1 / (w_r1t * w_rt1)))


def observables(x: torch.Tensor, shape: LatticeShape, beta=None,
                sharding=None):
    """{actions, plaqs, charges[, plaqs_exact]} from one plaquette pass;
    with a ``sharding``, ``x`` is this rank's slab and each value the whole
    lattice's."""
    p = state_plaqs(x, shape, sharding)
    cos_p = torch.cos(p)
    sums = chain_total(torch.stack([
        torch.sum(1.0 - cos_p, dim=(-2, -1)),
        torch.sum(cos_p, dim=(-2, -1)),
        torch.sum(project_angle(p), dim=(-2, -1))]), sharding)
    out = {"actions": sums[0], "plaqs": sums[1] / shape.num_plaquettes,
           "charges": torch.round(sums[2] / TWO_PI)}
    if beta is not None:
        out["plaqs_exact"] = u1_plaq_exact(beta)
    return out


# ---------------------------------------------------------------------------
# Slab forms: one 'space' rank's time rows (parallel/spatial.py)
# ---------------------------------------------------------------------------
#
# ``sharding`` is a ``parallel.spatial.LatticeSharding`` bound to the
# lattice: this rank holds the time rows ``[t0, t0 + lt_blk)``.  Each form
# computes over the plaquettes (or loops) based in the owned rows, fetching
# the rows after the slab by a halo exchange, and adds its per-chain sums
# over 'space'.


def slab_links(x: torch.Tensor, sharding) -> torch.Tensor:
    """A flat slab ``(B, x_dim / n)`` as links ``(B, lt_blk, Lx, 2)``."""
    return x.reshape(x.shape[0], sharding.lt_blk, sharding.lx, 2)


def slab_plaq_sums(links: torch.Tensor, sharding,
                   extra: int = 0) -> torch.Tensor:
    """:func:`plaq_sums` of the owned plaquette rows and ``extra`` rows
    after them, ``(B, lt_blk + extra, Lx)``; the rows after the slab are
    the next slab's (a halo of ``extra + 1`` link rows; differentiable)."""
    ext = sharding.halo(links, 1, 0, extra + 1)
    u0, u1 = ext[:, :-1, :, 0], ext[..., 1]
    return u0 - u1[:, :-1] - torch.roll(u0, -1, dims=-1) + u1[:, 1:]


def state_links(x: torch.Tensor, shape: LatticeShape,
                sharding=None) -> torch.Tensor:
    """Flat states as links: the whole lattice's, or with a ``sharding``
    this rank's slab."""
    return to_links(x, shape) if sharding is None else slab_links(x,
                                                                  sharding)


def state_plaqs(x: torch.Tensor, shape: LatticeShape,
                sharding=None) -> torch.Tensor:
    """The plaquettes of flat states: all of them, or with a ``sharding``
    those based in this rank's rows."""
    links = state_links(x, shape, sharding)
    if sharding is None:
        return plaq_sums(links)
    return slab_plaq_sums(links, sharding)


def chain_total(t: torch.Tensor, sharding=None) -> torch.Tensor:
    """Per-chain sums of the whole lattice from this rank's: ``t`` itself,
    or with a ``sharding`` added over 'space' (differentiable)."""
    return t if sharding is None else sharding.space_sum(t)


def slab_rect_sums(links: torch.Tensor, sharding):
    """:func:`rect_sums` of the rectangles based in the owned rows (a halo
    of two rows after the slab)."""
    n = links.shape[1]
    ext = sharding.halo(links, 1, 0, 2)
    u0, u1 = ext[..., 0], ext[..., 1]

    def r(a, st, sx):
        return torch.roll(a[:, st:st + n], shifts=-sx, dims=-1)

    rect_t = (r(u0, 0, 0) + r(u0, 1, 0) + r(u1, 2, 0) - r(u0, 1, 1)
              - r(u0, 0, 1) - r(u1, 0, 0))
    rect_x = (r(u0, 0, 0) + r(u1, 1, 0) + r(u1, 1, 1) - r(u0, 0, 2)
              - r(u1, 0, 1) - r(u1, 0, 0))
    return rect_t, rect_x


def improved_action_slab(links: torch.Tensor, sharding,
                         c1: float = -1.0 / 12.0) -> torch.Tensor:
    """:func:`improved_action` of the whole lattice per chain from this
    rank's slab ``links (B, lt_blk, Lx, 2)`` (differentiable)."""
    c0 = 1.0 - 8.0 * c1
    s = c0 * torch.sum(1.0 - torch.cos(slab_plaq_sums(links, sharding)),
                       dim=(-2, -1))
    if c1 != 0.0:
        rect_t, rect_x = slab_rect_sums(links, sharding)
        s = s + c1 * (torch.sum(1.0 - torch.cos(rect_t), dim=(-2, -1))
                      + torch.sum(1.0 - torch.cos(rect_x), dim=(-2, -1)))
    return chain_total(s, sharding)


def wilson_loop_sums_slab(links: torch.Tensor, r: int, t: int,
                          sharding) -> torch.Tensor:
    """:func:`wilson_loop_sums` of the loops based in the owned rows (their
    plaquettes reach ``t - 1`` rows past the slab)."""
    n = links.shape[1]
    p = slab_plaq_sums(links, sharding, t - 1)
    box = torch.zeros_like(p[:, :n])
    for i in range(t):
        for j in range(r):
            box = box + torch.roll(p[:, i:i + n], shifts=-j, dims=-1)
    return box


# ---------------------------------------------------------------------------
# Exact oracles (numpy / scipy)
# ---------------------------------------------------------------------------


def u1_plaq_exact(beta) -> float:
    """Infinite-volume average plaquette ``I1(beta)/I0(beta)``."""
    return float(i1e(beta) / i0e(beta))


def log_z_exact_factorized(shape: LatticeShape, beta) -> float:
    """Absolute ``log Z(beta) = n_links log 2pi + n_plaq log(I0(beta)
    e^-beta)`` for the Lebesgue link measure on ``(-pi, pi]^{n_links}``
    (the plaquettes factorize up to the global-charge constraint)."""
    return float(shape.num_links * np.log(2.0 * np.pi)
                 + shape.num_plaquettes * np.log(i0e(beta)))


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
