"""Analytic target distributions (port of
``l2hmc_tpu/targets/distributions.py``).

Gaussian, random tilted (strongly-correlated) Gaussian, rough well,
Gaussian mixture, Gaussian funnel, ring of Gaussians.  Each target holds
its tensors on one device and exposes

- ``energy(x)``      per-sample energy, ``(batch,)`` for ``x (batch, d)``
- ``log_density(x)`` exact log density where tractable
- ``sample(generator, n)`` exact samples where tractable, drawn on the
  generator's device

in float32.  The constructors create tensors from nothing, so they take
``device=None`` to mean this process's CUDA device
(``_device.resolve_device``).

The inverse, Cholesky factor and log-determinant of a covariance are
formed in float64 and rounded to float32.  JAX forms them in float32, which
at the SCG covariance's condition number of 1e4 puts ~2e-4 of relative
error into its precision matrix; here it is ~1e-7.

``random_tilted_gaussian`` draws its rotation and spectrum from a CPU
``torch.Generator`` seeded with the integer: the matrix is the same on
every device, but not the one ``jax.random`` draws for that seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from l2hmc_tpu_torch._device import resolve_device

_F32 = torch.float32


def _factors(sigma: torch.Tensor):
    """``(inverse, cholesky, log det)`` of a float32 covariance (or stack
    of them), formed in float64 and returned in float32."""
    s64 = sigma.to(torch.float64)
    _, logdet = torch.linalg.slogdet(s64)
    return (torch.linalg.inv(s64).to(_F32),
            torch.linalg.cholesky(s64).to(_F32), logdet.to(_F32))


def quadratic_gaussian(x: torch.Tensor, mu: torch.Tensor,
                       prec: torch.Tensor) -> torch.Tensor:
    """``0.5 (x-mu)^T prec (x-mu)`` per sample: one product and a rowwise
    dot."""
    d = x - mu
    return 0.5 * torch.sum((d @ prec) * d, dim=-1)


class Gaussian:
    """Multivariate Gaussian: mean ``mu (d,)``, covariance ``sigma (d, d)``,
    its inverse, Cholesky factor and ``log_norm = 0.5 (d log 2 pi + log det
    sigma)``."""

    def __init__(self, mu, sigma, prec, chol, log_norm):
        self.mu, self.sigma, self.prec = mu, sigma, prec
        self.chol, self.log_norm = chol, log_norm

    @classmethod
    def create(cls, mu, sigma, device=None) -> "Gaussian":
        device = resolve_device(device)
        mu = torch.as_tensor(np.asarray(mu, np.float32), device=device)
        sigma = torch.as_tensor(np.asarray(sigma, np.float32), device=device)
        prec, chol, logdet = _factors(sigma)
        log_norm = 0.5 * (mu.shape[-1] * math.log(2 * math.pi) + logdet)
        return cls(mu, sigma, prec, chol, log_norm)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return quadratic_gaussian(x, self.mu, self.prec)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy(x) - self.log_norm

    def sample(self, generator, n: int) -> torch.Tensor:
        z = torch.randn((n, self.mu.shape[-1]), generator=generator,
                        dtype=_F32, device=generator.device)
        return self.mu.to(z.device) + z @ self.chol.to(z.device).T


def random_tilted_gaussian(seed: int, dim: int, log_min: float = -2.0,
                           log_max: float = 2.0, device=None) -> Gaussian:
    """Rotated ill-conditioned Gaussian, the paper's strongly-correlated
    target: eigenvalues log-uniform in ``10^[log_min, log_max]``, rotated by
    a Haar-random orthogonal matrix (QR of a Gaussian matrix, signs fixed),
    both drawn from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    a = torch.randn((dim, dim), generator=gen, dtype=_F32)
    u = torch.rand((dim,), generator=gen, dtype=_F32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    lam = torch.exp(math.log(10.0) * (log_min + (log_max - log_min) * u))
    sigma = (q.T * lam) @ q + 1e-6 * torch.eye(dim)
    return Gaussian.create(np.zeros(dim, np.float32), sigma.numpy(), device)


def scg_2d(device=None) -> Gaussian:
    """The canonical 2-D strongly-correlated Gaussian of the L2HMC paper:
    covariance eigenvalues {100, 0.01} rotated 45 degrees."""
    theta = np.pi / 4
    r = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]], dtype=np.float32)
    sigma = r @ np.diag(np.array([100.0, 0.01], np.float32)) @ r.T
    return Gaussian.create(np.zeros(2, np.float32), sigma, device)


class RoughWell:
    """Quadratic well plus fast cosine ripples:
    ``0.5 |x|^2 + eps sum cos(x / scale)``, ``scale = eps`` (easy) or
    ``eps^2``."""

    def __init__(self, dim: int, eps: float, easy: bool = False):
        self.dim, self.eps, self.easy = dim, eps, easy

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.sum(torch.square(x), dim=-1)
        scale = self.eps if self.easy else self.eps * self.eps
        return 0.5 * n + self.eps * torch.sum(torch.cos(x / scale), dim=-1)

    def sample(self, generator, n: int) -> torch.Tensor:
        # the Gaussian approximation, valid for small eps
        return torch.randn((n, self.dim), generator=generator, dtype=_F32,
                           device=generator.device)


class GMM:
    """Gaussian mixture with exact sampling and log density: the
    components stacked on a leading axis, their energies one batched
    product and a ``torch.logsumexp``."""

    def __init__(self, mus, sigmas, precs, chols, pis, log_consts):
        self.mus, self.sigmas, self.precs = mus, sigmas, precs
        self.chols, self.pis, self.log_consts = chols, pis, log_consts

    @classmethod
    def create(cls, mus, sigmas, pis, device=None) -> "GMM":
        device = resolve_device(device)
        mus = torch.as_tensor(np.asarray(mus, np.float32), device=device)
        sigmas = torch.as_tensor(np.asarray(sigmas, np.float32),
                                 device=device)
        pis = torch.as_tensor(np.asarray(pis, np.float32), device=device)
        pis = pis / torch.sum(pis)
        d = mus.shape[-1]
        precs, chols, logdets = _factors(sigmas)
        log_consts = torch.log(pis) - 0.5 * (d * math.log(2 * math.pi)
                                             + logdets)
        return cls(mus, sigmas, precs, chols, pis, log_consts)

    def _component_logps(self, x: torch.Tensor) -> torch.Tensor:
        d = x[..., None, :] - self.mus                    # (..., k, d)
        quad = 0.5 * torch.einsum("...ki,kij,...kj->...k", d, self.precs, d)
        return self.log_consts - quad

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return -torch.logsumexp(self._component_logps(x), dim=-1)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy(x)

    def sample(self, generator, n: int) -> torch.Tensor:
        dev = generator.device
        comp = torch.multinomial(self.pis.to(dev), n, replacement=True,
                                 generator=generator)
        z = torch.randn((n, self.mus.shape[-1]), generator=generator,
                        dtype=_F32, device=dev)
        mu = self.mus.to(dev)[comp]
        chol = self.chols.to(dev)[comp]
        return mu + torch.einsum("nij,nj->ni", chol, z)


class GaussianFunnel:
    """Neal's funnel, its energy clipped beyond ``|v| > clip`` for
    stability."""

    def __init__(self, dim: int, sigma: float = 2.0, clip: float = 8.0):
        self.dim, self.sigma, self.clip = dim, sigma, clip

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        v = x[..., 0]
        log_p_v = torch.square(v / self.sigma)
        sum_sq = torch.sum(torch.square(x[..., 1:]), dim=-1)
        n = x.shape[-1] - 1

        def e_at(scale):
            return 0.5 * (log_p_v + sum_sq / scale
                          + n * torch.log(2.0 * math.pi * scale))

        clip = torch.full_like(v, self.clip)
        e = e_at(torch.exp(v))
        e = torch.where(v > self.clip, e_at(torch.exp(clip)), e)
        return torch.where(v < -self.clip, e_at(torch.exp(-clip)), e)

    def sample(self, generator, n: int) -> torch.Tensor:
        # v ~ sigma N(0, 1), x_{1:} ~ exp(v / 2) N(0, 1)
        kw = dict(generator=generator, dtype=_F32, device=generator.device)
        v = self.sigma * torch.randn((n, 1), **kw)
        z = torch.randn((n, self.dim - 1), **kw)
        return torch.cat([v, torch.exp(v / 2.0) * z], dim=-1)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy(x)


def gen_ring(r: float = 1.0, var: float = 1.0, nb_mixtures: int = 2,
             device=None) -> GMM:
    """Ring of equally-weighted Gaussians."""
    t = np.arange(nb_mixtures)
    mus = np.stack([r * np.cos(2 * np.pi * t / nb_mixtures),
                    r * np.sin(2 * np.pi * t / nb_mixtures)],
                   axis=-1).astype(np.float32)
    sigmas = np.tile(var * np.eye(2, dtype=np.float32), (nb_mixtures, 1, 1))
    pis = np.full((nb_mixtures,), 1.0 / nb_mixtures, np.float32)
    return GMM.create(mus, sigmas, pis, device)


def gmm_axes(dim: int, sep: float = 2.0, var: float = 0.1,
             device=None) -> GMM:
    """Two components separated along the first axis: the reference's
    ``single_axis`` arrangement under its round-1 name (the reference's
    ``axes`` arrangement is :func:`gmm_one_per_axis`)."""
    return gmm_single_axis(dim, sep=sep, var=var, device=device)


def gmm_single_axis(dim: int, sep: float = 2.0, var: float = 0.1,
                    device=None) -> GMM:
    """A pair of Gaussians at ``+-sep`` on the first axis."""
    mus = np.zeros((2, dim), np.float32)
    mus[0, 0] = sep
    mus[1, 0] = -sep
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (2, 1, 1))
    return GMM.create(mus, sigmas, np.array([0.5, 0.5], np.float32), device)


def gmm_one_per_axis(dim: int, sep: float = 2.0, var: float = 0.1,
                     num_modes: int = 0, device=None) -> GMM:
    """One Gaussian at ``sep`` on each coordinate axis (with ``num_modes <
    dim`` the first axes; more modes reuse the axes cyclically)."""
    num_modes = num_modes or dim
    mus = np.zeros((num_modes, dim), np.float32)
    for i in range(num_modes):
        mus[i, i % dim] = sep
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (num_modes, 1, 1))
    pis = np.full((num_modes,), 1.0 / num_modes, np.float32)
    return GMM.create(mus, sigmas, pis, device)


def gmm_diagonal(dim: int, sep: float = 2.0, var: float = 0.1,
                 device=None) -> GMM:
    """A pair of Gaussians at ``+-sep (1, ..., 1)``."""
    mus = np.stack([np.full((dim,), sep, np.float32),
                    np.full((dim,), -sep, np.float32)])
    sigmas = np.tile(var * np.eye(dim, dtype=np.float32), (2, 1, 1))
    return GMM.create(mus, sigmas, np.array([0.5, 0.5], np.float32), device)
