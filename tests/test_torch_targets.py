"""PyTorch port, ``l2hmc_tpu_torch/targets``, against ``l2hmc_tpu.targets``.

Each target is built on both sides from the same numbers (the same sigma
for a Gaussian), and evaluated on the same numpy-seeded points.

Tolerances: energies and log densities rtol 1e-5 (float32 on both sides,
different summation order and libm).  The SCG covariance has condition
number 1e4: JAX forms its precision matrix in float32 (~2e-4 relative
error), the port in float64 rounded to float32, so there both are held to
the float64 energy of the same sigma, the port within 1e-5 of the size of
the quadratic form's terms (its float32 cancellation), JAX within 1e-3.
Exact moments (means, covariances, weights, log constants) rtol 1e-5;
the port's exact samplers against those moments within 5 standard errors
of 20000 draws.
"""

import math

import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as J
from l2hmc_tpu_torch import targets as T

torch.set_num_threads(1)

RTOL = 1e-5


def _spd(dim, seed, cond=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    lam = np.geomspace(1.0, cond, dim)
    return ((q * lam) @ q.T).astype(np.float32)


# name -> (JAX target, port target, dim)
TARGETS = {
    "gaussian": lambda: (J.Gaussian.create(np.full(3, 0.5, np.float32),
                                           _spd(3, 1)),
                         T.Gaussian.create(np.full(3, 0.5, np.float32),
                                           _spd(3, 1), "cpu"), 3),
    "gmm_axes": lambda: (J.gmm_axes(2), T.gmm_axes(2, device="cpu"), 2),
    "gmm_single_axis": lambda: (J.gmm_single_axis(3, sep=1.5, var=0.2),
                                T.gmm_single_axis(3, sep=1.5, var=0.2,
                                                  device="cpu"), 3),
    "gmm_one_per_axis": lambda: (J.gmm_one_per_axis(3, num_modes=4),
                                 T.gmm_one_per_axis(3, num_modes=4,
                                                    device="cpu"), 3),
    "gmm_diagonal": lambda: (J.gmm_diagonal(2), T.gmm_diagonal(2,
                                                               device="cpu"),
                             2),
    "gen_ring": lambda: (J.gen_ring(r=1.0, var=0.1, nb_mixtures=4),
                         T.gen_ring(r=1.0, var=0.1, nb_mixtures=4,
                                    device="cpu"), 2),
    "rough_well": lambda: (J.RoughWell(dim=3, eps=0.1),
                           T.RoughWell(dim=3, eps=0.1), 3),
    "rough_well_easy": lambda: (J.RoughWell(dim=3, eps=0.1, easy=True),
                                T.RoughWell(dim=3, eps=0.1, easy=True), 3),
    "funnel": lambda: (J.GaussianFunnel(dim=4), T.GaussianFunnel(dim=4), 4),
}


def _points(dim, seed=0, n=64, scale=1.5):
    x = np.random.default_rng(seed).standard_normal((n, dim)) * scale
    if dim == 4:
        # the funnel's clipped regions, |v| > 8, both sides
        x[:4, 0] = [9.0, -9.0, 8.5, -12.0]
    return x.astype(np.float32)


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_torch_target_energy_and_density_match_jax(name):
    jt, tt, dim = TARGETS[name]()
    x = _points(dim)
    np.testing.assert_allclose(tt.energy(torch.from_numpy(x)).numpy(),
                               np.asarray(jt.energy(x)), rtol=RTOL,
                               atol=RTOL)
    if hasattr(jt, "log_density"):
        np.testing.assert_allclose(
            tt.log_density(torch.from_numpy(x)).numpy(),
            np.asarray(jt.log_density(x)), rtol=RTOL, atol=RTOL)


def test_torch_scg_energy_against_float64():
    jt, tt = J.scg_2d(), T.scg_2d(device="cpu")
    np.testing.assert_array_equal(tt.sigma.numpy(), np.asarray(jt.sigma))
    sigma = np.asarray(jt.sigma, np.float64)
    prec = np.linalg.inv(sigma)
    x = _points(2, seed=3, scale=6.0).astype(np.float64)
    exact = 0.5 * np.einsum("ni,ij,nj->n", x, prec, x)
    terms = 0.5 * np.einsum("ni,ij,nj->n", np.abs(x), np.abs(prec),
                            np.abs(x))
    got = tt.energy(torch.from_numpy(x.astype(np.float32))).numpy()
    assert np.all(np.abs(got - exact) <= RTOL * terms)
    want = np.asarray(jt.energy(x.astype(np.float32)))
    assert np.all(np.abs(want - exact) <= 1e-3 * terms)
    np.testing.assert_allclose(tt.prec.numpy(), prec, rtol=1e-6)
    log_norm = 0.5 * (2 * math.log(2 * math.pi)
                      + np.linalg.slogdet(sigma)[1])
    assert abs(float(tt.log_norm) - log_norm) <= RTOL * log_norm
    assert abs(float(jt.log_norm) - log_norm) <= 1e-3 * log_norm


def _gmm_moments(mus, sigmas, pis):
    mus, sigmas, pis = (np.asarray(a, np.float64) for a in (mus, sigmas, pis))
    mean = pis @ mus
    second = np.einsum("k,kij->ij", pis, sigmas + np.einsum("ki,kj->kij", mus,
                                                             mus))
    return mean, second - np.outer(mean, mean)


@pytest.mark.parametrize("name", [n for n in sorted(TARGETS)
                                  if n.startswith(("gmm", "gen_ring"))])
def test_torch_gmm_exact_moments_match_jax(name):
    jt, tt, _ = TARGETS[name]()
    for field in ("mus", "sigmas", "precs", "chols", "pis", "log_consts"):
        np.testing.assert_allclose(getattr(tt, field).numpy(),
                                   np.asarray(getattr(jt, field)),
                                   rtol=RTOL, atol=1e-6, err_msg=field)
    for got, want in zip(_gmm_moments(tt.mus, tt.sigmas, tt.pis),
                         _gmm_moments(jt.mus, jt.sigmas, jt.pis)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def _within_se(samples, mean, cov, n_se=5.0):
    n = samples.shape[0]
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(samples.mean(0) - mean) <= n_se * sd / math.sqrt(n))
    # the variance of a sample variance: (m4 - sd^4) / n, m4 from the draws
    dev = samples - samples.mean(0)
    se_var = np.sqrt(np.maximum((dev ** 4).mean(0) - sd ** 4, 1e-12) / n)
    assert np.all(np.abs(dev.var(0) - sd ** 2) <= n_se * se_var)


@pytest.mark.parametrize("name", ["gaussian", "gmm_one_per_axis", "gen_ring",
                                  "gmm_diagonal"])
def test_torch_target_samples_have_the_exact_moments(name):
    jt, tt, _ = TARGETS[name]()
    gen = torch.Generator().manual_seed(11)
    x = tt.sample(gen, 20000).numpy().astype(np.float64)
    if name == "gaussian":
        mean, cov = np.asarray(jt.mu), np.asarray(jt.sigma, np.float64)
    else:
        mean, cov = _gmm_moments(jt.mus, jt.sigmas, jt.pis)
    _within_se(x, mean, cov)


def test_torch_funnel_and_rough_well_samplers():
    gen = torch.Generator().manual_seed(12)
    v = T.GaussianFunnel(dim=3).sample(gen, 20000).numpy()
    _within_se(v[:, :1].astype(np.float64), np.zeros(1), np.eye(1) * 4.0)
    assert v.shape == (20000, 3) and np.isfinite(v).all()
    r = T.RoughWell(dim=2, eps=0.1).sample(gen, 100)
    assert r.shape == (100, 2)


def test_torch_random_tilted_gaussian():
    """The port draws from a CPU generator seeded with the integer (not
    ``jax.random``): the same matrix for a seed on every device, symmetric,
    with eigenvalues in 10^[-2, 2] (+1e-6); JAX's draws another one of the
    same family."""
    a = T.random_tilted_gaussian(5, 4, device="cpu")
    b = T.random_tilted_gaussian(5, 4, device="cpu")
    c = T.random_tilted_gaussian(6, 4, device="cpu")
    torch.testing.assert_close(a.sigma, b.sigma, rtol=0, atol=0)
    assert not torch.equal(a.sigma, c.sigma)
    s = a.sigma.double().numpy()
    np.testing.assert_allclose(s, s.T, atol=1e-5)
    lam = np.linalg.eigvalsh(s)
    assert lam.min() > 1e-2 * (1 - 1e-4) and lam.max() < 1e2 * (1 + 1e-4)
    j = J.random_tilted_gaussian(5, 4)
    lam_j = np.linalg.eigvalsh(np.asarray(j.sigma, np.float64))
    assert lam_j.min() > 1e-2 * (1 - 1e-4) and lam_j.max() < 1e2 * (1 + 1e-4)
    # and its energy is the quadratic form of its own sigma, as JAX's is
    x = _points(4, seed=4)
    want = J.quadratic_gaussian(x, np.zeros(4, np.float32),
                                np.linalg.inv(s).astype(np.float32))
    np.testing.assert_allclose(a.energy(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-4)


def test_torch_targets_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (T.scg_2d, lambda: T.gmm_axes(2), lambda: T.gen_ring()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
