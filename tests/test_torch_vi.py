"""PyTorch port, ``dynamics/vi.py`` (mean-field and full-rank Gaussian VI),
against ``l2hmc_tpu/dynamics/vi.py``.

The negative ELBO and its gradient on the same injected standard normals
(rtol 1e-5, float32 sums of 64 samples); a short fit on JAX's normals
replayed (``z = normal(k, (S, d))`` for each ``k`` of ``split(key,
num_steps)``; rtol 1e-4 after 20 Adam steps); then the oracles of the JAX
tests: full-rank VI recovers the strongly-correlated Gaussian's covariance,
mean-field VI an isotropic Gaussian's scales and log Z, and the samplers
draw from the fitted q.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import vi as jvi
from l2hmc_tpu_torch import targets as T
from l2hmc_tpu_torch.dynamics import vi as tvi

torch.set_num_threads(1)

SCALES = np.array([1.0, 4.0, 0.25], np.float32)


def _energies():
    s = SCALES
    return (lambda x: 0.5 * jnp.sum(s * x * x, axis=-1),
            lambda x: 0.5 * torch.sum(torch.from_numpy(s) * x * x, dim=-1))


def _params(kind, rng):
    if kind == "meanfield":
        mu, ls = rng.standard_normal((2, 3)).astype(np.float32) * 0.5
        return jvi.MeanFieldParams(mu, ls), tvi.MeanFieldParams(
            *(torch.tensor(a, requires_grad=True) for a in (mu, ls)))
    mu = rng.standard_normal(3).astype(np.float32)
    raw = (np.eye(3) + 0.3 * rng.standard_normal((3, 3))).astype(np.float32)
    return jvi.FullRankParams(mu, raw), tvi.FullRankParams(
        *(torch.tensor(a, requires_grad=True) for a in (mu, raw)))


def _jax_neg_elbo(kind, p, energy, z):
    if kind == "meanfield":
        x = p.mu + jnp.exp(p.log_sigma) * z
        return jnp.mean(energy(x)) - jvi._entropy_diag(p.log_sigma)
    chol = jvi._chol_from_raw(p.chol_raw)
    x = p.mu + z @ chol.T
    ent = 1.5 * (1.0 + jnp.log(2 * jnp.pi)) + jnp.sum(
        jnp.log(jnp.diagonal(chol)))
    return jnp.mean(energy(x)) - ent


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_torch_vi_neg_elbo_and_gradient_match_jax(kind):
    rng = np.random.default_rng(0)
    jp, tp = _params(kind, rng)
    z = rng.standard_normal((64, 3)).astype(np.float32)
    je, te = _energies()
    want, jg = jax.value_and_grad(
        lambda p: _jax_neg_elbo(kind, p, je, z))(jp)
    fn = tvi.meanfield_neg_elbo if kind == "meanfield" else \
        tvi.fullrank_neg_elbo
    got = fn(tp, te, torch.from_numpy(z))
    tg = torch.autograd.grad(got, list(tp))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    if kind == "fullrank":
        np.testing.assert_allclose(
            tvi._chol_from_raw(torch.from_numpy(jp.chol_raw)).numpy(),
            np.asarray(jvi._chol_from_raw(jp.chol_raw)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_torch_vi_fit_replays_jax(kind):
    je, te = _energies()
    key = jax.random.PRNGKey(3)
    n, s = 20, 16
    jfit = jvi.fit_meanfield if kind == "meanfield" else jvi.fit_fullrank
    tfit = tvi.fit_meanfield if kind == "meanfield" else tvi.fit_fullrank
    jp, jel = jfit(je, 3, key, num_steps=n, num_samples=s, lr=5e-2)
    normals = torch.stack([torch.tensor(np.asarray(
        jax.random.normal(k, (s, 3)))) for k in jax.random.split(key, n)])
    tp, tel = tfit(te, 3, num_steps=n, num_samples=s, lr=5e-2,
                   normals=normals)
    np.testing.assert_allclose(tel.numpy(), np.asarray(jel), rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_torch_vi_fullrank_recovers_scg_covariance():
    """The strongly-correlated Gaussian (kappa 1e4): correlation ~1 and the
    covariance within 20%, as the JAX oracle test."""
    target = T.scg_2d("cpu")
    params, _ = tvi.fit_fullrank(target.energy, 2,
                                 torch.Generator().manual_seed(0),
                                 num_steps=12000, num_samples=128, lr=3e-2,
                                 device="cpu")
    cov = tvi.fullrank_covariance(params).numpy()
    np.testing.assert_allclose(cov, target.sigma.numpy(), rtol=0.2,
                               atol=0.3)
    assert cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1]) > 0.95
    s = tvi.fullrank_sample(params, torch.Generator().manual_seed(1), 40000)
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, rtol=0.05,
                               atol=0.05)


def test_torch_vi_meanfield_isotropic_and_sampler():
    _, te = _energies()
    params, elbos = tvi.fit_meanfield(te, 3, torch.Generator().manual_seed(0),
                                      num_steps=1500, device="cpu")
    np.testing.assert_allclose(torch.exp(params.log_sigma).numpy(),
                               1.0 / np.sqrt(SCALES), rtol=0.1)
    np.testing.assert_allclose(params.mu.numpy(), 0.0, atol=0.1)
    log_z = 0.5 * float(np.sum(np.log(2 * np.pi / SCALES)))
    assert float(elbos[-100:].mean()) == pytest.approx(log_z, abs=0.1)
    s = tvi.meanfield_sample(params, torch.Generator().manual_seed(2), 20000)
    np.testing.assert_allclose(s.var(dim=0).numpy(), 1.0 / SCALES, rtol=0.15)
