"""PyTorch port, lattice/u1.py: observables and oracles against the JAX package.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
both sides compute in float32 with different libm sin/cos, so elementwise
results agree to a few float32 ulp of the reduced sums (atol 1e-5 on sums of
up to 64 terms of O(1)); the numpy/scipy oracles are float64 against JAX's
float32 (rtol 1e-6), and the quadrature oracle is the same numpy code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu_torch.lattice import u1 as tu1

torch.set_num_threads(1)

ATOL = 1e-5


def _links(seed, b=4, lt=4, lx=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)).astype(np.float32)


@pytest.mark.parametrize("name", [
    "plaq_sums", "wilson_action", "avg_plaquette", "topological_charge"])
def test_torch_links_observable_matches_jax(name):
    links = _links(0)
    want = np.asarray(getattr(ju1, name)(jnp.asarray(links)))
    got = getattr(tu1, name)(torch.from_numpy(links)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("r,t", [(1, 1), (2, 2), (3, 1)])
def test_torch_wilson_loop_matches_jax(r, t):
    links = _links(1)
    want = np.asarray(ju1.wilson_loop(jnp.asarray(links), r, t))
    got = tu1.wilson_loop(torch.from_numpy(links), r, t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_torch_wrap_and_project_angle_match_jax():
    x = np.random.default_rng(2).uniform(-20, 20, (64,)).astype(np.float32)
    want = np.asarray(ju1.wrap(jnp.asarray(x)))
    got = tu1.wrap(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got.min() >= -np.pi and got.max() < np.pi
    np.testing.assert_allclose(tu1.project_angle(torch.from_numpy(x)).numpy(),
                               got, atol=0)


def test_torch_observables_match_jax():
    shape_j = ju1.LatticeShape(4, 6)
    shape_t = tu1.LatticeShape(4, 6)
    x = _links(3).reshape(4, -1)
    want = ju1.observables(jnp.asarray(x), shape_j, beta=2.0)
    got = tu1.observables(torch.from_numpy(x), shape_t, beta=2.0)
    assert set(got) == set(want)
    for k in ("actions", "plaqs", "charges"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL)
    np.testing.assert_allclose(got["plaqs_exact"], float(want["plaqs_exact"]),
                               rtol=1e-6)


def test_torch_shape_and_layout_helpers():
    s = tu1.LatticeShape(4, 6)
    j = ju1.LatticeShape(4, 6)
    for attr in ("links_shape", "num_links", "num_plaquettes", "x_dim"):
        assert getattr(s, attr) == getattr(j, attr)
    x = torch.arange(3 * s.num_links, dtype=torch.float32).reshape(3, -1)
    links = tu1.to_links(x, s)
    assert links.shape == (3, 4, 6, 2)
    # interleaved flat index (t*Lx + s)*2 + mu
    assert float(links[0, 1, 2, 1]) == float((1 * 6 + 2) * 2 + 1)
    assert torch.equal(tu1.to_flat(links), x)


@pytest.mark.parametrize("beta", [0.5, 2.0, 4.0])
def test_torch_exact_oracles_match_jax(beta):
    np.testing.assert_allclose(tu1.u1_plaq_exact(beta),
                               float(ju1.u1_plaq_exact(beta)), rtol=1e-6)
    np.testing.assert_allclose(tu1.wilson_loop_exact(beta, 4),
                               float(ju1.wilson_loop_exact(beta, 4)),
                               rtol=1e-5)


def test_torch_topological_susceptibility_exact_matches_jax():
    got = tu1.topological_susceptibility_exact(4.0, 64, n_phi=1025,
                                               n_k=4001)
    want = ju1.topological_susceptibility_exact(4.0, 64, n_phi=1025,
                                                n_k=4001)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.0 < got < 64.0


def test_torch_random_links_generator_driven():
    s = tu1.LatticeShape(4, 4)
    a = tu1.random_links(torch.Generator().manual_seed(5), 8, s,
                         device="cpu")
    b = tu1.random_links(torch.Generator().manual_seed(5), 8, s,
                         device="cpu")
    assert torch.equal(a, b)
    assert a.shape == (8, s.num_links) and a.dtype == torch.float32
    assert float(a.min()) >= -np.pi and float(a.max()) < np.pi
    cold = tu1.random_links(None, 3, s, method="zeros", device="cpu")
    assert torch.equal(cold, torch.zeros(3, s.num_links))
