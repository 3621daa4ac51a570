"""PyTorch port, lattice/metropolis.py against JAX.

``_partial_plaqs`` and ``local_action`` on the same numpy-made links; one
``metropolis_sweep`` with JAX's own draws replayed (the ``(prop, u)`` pair of
each ``(mu, parity)`` sub-sweep, split from the key as metropolis.py does);
and the port's ``thermalize`` and ``metropolis_chain`` against the exact
plaquette I1(beta)/I0(beta).

Tolerances: the remainders are sums of the same float32 terms in the same
order, so they agree exactly; the local action and the swept links (atol
1e-6) differ only by the two libraries' cos; the plaquette check allows 0.02
as tests/test_samplers.py does (statistical error ~0.003 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.lattice import metropolis as jmet
from l2hmc_tpu_torch.lattice import metropolis as tmet
from l2hmc_tpu_torch.lattice import u1 as tu1

torch.set_num_threads(1)


def _links(seed, b=3, lt=4, lx=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (b, lt, lx, 2)).astype(np.float32)


@pytest.mark.parametrize("mu", [0, 1])
def test_torch_local_action_matches_jax(mu):
    links = _links(1)
    theta = np.random.default_rng(2).uniform(
        -np.pi, np.pi, links.shape[:-1]).astype(np.float32)
    for w, g in zip(jmet._partial_plaqs(jnp.asarray(links), mu),
                    tmet._partial_plaqs(torch.from_numpy(links), mu)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jmet.local_action(jnp.asarray(links), mu, jnp.asarray(theta))
    got = tmet.local_action(torch.from_numpy(links), mu,
                            torch.from_numpy(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _jax_sweep_draws(key, shape, proposal_scale):
    """The (prop, u) of each sub-sweep, drawn as metropolis_sweep draws
    them: ``key, kp, ka = split(key, 3)`` per (mu, parity)."""
    draws = []
    for _ in range(4):
        key, kp, ka = jax.random.split(key, 3)
        prop = jax.random.uniform(kp, shape, minval=-proposal_scale,
                                  maxval=proposal_scale)
        u = jax.random.uniform(ka, shape)
        draws.append((torch.from_numpy(np.array(prop)),
                      torch.from_numpy(np.array(u))))
    return draws


@pytest.mark.parametrize("beta,scale", [(2.0, 1.0), (4.0, 0.5)])
def test_torch_metropolis_sweep_replays_jax(beta, scale):
    links = _links(3, b=4, lt=6, lx=6)
    key = jax.random.PRNGKey(11)
    want, want_acc = jmet.metropolis_sweep(jnp.asarray(links), beta, key,
                                           scale)
    draws = _jax_sweep_draws(key, links.shape[:-1], scale)
    src = torch.from_numpy(links.copy())
    got, got_acc = tmet.metropolis_sweep(src, beta, draws=draws,
                                         proposal_scale=scale)
    assert torch.equal(src, torch.from_numpy(links))   # input untouched
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert float(got_acc) == pytest.approx(float(want_acc), abs=1e-6)
    assert 0.1 < float(got_acc) < 1.0
    assert float(np.abs(got.numpy() - links).max()) > 0.1   # links moved
    with pytest.raises(ValueError, match="draws"):
        tmet.metropolis_sweep(src, beta, draws=draws[:3])


def test_torch_thermalize_reaches_exact_plaquette():
    """8x8, beta=2: cold start, 150 sweeps, then the mean plaquette of 8
    chains over 150 more sweeps against I1(2)/I0(2)."""
    shape = tu1.LatticeShape(8, 8)
    g = torch.Generator().manual_seed(5)
    x = tmet.thermalize(g, torch.zeros(8, shape.x_dim), shape, 2.0, 150)
    assert x.shape == (8, shape.x_dim)
    plaqs = []
    links = tu1.to_links(x, shape)
    for _ in range(150):
        links, _ = tmet.metropolis_sweep(links, 2.0, g)
        plaqs.append(tu1.avg_plaquette(links))
    plaq = float(torch.stack(plaqs).mean())
    exact = tu1.u1_plaq_exact(2.0)
    assert abs(plaq - exact) < 0.02, (plaq, exact)
    assert float(links.abs().max()) <= np.pi


def test_torch_metropolis_chain_runs():
    plaqs, charges = tmet.metropolis_chain(
        torch.Generator().manual_seed(6), tu1.LatticeShape(6, 6), 2.0,
        num_sweeps=40, batch=4, thin=2, device="cpu")
    assert plaqs.shape == charges.shape == (20, 4)
    assert torch.equal(charges, torch.round(charges))
    assert float(plaqs[-5:].mean()) > 0.5     # hot start relaxed
