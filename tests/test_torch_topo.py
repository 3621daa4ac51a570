"""PyTorch port, dynamics/topo.py: the instanton hop against JAX.

The JAX hop draws ``nu`` and the accept uniform from a key; the test
re-creates those draws as ``instanton_hop`` splits the key (``k_nu, k_acc``;
magnitude from ``k_nu``, sign from ``fold_in(k_nu, 1)``) and injects them
into the port's ``instanton_hop_with``.

Tolerance: the winding field is built by the same numpy code (exact);
``hop_delta_s`` to atol 1e-4 (float32 sums of 64 cos/sin terms in another
order, different libm); hop states to atol 1e-6 and accept decisions
exactly (the uniforms sit far from the probabilities at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import topo as jtopo
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu_torch.dynamics import topo as ttopo
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

LT, LX = 8, 6


def _x(seed, b, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(-np.pi, np.pi, (b, 2 * LT * LX))).astype(
        np.float32)


@pytest.mark.parametrize("nu", [1, -1, 2])
def test_torch_winding_field_matches_jax(nu):
    want = np.asarray(jtopo.winding_field(ju1.LatticeShape(LT, LX), nu))
    got = ttopo.winding_field(tu1.LatticeShape(LT, LX), nu, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    q = float(tu1.topological_charge(tu1.to_links(got, tu1.LatticeShape(
        LT, LX))))
    assert abs(q - nu) < 1e-4


def test_torch_hop_delta_s_matches_jax_and_direct_action():
    x = _x(0, 16)
    nu = np.array([1.0, -1.0, 2.0, -2.0] * 4, np.float32)
    want = np.asarray(jtopo.hop_delta_s(jnp.asarray(x), ju1.LatticeShape(
        LT, LX), jnp.asarray(nu)))
    shape = tu1.LatticeShape(LT, LX)
    xt, nut = torch.from_numpy(x), torch.from_numpy(nu)
    got = ttopo.hop_delta_s(xt, shape, nut)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    w = ttopo.winding_field(shape, 1, device="cpu")
    direct = (tu1.wilson_action(tu1.to_links(xt + nut[:, None] * w, shape))
              - tu1.wilson_action(tu1.to_links(xt, shape)))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-4)


def _jax_hop_draws(key, b, nu_max):
    """The draws of ``topo.instanton_hop`` for one key."""
    k_nu, k_acc = jax.random.split(key)
    mag = jax.random.randint(k_nu, (b,), 1, nu_max + 1)
    sign = jax.random.rademacher(jax.random.fold_in(k_nu, 1), (b,))
    u = jax.random.uniform(k_acc, (b,))
    return (torch.from_numpy(np.asarray(mag * sign, np.float32)),
            torch.from_numpy(np.asarray(u, np.float32)))


@pytest.mark.parametrize("nu_max,beta,scale", [(1, 2.0, 0.3), (2, 0.5, 1.0)])
def test_torch_instanton_hop_with_matches_jax(nu_max, beta, scale):
    x = _x(3, 32, scale)
    key = jax.random.PRNGKey(nu_max)
    want = jtopo.instanton_hop(jnp.asarray(x), beta, key,
                               ju1.LatticeShape(LT, LX), nu_max)
    nu, u = _jax_hop_draws(key, 32, nu_max)
    got = ttopo.instanton_hop_with(torch.from_numpy(x), beta, nu, u,
                                   tu1.LatticeShape(LT, LX))
    np.testing.assert_allclose(got.accept_prob.numpy(),
                               np.asarray(want.accept_prob), atol=1e-5)
    np.testing.assert_array_equal(got.accept_mask.numpy(),
                                  np.asarray(want.accept_mask))
    np.testing.assert_array_equal(got.nu.numpy(), np.asarray(want.nu))
    np.testing.assert_allclose(got.x_out.numpy(), np.asarray(want.x_out),
                               atol=1e-6)
    acc = got.accept_mask.numpy() > 0
    assert 0 < acc.sum() < 32        # both outcomes occur


def test_torch_instanton_hop_draws_and_moves_the_charge():
    shape = tu1.LatticeShape(LT, LX)
    x = torch.from_numpy(_x(5, 64, 0.1))
    nu, u = ttopo.draw_hop(torch.Generator().manual_seed(0), 4000, 2,
                           device="cpu")
    assert set(np.unique(nu.numpy())) == {-2.0, -1.0, 1.0, 2.0}
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    out = ttopo.instanton_hop(x, 2.0, torch.Generator().manual_seed(1), shape)
    dq = (tu1.topological_charge(tu1.to_links(out.x_out, shape))
          - tu1.topological_charge(tu1.to_links(x, shape)))
    np.testing.assert_allclose(dq.numpy(), out.nu.numpy(), atol=1e-3)
    rej = out.accept_mask.numpy() == 0.0
    np.testing.assert_array_equal(out.x_out.numpy()[rej], x.numpy()[rej])
    assert float(out.x_out.abs().max()) <= np.pi


def test_torch_hop_eval_chunk_metrics():
    cfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_chains=4,
                             num_steps=2, hmc=True, network_arch="mlp",
                             num_hidden=8, merge_v_halves=True,
                             eps_init=0.15, eps_trainable=False)
    params = tgauge.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    x = tu1.random_links(torch.Generator().manual_seed(1), 4, cfg.shape,
                         device="cpu")
    chunk = ttopo.make_hop_eval_chunk(cfg, 5, n_hops=2)
    x_out, m = chunk(params, x, 2.0, torch.Generator().manual_seed(2))
    assert x_out.shape == x.shape
    for k in ("accept_prob", "actions", "plaqs", "charges", "wloop22",
              "hop_accept", "hop_dq"):
        assert m[k].shape == (5, 4), k
        assert bool(torch.isfinite(m[k]).all()), k
    assert float(m["hop_dq"].sum()) > 0          # some hop accepted
