"""PyTorch port, ops/: Wilson action, chain math and wrappers against JAX.

The JAX side of each chain comparison is the plain JAX reference
(``hmc_chain_reference``, ``l2hmc_chain_reference``), which the JAX suite
holds against its Pallas kernels.  Inputs and all randomness are numpy arrays
from a seed, injected into both sides.

Tolerance: atol 2e-4 on states and accept probabilities (as in
tests/test_l2hmc_kernel.py).  The two sides use different libm
sin/cos/exp, the port forms H0 - H1 from per-site differences where the
reference subtracts two O(1e2..1e3) Hamiltonians, and the reference's
trained chain uses its own polynomial arctan (~2 ulp) where the port uses
atan2, so float32 rounding differs by up to ~1e-4 on an accept probability.

The kernels themselves are held against these plain versions on the card in
tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics.l2hmc import DynamicsConfig
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu.ops import l2hmc_kernel as jl2
from l2hmc_tpu.ops import leapfrog as jlf
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.ops import leapfrog as tlf
from l2hmc_tpu_torch.ops import wilson as tw
from l2hmc_tpu_torch.train.checkpoint import params_from_numpy
from l2hmc_tpu_torch.train.gauge import GaugeConfig

torch.set_num_threads(1)

ATOL = 2e-4


def _rand(seed, n, b, d, hop, directions=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d))]
    if directions:
        out.append(rng.choice([-1.0, 1.0], (n, b)))
    out.append(rng.uniform(size=(n, b)))
    if hop:
        out += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [a.astype(np.float32) for a in out]


@functools.lru_cache(maxsize=None)
def _jax_mlp_params(lt, lx, K, hidden, eps=0.12):
    """A reference MLP/u1/merge_v ``DynamicsParams`` with non-trivial
    weights, made in numpy: the variance-scaled init of ``make_mlp_net``
    plus a 0.02 normal perturbation of every array, as the ``_build``/
    ``bump`` recipe of tests/test_l2hmc_kernel.py does (numpy avoids the
    per-op compiles of an eager JAX init)."""
    from l2hmc_tpu.dynamics.l2hmc import DynamicsParams

    rng = np.random.default_rng(hash((lt, lx, K, hidden)) % 2**32)
    x_dim, h = 2 * lt * lx, hidden

    def vs(fan_in, cols, factor):
        std = np.sqrt(1.3 * 2.0 * factor / fan_in)
        return std * np.clip(rng.standard_normal((fan_in, cols)), -2, 2)

    def net(factor, v_in, x_in):
        p = {
            "in_w": np.concatenate([vs(v_in, h, 1 / 3), vs(x_in, h, factor / 3),
                                    vs(2, h, 1 / 3)]),
            "in_b": np.zeros(h),
            "h_layer": {"w": vs(h, h, 1.0), "b": np.zeros(h)},
            "head_w": vs(h, 3 * x_dim, 0.001),
            "head_b": np.zeros(3 * x_dim),
            "coeff_scale": np.zeros((1, x_dim)),
            "coeff_transformation": np.zeros((1, x_dim)),
        }
        return jax.tree.map(
            lambda a: jnp.asarray(a + 0.02 * rng.standard_normal(a.shape),
                                  jnp.float32), p)

    masks = np.stack([(rng.permutation(x_dim) < x_dim // 2)
                      for _ in range(K)]).astype(np.float32)
    cfg = DynamicsConfig(x_dim=x_dim, num_steps=K, group="u1",
                         merge_v_halves=True)
    return cfg, DynamicsParams(
        xnet=net(2.0, x_dim, 2 * x_dim), vnet=net(1.0, 2 * x_dim, x_dim),
        raw_eps=jnp.asarray(eps, jnp.float32), masks=jnp.asarray(masks))


def _torch_cfg(lt, lx, K, hidden):
    return GaugeConfig(time_size=lt, space_size=lx, num_steps=K,
                       network_arch="mlp", num_hidden=hidden,
                       merge_v_halves=True, group="u1", bounded_q=True,
                       eps_init=0.12)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Wilson action
# ---------------------------------------------------------------------------


def test_torch_wilson_action_and_analytic_grad_match_jax():
    links = np.random.default_rng(0).uniform(
        -np.pi, np.pi, (3, 4, 6, 2)).astype(np.float32)
    want = np.asarray(ju1.wilson_action(jnp.asarray(links)))
    want_g = np.asarray(jax.grad(
        lambda l: jnp.sum(ju1.wilson_action(l)))(jnp.asarray(links)))
    x = torch.from_numpy(links).requires_grad_(True)
    s = tw.wilson_action(x)
    (g,) = torch.autograd.grad(s.sum(), x)
    np.testing.assert_allclose(s.detach().numpy(), want, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), want_g, atol=1e-5)


def test_torch_wilson_action_second_derivative_matches_jax():
    """Hessian-vector product through the analytic backward (the training
    loss differentiates through the force)."""
    rng = np.random.default_rng(1)
    links = rng.uniform(-np.pi, np.pi, (2, 4, 4, 2)).astype(np.float32)
    vec = rng.standard_normal(links.shape).astype(np.float32)
    grad_j = jax.grad(lambda l: jnp.sum(ju1.wilson_action(l)))
    _, want = jax.jvp(grad_j, (jnp.asarray(links),), (jnp.asarray(vec),))
    x = torch.from_numpy(links).requires_grad_(True)
    (g,) = torch.autograd.grad(tw.wilson_action(x).sum(), x,
                               create_graph=True)
    (hv,) = torch.autograd.grad(g, x, grad_outputs=torch.from_numpy(vec))
    np.testing.assert_allclose(hv.numpy(), np.asarray(want), atol=1e-4)


def test_torch_potential_fn_on_flat_state():
    from l2hmc_tpu_torch.lattice.u1 import LatticeShape

    links = np.random.default_rng(2).uniform(
        -np.pi, np.pi, (2, 4, 4, 2)).astype(np.float32)
    pot = tw.make_potential_fn(LatticeShape(4, 4))
    got = pot(torch.from_numpy(links.reshape(2, -1)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ju1.wilson_action(jnp.asarray(links))),
        atol=1e-4)


# ---------------------------------------------------------------------------
# Chains: plain versions against the JAX references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx", [(4, 4), (8, 8)])
def test_torch_hmc_chain_reference_matches_jax(lt, lx, hop):
    b, n, d = 8, 3, lt * lx
    links = typical_links(np.random.default_rng(3), b, lt, lx)
    rand = _rand(4, n, b, d, hop)
    eps, beta, K = 0.1, 3.0, 4
    hop_j = tuple(rand[3:]) if hop else None
    want = jlf.hmc_chain_reference(jnp.asarray(links), *rand[:3], eps, beta,
                                   K, hop_arrays=hop_j)
    hop_t = tuple(_t(*rand[3:])) if hop else None
    got = tlf.hmc_chain_reference(torch.from_numpy(links), *_t(*rand[:3]),
                                  eps, beta, K, hop_arrays=hop_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert 0.05 < float(got[3].mean()) < 1.0


@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("lt,lx", [(4, 4), (8, 8)])
def test_torch_l2hmc_chain_reference_matches_jax(lt, lx, hop):
    K, hidden, b, n, d = 3, 32, 8, 4, lt * lx
    _, jparams = _jax_mlp_params(lt, lx, K, hidden)
    params = params_from_numpy(jparams, _torch_cfg(lt, lx, K, hidden),
                               device="cpu")
    links = typical_links(np.random.default_rng(5), b, lt, lx)
    rand = _rand(6, n, b, d, hop, directions=True)
    eps, beta = 0.12, 3.0
    hop_j = tuple(rand[4:]) if hop else None
    want = jl2.l2hmc_chain_reference(jnp.asarray(links), jparams, *rand[:4],
                                     eps, beta, K, hop_arrays=hop_j)
    hop_t = tuple(_t(*rand[4:])) if hop else None
    got = tl2.l2hmc_chain_reference(torch.from_numpy(links), params,
                                    *_t(*rand[:4]), eps, beta, K,
                                    hop_arrays=hop_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert 0.05 < float(got[3].mean()) < 1.0


def test_torch_pack_weights_matches_jax():
    lt, lx, K, hidden = 4, 4, 3, 32
    _, jparams = _jax_mlp_params(lt, lx, K, hidden)
    params = params_from_numpy(jparams, _torch_cfg(lt, lx, K, hidden),
                               device="cpu")
    want = jl2.pack_weights(jparams, 2 * lt * lx)
    got = tl2.pack_weights(params, 2 * lt * lx)
    assert tl2.WEIGHT_NAMES == jl2.WEIGHT_NAMES
    for name, g, w in zip(tl2.WEIGHT_NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert g.is_contiguous() and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# Wrappers on CPU tensors: the plain version, generator-driven
# ---------------------------------------------------------------------------


def test_torch_hmc_chain_wrapper_cpu():
    links = torch.from_numpy(typical_links(np.random.default_rng(7), 4, 4, 4))
    outs = [tlf.hmc_chain(links, torch.Generator().manual_seed(3), 0.1, 2.0,
                          3, 5, hop=True) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)            # same generator seed, same chain
    out, plaq, chg, prob = outs[0]
    assert out.shape == links.shape and plaq.shape == (5, 4)
    assert torch.equal(chg, torch.round(chg))
    rand = _t(*_rand(8, 2, 4, 16, hop=False))
    got = tlf.hmc_chain(links, None, 0.1, 2.0, 3, 2, rand_arrays=rand)
    want = tlf.hmc_chain_reference(links, *rand, 0.1, 2.0, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rand_arrays"):
        tlf.hmc_chain(links, None, 0.1, 2.0, 3, 2, hop=True, rand_arrays=rand)
    with pytest.raises(ValueError, match="Lt, Lx, 2"):
        tlf.hmc_chain(links[..., :1], None, 0.1, 2.0, 3, 2, rand_arrays=rand)
    assert tlf.hmc_chain.launches == 0       # counts kernel launches only


def test_torch_l2hmc_chain_wrapper_cpu():
    lt, lx, K, hidden = 4, 4, 3, 32
    _, jparams = _jax_mlp_params(lt, lx, K, hidden)
    params = params_from_numpy(jparams, _torch_cfg(lt, lx, K, hidden),
                               device="cpu")
    links = torch.from_numpy(typical_links(np.random.default_rng(9), 4, lt,
                                            lx))
    outs = [tl2.l2hmc_chain(links, params, torch.Generator().manual_seed(1),
                            0.12, 2.0, K, 3, hop=hop)
            for hop in (False, False, True)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for out in outs:
        assert all(bool(torch.isfinite(t).all()) for t in out)
        assert out[1].shape == (3, 4)
    with pytest.raises(ValueError, match="rand_arrays"):
        tl2.l2hmc_chain(links, params, None, 0.12, 2.0, K, 3,
                        rand_arrays=_t(*_rand(1, 3, 4, 16, hop=False)))
    assert tl2.l2hmc_chain.launches == 0
