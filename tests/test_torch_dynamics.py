"""PyTorch port, networks/ and dynamics/: one transition against JAX.

The JAX transition draws its randomness from a key; the test re-creates
those draws (momenta, directions, accept uniforms) exactly as
``_transition_fused`` / ``hmc_transition`` split the key, and injects them
into the port's ``transition_with`` / ``hmc_transition``.

Tolerance: atol 2e-4 on states, log-Jacobians and accept probabilities, as
in tests/test_l2hmc_kernel.py: float32 on both sides with different libm
sin/cos/exp/atan2 and autograd (JAX) against the analytic Wilson backward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import hmc as jhmc
from l2hmc_tpu.dynamics.l2hmc import (
    DynamicsConfig as JDynamicsConfig, DynamicsParams as JDynamicsParams,
    make_dynamics as j_make_dynamics, time_encoding as j_time_encoding,
)
from l2hmc_tpu.lattice import u1 as ju1
from l2hmc_tpu.networks.nets import MLPNetSpec as JSpec
from l2hmc_tpu.networks.nets import make_mlp_net as j_make_mlp_net
from l2hmc_tpu.ops.wilson import make_potential_fn as j_potential_fn
from l2hmc_tpu_torch.dynamics import hmc as thmc
from l2hmc_tpu_torch.dynamics import l2hmc as tdyn
from l2hmc_tpu_torch.lattice import u1 as tu1
from l2hmc_tpu_torch.networks.nets import MLPNetSpec, make_mlp_net
from l2hmc_tpu_torch.train import gauge as tgauge
from l2hmc_tpu_torch.train.checkpoint import params_from_numpy

torch.set_num_threads(1)

ATOL = 2e-4
LT, LX, K, HIDDEN, B = 4, 4, 3, 32, 8


def _typical_x(seed, b=B, lt=LT, lx=LX, sigma=0.5):
    """Flat near-equilibrium states under a uniform random gauge transform."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, sigma, (b, lt, lx, 2))
    g = rng.uniform(-np.pi, np.pi, (b, lt, lx))
    a[..., 0] += g - np.roll(g, -1, axis=1)
    a[..., 1] += g - np.roll(g, -1, axis=2)
    a = a - 2 * np.pi * np.floor((a + np.pi) / (2 * np.pi))
    return a.reshape(b, -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(hmc=False):
    """Reference MLP/u1 params with non-trivial weights (numpy-made
    variance-scaled init + 0.02 perturbation, the test_l2hmc_kernel.py
    ``bump`` recipe) and the JAX dynamics built on them."""
    rng = np.random.default_rng(77)
    x_dim, h = 2 * LT * LX, HIDDEN

    def net(factor, v_in, x_in):
        def vs(fan_in, cols, f):
            std = np.sqrt(1.3 * 2.0 * f / fan_in)
            return std * np.clip(rng.standard_normal((fan_in, cols)), -2, 2)

        p = {"in_w": np.concatenate([vs(v_in, h, 1 / 3),
                                     vs(x_in, h, factor / 3),
                                     vs(2, h, 1 / 3)]),
             "in_b": np.zeros(h), "h_layer": {"w": vs(h, h, 1.0),
                                              "b": np.zeros(h)},
             "head_w": vs(h, 3 * x_dim, 0.001), "head_b": np.zeros(3 * x_dim),
             "coeff_scale": np.zeros((1, x_dim)),
             "coeff_transformation": np.zeros((1, x_dim))}
        return jax.tree.map(lambda a: jnp.asarray(
            a + 0.02 * rng.standard_normal(a.shape), jnp.float32), p)

    masks = np.stack([rng.permutation(x_dim) < x_dim // 2
                      for _ in range(K)]).astype(np.float32)
    params = JDynamicsParams(
        xnet=net(2.0, x_dim, 2 * x_dim), vnet=net(1.0, 2 * x_dim, x_dim),
        raw_eps=jnp.asarray(0.12, jnp.float32), masks=jnp.asarray(masks))
    _, xa = j_make_mlp_net(JSpec(x_dim, h, factor=2.0, bounded_q=True,
                                 x_in_dim=2 * x_dim))
    _, va = j_make_mlp_net(JSpec(x_dim, h, factor=1.0, bounded_q=True,
                                 v_in_dim=2 * x_dim))
    cfg = JDynamicsConfig(x_dim=x_dim, num_steps=K, group="u1",
                          merge_v_halves=True, hmc=hmc)
    dyn = j_make_dynamics(cfg, j_potential_fn(ju1.LatticeShape(LT, LX)),
                          xa, va)
    return params, dyn, jax.jit(dyn["transition"])


def _gauge_cfg(**kw):
    base = dict(time_size=LT, space_size=LX, num_steps=K, network_arch="mlp",
                num_hidden=HIDDEN, merge_v_halves=True, group="u1",
                bounded_q=True, eps_init=0.12)
    base.update(kw)
    return tgauge.GaugeConfig(**base)


def _jax_transition_randomness(key, b, x_dim):
    """The draws of l2hmc.py _transition_fused for one key."""
    kv, kd, ka = jax.random.split(key, 3)
    v = jax.random.normal(kv, (b, x_dim), jnp.float32)
    direction = jnp.where(jax.random.uniform(kd, (b,)) > 0.5, 1.0, -1.0)
    u = jax.random.uniform(ka, (b,))
    return [torch.from_numpy(np.array(a, np.float32))
            for a in (v, direction, u)]


@pytest.mark.parametrize("hmc", [False, True])
def test_torch_transition_matches_jax_make_dynamics(hmc):
    jparams, _, jtrans = _jax_params(hmc)
    cfg = _gauge_cfg(hmc=hmc)
    params = params_from_numpy(jparams, cfg, device="cpu")
    _, dyn = tgauge.build_dynamics(cfg)
    x = _typical_x(1)
    beta = 3.0
    key = jax.random.PRNGKey(5)
    want = jtrans(jparams, jnp.asarray(x), beta, key)
    v, direction, u = _jax_transition_randomness(key, B, x.shape[1])
    assert 0 < int((direction > 0).sum()) < B      # both directions present
    with torch.no_grad():
        got = dyn["transition_with"](params, torch.from_numpy(x), beta, v,
                                     direction, u)
    for name in ("x_proposed", "v_proposed", "sumlogdet", "accept_prob",
                 "x_out"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.accept_mask.numpy(),
                                  np.asarray(want.accept_mask))
    assert 0.05 < float(got.accept_prob.mean()) < 1.0
    if hmc:
        # zero nets: circle_scale(x, 0) is the identity, its log-Jacobian
        # -log(cos^2 + sin^2) is float32 rounding only (~1e-7 per link)
        np.testing.assert_allclose(got.sumlogdet.numpy(), 0.0, atol=1e-5)


def test_torch_mlp_net_matches_jax_apply():
    jparams, _, _ = _jax_params()
    x_dim = 2 * LT * LX
    spec = MLPNetSpec(x_dim, HIDDEN, factor=2.0, bounded_q=True,
                      x_in_dim=2 * x_dim)
    net = make_mlp_net(spec, torch.Generator().manual_seed(0))
    state = {k: torch.from_numpy(np.array(v))
             for k, v in _flat(jparams.xnet).items()}
    net.load_state_dict(state)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((B, x_dim)).astype(np.float32)
    xf = rng.standard_normal((B, 2 * x_dim)).astype(np.float32)
    t = rng.standard_normal((B, 2)).astype(np.float32)
    _, apply = j_make_mlp_net(JSpec(x_dim, HIDDEN, factor=2.0, bounded_q=True,
                                    x_in_dim=2 * x_dim))
    want = apply(jparams.xnet, jnp.asarray(v), jnp.asarray(xf),
                 jnp.asarray(t))
    with torch.no_grad():
        got = net(*[torch.from_numpy(a) for a in (v, xf, t)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _flat(net):
    out = {}
    for k, v in net.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_torch_mlp_net_init_statistics():
    spec = MLPNetSpec(64, 128, factor=2.0, bounded_q=True, x_in_dim=128)
    a = make_mlp_net(spec, torch.Generator().manual_seed(1))
    b = make_mlp_net(spec, torch.Generator().manual_seed(1))
    assert torch.equal(a.in_w, b.in_w)                 # generator-driven
    assert dict(a.state_dict()).keys() == {
        "in_w", "in_b", "h_layer.w", "h_layer.b", "head_w", "head_b",
        "coeff_scale", "coeff_transformation"}
    assert a.in_w.shape == (64 + 128 + 2, 128)
    assert a.head_w.shape == (128, 3 * 64)
    # truncated-normal variance scaling: |w| <= 2 std, std ~ 0.88 * nominal
    std = np.sqrt(1.3 * 2.0 * (2.0 / 3.0) / 128)
    blk = a.in_w[64:192].detach()
    assert float(blk.abs().max()) <= 2 * std + 1e-6
    assert abs(float(blk.std()) / std - 0.88) < 0.05
    # use_bf16: bf16 operands and float32 sums, as JAX's bf16 apply
    jparams, _, _ = _jax_params()
    x_dim = 2 * LT * LX
    spec = dict(factor=2.0, bounded_q=True, x_in_dim=2 * x_dim)
    net = make_mlp_net(MLPNetSpec(x_dim, HIDDEN, use_bf16=True, **spec),
                       torch.Generator().manual_seed(0))
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in _flat(jparams.xnet).items()})
    _, apply = j_make_mlp_net(JSpec(x_dim, HIDDEN, use_bf16=True, **spec))
    rng = np.random.default_rng(4)
    v, xf, t = (rng.standard_normal((B, n)).astype(np.float32)
                for n in (x_dim, 2 * x_dim, 2))
    want = apply(jparams.xnet, *map(jnp.asarray, (v, xf, t)))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (v, xf, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("num_steps", [1, 4])
def test_torch_hmc_transition_matches_jax(num_steps):
    x = _typical_x(2, b=6, lt=4, lx=6)
    key = jax.random.PRNGKey(9)
    eps, beta = 0.1, 2.5
    j_pot = ju1.make_potential_fn(ju1.LatticeShape(4, 6))
    want = jhmc.hmc_transition(j_pot, jnp.asarray(x), beta, key, eps,
                               num_steps)
    kv, ka = jax.random.split(key)
    v = torch.from_numpy(np.array(jax.random.normal(kv, x.shape)))
    u = torch.from_numpy(np.array(jax.random.uniform(ka, (x.shape[0],))))
    t_pot = tu1.make_potential_fn(tu1.LatticeShape(4, 6))
    got = thmc.hmc_transition(t_pot, torch.from_numpy(x), beta, eps,
                              num_steps, v=v, u=u)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_torch_dynamics_helpers():
    idx = torch.tensor([0, 1, 2])
    want = np.asarray(j_time_encoding(jnp.asarray([0, 1, 2]), 3))
    np.testing.assert_allclose(tdyn.time_encoding(idx, 3).numpy(), want,
                               atol=1e-6)
    masks = tdyn.make_masks(torch.Generator().manual_seed(0), 3, 10)
    assert masks.shape == (3, 10)
    assert torch.equal(masks.sum(dim=1), torch.full((3,), 5.0))
    params = tgauge.init_params(_gauge_cfg(), torch.Generator().manual_seed(0),
                                device="cpu")
    cfg = tdyn.DynamicsConfig(x_dim=32, num_steps=3, group="u1",
                              merge_v_halves=True, eps_cap=0.1)
    assert float(tdyn.get_eps(params, cfg).detach()) == pytest.approx(0.1)


@pytest.mark.parametrize("kw", [
    {"group": "r1"}, {"merge_v_halves": False}, {"both_directions": True}])
def test_torch_unported_settings_raise(kw):
    base = dict(x_dim=32, num_steps=3, group="u1", merge_v_halves=True)
    base.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdyn.make_dynamics(tdyn.DynamicsConfig(**base), lambda x: x.sum(-1))


def test_torch_unported_builders_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgauge.build_networks(_gauge_cfg(network_arch="conv"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgauge.build_dynamics(_gauge_cfg(action="improved"))
    _, dyn = tgauge.build_dynamics(_gauge_cfg())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dyn["chain_operator"]()


def test_torch_eval_chunk_runs():
    cfg = _gauge_cfg()
    params = tgauge.init_params(cfg, torch.Generator().manual_seed(2),
                                device="cpu")
    chunk = tgauge.make_eval_chunk(cfg, 3)
    x0 = torch.from_numpy(_typical_x(3))
    x, m = chunk(params, x0, 2.0, torch.Generator().manual_seed(4))
    assert x.shape == x0.shape
    assert set(m) == {"accept_prob", "actions", "plaqs", "charges",
                      "wloop22"}
    for v in m.values():
        assert v.shape == (3, B) and bool(torch.isfinite(v).all())
    assert float(x.abs().max()) <= np.pi
    assert torch.equal(m["charges"], torch.round(m["charges"]))
