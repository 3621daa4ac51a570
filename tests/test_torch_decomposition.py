"""PyTorch port, the cost-decomposition modes against JAX.

The same inputs, made with numpy from a seed, go through the JAX package and
the port:

- ``ablate_nets=True`` (S = T = Q = 0 without the conditioner): the port's
  plain chain against JAX's Pallas kernels in interpret mode, for the MLP
  family and the local stencil family at L = 1 and 2; and the port's
  ablated chain against its chain on zeroed nets, bit for bit;
- ``precision='bf16'``: the port's plain chain against JAX's
  ``l2hmc_chain_reference(precision='bf16')``, and bf16 against f32;
- ``MLPNetSpec(use_bf16=True)`` against JAX's apply, and the zero net
  (``network_arch='zero'``, ``hmc=True``) against plain HMC;
- the CPU wrappers in both modes, and the decomposition arithmetic of
  ``l2hmc_tpu_torch/benchmarks``.

Tolerances: atol 2e-4 on chain states and accept probabilities where both
sides compute in float32 (the reference's polynomial arctan against atan2
and its difference of two ~1e3 Hamiltonians against the port's per-site
sum, ROADMAP section C).  The bf16 chains round activations to bfloat16 at
each product, so where torch's and XLA's float32 features or sums differ by
an ulp, an activation on a rounding boundary would land one bf16 step (2^-8
relative) apart on the two sides.  On these inputs none does: measured
2.3e-6 on accept probabilities and 7e-7 on links (f32: 7.1e-6 and 7e-7),
6e-8 on the bf16 net forward; so the bf16 chain keeps the f32 gate of 2e-4
and the bf16 net the f32 net's 1e-5 (tests/test_torch_dynamics.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics.l2hmc import DynamicsParams as JDynamicsParams
from l2hmc_tpu.networks.nets import MLPNetSpec as JSpec
from l2hmc_tpu.networks.nets import make_mlp_net as j_make_mlp_net
from l2hmc_tpu.networks.nets import make_zero_net as j_make_zero_net
from l2hmc_tpu.ops import l2hmc_kernel as jl2
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.networks.nets import (MLPNetSpec, ZeroNet,
                                           make_mlp_net, make_zero_net)
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.ops import leapfrog as tlf
from l2hmc_tpu_torch.train import checkpoint as tck
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

ATOL = 2e-4
NET_ATOL = 1e-5
LT, LX, B = 4, 4, 8
D = LT * LX


def _rand(seed, n, b=B, d=D, hop=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d)),
           rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    if hop:
        out += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [a.astype(np.float32) for a in out]


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _mlp_cfg(K, hidden, **kw):
    return tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                              network_arch="mlp", num_hidden=hidden,
                              merge_v_halves=True, group="u1",
                              bounded_q=True, eps_init=0.12, **kw)


def _jax_mlp_params(K, hidden, seed):
    """A reference MLP/u1 ``DynamicsParams`` made in numpy: the variance
    scaled init of ``make_mlp_net`` plus a 0.02 normal perturbation of every
    array (the ``bump`` recipe of tests/test_l2hmc_kernel.py)."""
    rng = np.random.default_rng(seed)
    x_dim, h = 2 * D, hidden

    def vs(fan_in, cols, factor):
        std = np.sqrt(1.3 * 2.0 * factor / fan_in)
        return std * np.clip(rng.standard_normal((fan_in, cols)), -2, 2)

    def net(factor, v_in, x_in):
        p = {"in_w": np.concatenate([vs(v_in, h, 1 / 3),
                                     vs(x_in, h, factor / 3),
                                     vs(2, h, 1 / 3)]),
             "in_b": np.zeros(h),
             "h_layer": {"w": vs(h, h, 1.0), "b": np.zeros(h)},
             "head_w": vs(h, 3 * x_dim, 0.001),
             "head_b": np.zeros(3 * x_dim),
             "coeff_scale": np.zeros((1, x_dim)),
             "coeff_transformation": np.zeros((1, x_dim))}
        return jax.tree.map(lambda a: jnp.asarray(
            a + 0.02 * rng.standard_normal(a.shape), jnp.float32), p)

    masks = np.stack([rng.permutation(x_dim) < x_dim // 2
                      for _ in range(K)]).astype(np.float32)
    return JDynamicsParams(
        xnet=net(2.0, x_dim, 2 * x_dim), vnet=net(1.0, 2 * x_dim, x_dim),
        raw_eps=jnp.asarray(0.12, jnp.float32), masks=jnp.asarray(masks))


def _zeroed(params):
    z = copy.deepcopy(params)
    with torch.no_grad():
        for net in (z.xnet, z.vnet):
            for p in net.parameters():
                p.zero_()
    return z


def _assert_chains_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_torch_ablated_chain_matches_jax_kernel_and_zero_nets():
    """MLP family, 4x4, K=2, b=8, h16: the port's ablated plain chain
    against JAX's Pallas kernel (interpret mode) with ``ablate_nets=True``,
    and against the port's own chain on zeroed nets, bit for bit."""
    K, n, eps, beta = 2, 2, 0.12, 2.0
    jparams = _jax_mlp_params(K, 16, 11)
    params = tck.params_from_numpy(jparams, _mlp_cfg(K, 16), device="cpu")
    links = typical_links(np.random.default_rng(12), B, LT, LX)
    rand = _rand(13, n)
    want = jl2.l2hmc_chain_pallas(
        jnp.asarray(links), jparams, jax.random.PRNGKey(0), eps=eps,
        beta=beta, num_leapfrog=K, num_transitions=n, tile_b=4,
        interpret=True, rand_arrays=tuple(jnp.asarray(a) for a in rand),
        ablate_nets=True)
    got = tl2.l2hmc_chain_reference(torch.from_numpy(links), params,
                                    *_t(rand), eps, beta, K,
                                    ablate_nets=True)
    _assert_chains_close(got, want, ATOL)
    zero = tl2.l2hmc_chain_reference(torch.from_numpy(links),
                                     _zeroed(params), *_t(rand), eps, beta,
                                     K)
    for a, z in zip(got, zero):
        assert torch.equal(a, z)
    full = tl2.l2hmc_chain_reference(torch.from_numpy(links), params,
                                     *_t(rand), eps, beta, K)
    assert not torch.equal(full[3], got[3])        # the nets do matter here


def _jax_local_params(num_layers, K):
    from l2hmc_tpu.dynamics.l2hmc import DynamicsConfig as JDynamicsConfig
    from l2hmc_tpu.dynamics.l2hmc import init_dynamics_params
    from l2hmc_tpu.networks.nets import LocalNetSpec as JLocalNetSpec
    from l2hmc_tpu.networks.nets import make_local_flat_net as j_make_local

    kw = dict(channels=4, num_layers=num_layers, bounded_q=True)
    xi, _ = j_make_local(JLocalNetSpec(LT, LX, factor=2.0, x_channels=4,
                                       **kw))
    vi, _ = j_make_local(JLocalNetSpec(LT, LX, factor=1.0, v_channels=4,
                                       **kw))
    cfg = JDynamicsConfig(x_dim=2 * D, num_steps=K, group="u1",
                          merge_v_halves=True)
    params = init_dynamics_params(jax.random.PRNGKey(21), cfg, xi, vi, 0.12)
    rng = np.random.default_rng(22 + num_layers)
    bump = lambda tree: jax.tree.map(lambda a: jnp.asarray(  # noqa: E731
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape), jnp.float32),
        tree)
    return params._replace(xnet=bump(params.xnet), vnet=bump(params.vnet))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_torch_ablated_local_chain_matches_jax_kernel(num_layers):
    """Local stencil family, 4x4, K=2, b=8: the port's ablated plain chain
    against JAX's local Pallas kernel (interpret mode, run op by op under
    ``jax.disable_jit()``) with ``ablate_nets=True``, and against the port's
    chain on zeroed stencil nets, bit for bit."""
    K, n, eps, beta = 2, 2, 0.12, 2.0
    jparams = _jax_local_params(num_layers, K)
    cfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                             network_arch="local_flat", num_filters=4,
                             local_layers=num_layers, merge_v_halves=True,
                             group="u1", bounded_q=True, eps_init=0.12)
    params = tck.params_from_numpy(jparams, cfg, device="cpu")
    links = typical_links(np.random.default_rng(23), B, LT, LX, sigma=0.3)
    rand = _rand(24, n)
    with jax.disable_jit():
        want = jl2.l2hmc_local_chain_pallas(
            jnp.asarray(links), jparams, jax.random.PRNGKey(0), eps=eps,
            beta=beta, num_leapfrog=K, num_transitions=n,
            num_layers=num_layers, tile_b=4, interpret=True,
            rand_arrays=tuple(jnp.asarray(a) for a in rand),
            ablate_nets=True)
    got = tl2.l2hmc_local_chain(torch.from_numpy(links), params, None, eps,
                                beta, K, n, num_layers, rand_arrays=_t(rand),
                                ablate_nets=True)
    _assert_chains_close(got, want, ATOL)
    zero = tl2.l2hmc_chain_reference(
        torch.from_numpy(links), _zeroed(params), *_t(rand), eps, beta, K,
        local_layers=num_layers)
    for a, z in zip(got, zero):
        assert torch.equal(a, z)


def test_torch_bf16_chain_matches_jax_reference():
    """``precision='bf16'``, 4x4, K=2, b=8, h32: the port's plain chain
    against JAX's ``l2hmc_chain_reference(precision='bf16')``; bf16 against
    f32 within 0.05 on accept probabilities (tests/test_l2hmc_kernel.py) but
    more than 5 ATOL apart (2.5e-3 on these inputs), so the comparison with
    JAX tells the two precisions apart; and ``pack_weights`` stores exactly
    the six matmul operands as bf16."""
    K, n, eps, beta = 2, 2, 0.12, 3.0
    jparams = _jax_mlp_params(K, 32, 31)
    params = tck.params_from_numpy(jparams, _mlp_cfg(K, 32), device="cpu")
    links = typical_links(np.random.default_rng(32), B, LT, LX)
    rand = _rand(33, n)
    want = jl2.l2hmc_chain_reference(jnp.asarray(links), jparams, *rand, eps,
                                     beta, K, precision="bf16")
    got = tl2.l2hmc_chain_reference(torch.from_numpy(links), params,
                                    *_t(rand), eps, beta, K,
                                    precision="bf16")
    _assert_chains_close(got, want, ATOL)
    f32 = tl2.l2hmc_chain_reference(torch.from_numpy(links), params,
                                    *_t(rand), eps, beta, K)
    np.testing.assert_allclose(got[3].numpy(), f32[3].numpy(), atol=0.05)
    assert float((got[3] - f32[3]).abs().max()) > 5 * ATOL
    packed = tl2.pack_weights(params, 2 * D, "bf16")
    jpacked = jl2.pack_weights(jparams, 2 * D, "bf16")
    for name, g, w in zip(tl2.WEIGHT_NAMES, packed, jpacked):
        want_dtype = (torch.bfloat16 if name in tl2.MATMUL_WEIGHTS
                      else torch.float32)
        assert g.dtype == want_dtype, name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    with pytest.raises(ValueError, match="precision"):
        tl2.pack_weights(params, 2 * D, "fp16")


@pytest.mark.parametrize("factor,slot", [(2.0, "x"), (1.0, "v")])
def test_torch_bf16_mlp_net_matches_jax_apply(factor, slot):
    """``MLPNetSpec(use_bf16=True)``: bf16 operands, float32 sums, against
    JAX's apply with ``use_bf16=True``; and it differs from the f32 net."""
    x_dim, h = 2 * D, 32
    jparams = _jax_mlp_params(2, h, 41)
    tree = jparams.xnet if slot == "x" else jparams.vnet
    io = dict(x_in_dim=2 * x_dim) if slot == "x" else dict(v_in_dim=2 * x_dim)
    spec = dict(factor=factor, bounded_q=True, **io)
    _, apply = j_make_mlp_net(JSpec(x_dim, h, use_bf16=True, **spec))
    nets = [make_mlp_net(MLPNetSpec(x_dim, h, use_bf16=bf16, **spec),
                         torch.Generator().manual_seed(0))
            for bf16 in (True, False)]
    state = {k: torch.from_numpy(np.array(v))
             for k, v in tck._net_arrays(tree).items()}
    for net in nets:
        net.load_state_dict(state)
    rng = np.random.default_rng(42)
    dv = 2 * x_dim if slot == "v" else x_dim
    dx = 2 * x_dim if slot == "x" else x_dim
    v = rng.standard_normal((B, dv)).astype(np.float32)
    x = rng.standard_normal((B, dx)).astype(np.float32)
    t = rng.standard_normal((B, 2)).astype(np.float32)
    want = apply(tree, jnp.asarray(v), jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got, f32 = [net(*[torch.from_numpy(a) for a in (v, x, t)])
                    for net in nets]
    for g, w, f in zip(got, want, f32):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=NET_ATOL)
        assert not torch.equal(g, f)


def test_torch_zero_net_is_plain_hmc():
    """``make_zero_net`` gives S = T = Q = 0 of ``x_dim`` columns, as
    JAX's; ``network_arch='zero'`` with ``hmc=True`` builds parameterless
    nets, and its forward transitions equal plain HMC's on the same
    momenta and uniforms."""
    K, eps, beta = 3, 0.1, 3.0
    net = make_zero_net(2 * D)
    v = torch.randn(B, 4 * D)
    s, t, q = net(v, torch.randn(B, 2 * D), torch.randn(B, 2))
    _, japply = j_make_zero_net(2 * D)
    js, _, _ = japply({}, jnp.zeros((B, 2 * D)), jnp.zeros((B, 2 * D)),
                      jnp.zeros((B, 2)))
    assert s.shape == t.shape == q.shape == tuple(js.shape) == (B, 2 * D)
    assert not any(bool(a.any()) for a in (s, t, q))
    cfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                             network_arch="zero", hmc=True,
                             merge_v_halves=True, eps_init=eps,
                             eps_trainable=False)
    params = tgauge.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert isinstance(params.xnet, ZeroNet)
    assert not list(params.xnet.parameters())
    _, dyn = tgauge.build_dynamics(cfg)
    links = typical_links(np.random.default_rng(51), B, LT, LX)
    v0s, v1s, _, us = _rand(52, 1)
    v = torch.from_numpy(np.stack([v0s[0], v1s[0]], -1).reshape(B, -1))
    with torch.no_grad():
        tr = dyn["transition_with"](params, torch.from_numpy(links).reshape(
            B, -1), beta, v, torch.ones(B), torch.from_numpy(us[0]))
    want = tlf.hmc_chain_reference(torch.from_numpy(links), *_t(
        [v0s, v1s, us]), eps, beta, K)
    np.testing.assert_allclose(tr.accept_prob.numpy(), want[3][0].numpy(),
                               atol=ATOL)
    d = torch.remainder(tr.x_out.reshape(B, LT, LX, 2) - want[0] + np.pi,
                        2 * np.pi) - np.pi
    assert float(d.abs().max()) <= ATOL
    assert 0.05 < float(want[3].mean()) <= 1.0


def test_torch_chain_wrappers_on_cpu_run_the_modes():
    """On CPU tensors ``l2hmc_chain(precision=, ablate_nets=)`` and
    ``l2hmc_local_chain(ablate_nets=)`` run the plain version of that mode
    and count no launch."""
    K = 2
    params = tgauge.init_params(_mlp_cfg(K, 16),
                                torch.Generator().manual_seed(61),
                                device="cpu")
    links = torch.from_numpy(typical_links(np.random.default_rng(62), B, LT,
                                           LX))
    rand = _t(_rand(63, 2))
    before = (tl2.l2hmc_chain.launches, tl2.l2hmc_chain.bf16_launches,
              tl2.l2hmc_chain.ablate_launches)
    for kw in (dict(precision="bf16"), dict(ablate_nets=True)):
        got = tl2.l2hmc_chain(links, params, None, 0.12, 2.0, K, 2,
                              rand_arrays=rand, **kw)
        want = tl2.l2hmc_chain_reference(links, params, *rand, 0.12, 2.0, K,
                                         **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (tl2.l2hmc_chain.launches, tl2.l2hmc_chain.bf16_launches,
            tl2.l2hmc_chain.ablate_launches) == before
    lcfg = tgauge.GaugeConfig(time_size=LT, space_size=LX, num_steps=K,
                              network_arch="local_flat", num_filters=4,
                              local_layers=1, merge_v_halves=True,
                              eps_init=0.12)
    lparams = tgauge.init_params(lcfg, torch.Generator().manual_seed(64),
                                 device="cpu")
    got = tl2.l2hmc_local_chain(links, lparams, None, 0.12, 2.0, K, 2, 1,
                                rand_arrays=rand, ablate_nets=True)
    want = tl2.l2hmc_chain_reference(links, _zeroed(lparams), *rand, 0.12,
                                     2.0, K, local_layers=1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tl2.l2hmc_local_chain.ablate_launches == 0


def test_torch_decomposition_arithmetic():
    """``kernel_decomposition.decomposition`` on fixed times: components,
    shares and ratios as the JAX script computes them; the local bench's
    variant names parse as the JAX script's."""
    from l2hmc_tpu_torch.benchmarks.kernel_decomposition import decomposition
    from l2hmc_tpu_torch.benchmarks.local_kernel_bench import parse_variants

    t = {"full": 1e-3, "ablated": 1e-4, "bf16": 8e-4, "hmc": 2.5e-5}
    r = decomposition(t, 3, 2048, "cfg")
    comp = r["component_us"]
    assert comp["conditioner (feats+matmuls+heads)"] == pytest.approx(900.0)
    assert comp["l2hmc machinery (circle map, masks, direction fusion, "
                "exps)"] == pytest.approx(75.0)
    assert comp["base hmc trig flow"] == pytest.approx(25.0)
    assert r["component_share_pct"] == pytest.approx(
        {"conditioner": 90.0, "machinery": 7.5, "base_flow": 2.5})
    assert r["bf16_vs_f32"] == pytest.approx(1.25)
    assert r["trained_over_hmc_cost_sameK"] == pytest.approx(40.0)
    assert r["lf_steps_per_s"]["hmc"] == pytest.approx(3 * 2048 / 2.5e-5)
    assert "cut it by 20%" in r["floor_statement"]
    slow = decomposition(dict(t, bf16=1.05e-3), 3, 2048, "cfg")
    assert "stays open" in slow["floor_statement"]
    assert parse_variants("c4L1, c8L2") == [("c4L1", 4, 1), ("c8L2", 8, 2)]
