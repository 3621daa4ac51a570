"""PyTorch port, the local 5-point-stencil sampler against JAX.

The same inputs, made with numpy from a seed, go through the JAX package and
the port: the ``make_local_flat_net`` forward, ``pack_local_weights``, the
plain chain ``l2hmc_chain_reference(local_layers=L)`` (hop off and on), the
parameter round trip from a JAX ``DynamicsParams``, and the port's own
``make_dynamics`` transition with local nets against its chain reference.
Small sizes: 4x6 lattices, c=4, L in {1, 2}, K <= 3, B <= 8, N <= 3.

Tolerances: atol 1e-5 on one net forward (float32, different libm tanh/exp
and summation order); atol 2e-4 on chain states and accept probabilities, as
in tests/test_torch_slice.py (the reference's polynomial arctan against
atan2, and H0 - H1 summed per site in the port against the difference of
two float32 Hamiltonians in the reference).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics.l2hmc import DynamicsConfig as JDynamicsConfig
from l2hmc_tpu.dynamics.l2hmc import init_dynamics_params
from l2hmc_tpu.networks.nets import LocalNetSpec as JLocalNetSpec
from l2hmc_tpu.networks.nets import make_local_flat_net as j_make_local
from l2hmc_tpu.ops import l2hmc_kernel as jl2
from l2hmc_tpu_torch.lattice.u1 import typical_links
from l2hmc_tpu_torch.networks.nets import LocalNetSpec, make_local_flat_net
from l2hmc_tpu_torch.ops import l2hmc_kernel as tl2
from l2hmc_tpu_torch.train import checkpoint as tck
from l2hmc_tpu_torch.train import gauge as tgauge

torch.set_num_threads(1)

ATOL_NET = 1e-5
ATOL = 2e-4
LT, LX, C, K, B, N = 4, 6, 4, 3, 8, 3
D = LT * LX


def _gauge_cfg(num_layers, **kw):
    base = dict(time_size=LT, space_size=LX, num_steps=K,
                network_arch="local_flat", num_filters=C,
                local_layers=num_layers, merge_v_halves=True, group="u1",
                bounded_q=True, eps_init=0.12)
    base.update(kw)
    return tgauge.GaugeConfig(**base)


def _jax_nets(num_layers):
    """(XNet, VNet) (init, apply) pairs of the reference's u1 local_flat
    build (train/gauge.py build_networks)."""
    kw = dict(channels=C, num_layers=num_layers, bounded_q=True)
    return (j_make_local(JLocalNetSpec(LT, LX, factor=2.0, x_channels=4,
                                       **kw)),
            j_make_local(JLocalNetSpec(LT, LX, factor=1.0, v_channels=4,
                                       **kw)))


@functools.lru_cache(maxsize=None)
def _jax_params(num_layers):
    """Reference ``DynamicsParams`` from the JAX init, with every net leaf
    perturbed by a seeded N(0, 0.05^2) (tests/test_local_kernel.py's bump)
    so that S, T and Q are not near zero."""
    (xi, _), (vi, _) = _jax_nets(num_layers)
    cfg = JDynamicsConfig(x_dim=2 * D, num_steps=K, group="u1",
                          merge_v_halves=True)
    params = init_dynamics_params(jax.random.PRNGKey(7), cfg, xi, vi, 0.12)
    rng = np.random.default_rng(100 + num_layers)

    def bump(tree):
        return jax.tree.map(lambda a: jnp.asarray(
            np.asarray(a) + 0.05 * rng.standard_normal(a.shape),
            jnp.float32), tree)

    return params._replace(xnet=bump(params.xnet), vnet=bump(params.vnet))


def _port_params(num_layers):
    return tck.params_from_numpy(_jax_params(num_layers),
                                 _gauge_cfg(num_layers), device="cpu")


def _rand(seed, hop, n=N, b=B, d=D):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((n, b, d)), rng.standard_normal((n, b, d)),
           rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    if hop:
        out += [rng.choice([-1.0, 1.0], (n, b)), rng.uniform(size=(n, b))]
    return [a.astype(np.float32) for a in out]


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("net,bounded_q", [("x", True), ("v", True),
                                           ("x", False)])
def test_torch_local_flat_net_matches_jax_apply(net, bounded_q, num_layers):
    """XNet (factor 2, 4 cos/sin channels in the x slot) and VNet (factor
    1, in the v slot), with and without ``bounded_q``."""
    jparams = _jax_params(num_layers)
    xnet = net == "x"
    spec_kw = dict(channels=C, num_layers=num_layers, bounded_q=bounded_q,
                   factor=2.0 if xnet else 1.0)
    spec_kw.update({"x_channels": 4} if xnet else {"v_channels": 4})
    _, apply = j_make_local(JLocalNetSpec(LT, LX, **spec_kw))
    tnet = make_local_flat_net(LocalNetSpec(LT, LX, **spec_kw),
                               torch.Generator().manual_seed(0))
    tree = jparams.xnet if xnet else jparams.vnet
    tnet.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          tck._net_arrays(tree).items()}, strict=True)
    rng = np.random.default_rng(3)
    v_dim = (4 if not xnet else 2) * D
    x_dim = (4 if xnet else 2) * D
    v = rng.standard_normal((B, v_dim)).astype(np.float32)
    x = rng.standard_normal((B, x_dim)).astype(np.float32)
    t = rng.standard_normal((B, 2)).astype(np.float32)
    want = apply(tree, jnp.asarray(v), jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tnet(*[torch.from_numpy(a) for a in (v, x, t)])
    for g, w in zip(got, want):
        assert g.shape == (B, 2 * D)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_NET)
    assert float(np.abs(np.asarray(want[0])).max()) > 1e-2   # not trivial


def test_torch_local_flat_net_init_follows_jax():
    """Same parameter names and shapes as the JAX init, zero biases and
    coefficients, the sqrt(factor) x-slot scaling, the 0.001
    truncated-normal head."""
    c, layers = 8, 2
    (xi, _), _ = _jax_nets(layers)
    spec = LocalNetSpec(16, 16, channels=c, num_layers=layers, factor=2.0,
                        x_channels=4)
    a = make_local_flat_net(spec, torch.Generator().manual_seed(1))
    b = make_local_flat_net(spec, torch.Generator().manual_seed(1))
    assert torch.equal(a.stencil_0.w, b.stencil_0.w)     # generator-driven
    jinit = j_make_local(JLocalNetSpec(16, 16, channels=c, num_layers=layers,
                                       factor=2.0, x_channels=4))[0](
        jax.random.PRNGKey(0))
    jflat = tck._net_arrays(jinit)
    state = a.state_dict()
    assert set(state) == set(jflat)
    for k, v in jflat.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    for k in ("stencil_0.b", "stencil_1.b", "head.b", "coeff_scale",
              "coeff_transformation"):
        assert not bool(state[k].any()), k
    fan0 = 5 * 6 + 2
    w0 = state["stencil_0.w"]
    for sl, want in ((slice(0, 2), np.sqrt(2.0 / fan0)),
                     (slice(2, 6), np.sqrt(2.0 / fan0) * np.sqrt(2.0))):
        got = float(w0[:, sl, :].std())
        assert abs(got / want - 1.0) < 0.25, (sl, got, want)
    std = np.sqrt(1.3 * 2.0 * 0.001 / c)
    assert float(state["head.w"].abs().max()) <= 2 * std + 1e-7
    with pytest.raises(ValueError, match="kernel_size=3"):
        make_local_flat_net(LocalNetSpec(4, 4, kernel_size=5))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_torch_pack_local_weights_matches_jax(num_layers):
    jparams = _jax_params(num_layers)
    want = jl2.pack_local_weights(jparams, 2 * D, num_layers)
    got = tl2.pack_local_weights(_port_params(num_layers), 2 * D, num_layers)
    assert tl2.local_weight_names(num_layers) == jl2.local_weight_names(
        num_layers)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hop", [False, True])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_torch_local_chain_reference_matches_jax(num_layers, hop):
    """The port's plain local chain (through the CPU wrapper) against the
    JAX pure twin on the same injected randomness."""
    jparams = _jax_params(num_layers)
    params = _port_params(num_layers)
    links = typical_links(np.random.default_rng(5), B, LT, LX, sigma=0.3)
    rand = _rand(6, hop)
    eps, beta = 0.12, 3.0
    # eagerly: compiling the scan of the unrolled scalar-weight stencil
    # takes XLA 30-120 s on the CPU, running it op by op a few seconds
    with jax.disable_jit():
        want = jl2.l2hmc_chain_reference(
            jnp.asarray(links), jparams, *rand[:4], eps, beta, K,
            hop_arrays=tuple(rand[4:]) if hop else None,
            local_layers=num_layers)
    before = tl2.l2hmc_local_chain.launches
    got = tl2.l2hmc_local_chain(
        torch.from_numpy(links), params, None, eps, beta, K, N, num_layers,
        hop=hop, rand_arrays=[torch.from_numpy(a) for a in rand])
    assert tl2.l2hmc_local_chain.launches == before   # CPU: plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert 0.05 < float(got[3].mean()) < 1.0
    assert float(np.abs(np.asarray(want[0]) - links).max()) > 0.1  # moved


@pytest.mark.parametrize("num_layers", [1, 2])
def test_torch_local_dynamics_matches_chain_reference(num_layers):
    """``make_dynamics(...)['transition_with']`` with the local nets (the
    XLA-style path of the port) equals the plain chain on the same
    randomness: the interleaved flat momenta are the chain's direction
    halves."""
    cfg = _gauge_cfg(num_layers)
    params = _port_params(num_layers)
    _, dyn = tgauge.build_dynamics(cfg)
    links = typical_links(np.random.default_rng(8), B, LT, LX, sigma=0.3)
    rand = _rand(9, False)
    x = torch.from_numpy(links).reshape(B, -1)
    probs = []
    with torch.no_grad():
        for n in range(N):
            v = torch.from_numpy(np.stack([rand[0][n], rand[1][n]], -1)
                                 .reshape(B, -1))
            tr = dyn["transition_with"](params, x, 3.0, v,
                                        torch.from_numpy(rand[2][n]),
                                        torch.from_numpy(rand[3][n]))
            x = tr.x_out
            probs.append(tr.accept_prob)
        got = tl2.l2hmc_chain_reference(
            torch.from_numpy(links), params,
            *[torch.from_numpy(a) for a in rand], 0.12, 3.0, K,
            local_layers=num_layers)
    np.testing.assert_allclose(torch.stack(probs).numpy(), got[3].numpy(),
                               atol=ATOL)
    d = torch.remainder(x.reshape(B, LT, LX, 2) - got[0] + np.pi,
                        2 * np.pi) - np.pi
    assert float(d.abs().max()) <= ATOL
    assert 0.05 < float(got[3].mean()) < 1.0


def test_torch_local_params_round_trip_from_jax():
    """A JAX ``init_dynamics_params`` of the local_flat family loads through
    ``params_from_numpy`` and, as a flat leaf list in the JAX flatten
    order, through ``params_from_leaves``, value for value."""
    jparams = _jax_params(2)
    cfg = _gauge_cfg(2)
    pairs, _ = jax.tree_util.tree_flatten_with_path(jparams)
    names = [".".join(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path) for path, _ in pairs]
    order = tck.net_leaf_order(cfg)
    assert names == ([f"xnet.{n}" for n in order]
                     + [f"vnet.{n}" for n in order] + ["raw_eps", "masks"])
    leaves = [np.asarray(leaf) for _, leaf in pairs]
    for params in (tck.params_from_numpy(jparams, cfg, device="cpu"),
                   tck.params_from_leaves(leaves, cfg, device="cpu")):
        for net in ("xnet", "vnet"):
            state = getattr(params, net).state_dict()
            for k, v in tck._net_arrays(getattr(jparams, net)).items():
                np.testing.assert_array_equal(state[k].numpy(),
                                              np.asarray(v))
        assert float(params.raw_eps.detach()) == pytest.approx(0.12)
        np.testing.assert_array_equal(params.masks.numpy(),
                                      np.asarray(jparams.masks))
    assert tck.net_leaf_order(_gauge_cfg(1, network_arch="mlp",
                                         num_hidden=8)) == tck.NET_LEAF_ORDER


def test_torch_local_chain_wrapper_on_cpu():
    """The CPU wrapper draws from the generator (same seed, same chain),
    and rejects a depth of 0."""
    cfg = _gauge_cfg(1)
    params = tgauge.init_params(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    links = torch.from_numpy(typical_links(np.random.default_rng(4), 2, LT,
                                           LX, sigma=0.3))

    def run(seed):
        return tl2.l2hmc_local_chain(links, params,
                                     torch.Generator().manual_seed(seed),
                                     0.1, 3.0, K, 2, 1, hop=True)

    a, b = run(1), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert bool(torch.isfinite(x).all())
    with pytest.raises(ValueError, match="num_layers"):
        tl2.l2hmc_local_chain(links, params, None, 0.1, 3.0, K, 1, 0)
    with pytest.raises(ValueError, match="rand_arrays"):
        tl2.l2hmc_local_chain(links, params, None, 0.1, 3.0, K, 1, 1,
                              hop=True, rand_arrays=[links] * 4)
    with pytest.raises(NotImplementedError, match="conv, local, zero"):
        tgauge.build_networks(_gauge_cfg(1, network_arch="conv"))
