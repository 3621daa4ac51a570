"""PyTorch port, the gauge-equivariant flow (``dynamics/flow.py``) against
JAX's ``l2hmc_tpu/dynamics/flow.py``.

Parity: JAX's ``init_flow`` with every leaf perturbed by a seeded
N(0, 0.2^2) (so the flow is not the identity; N(0, 0.1^2) at 8x8 with the
5x5 kernel, whose 200-term convolutions would otherwise give NCP slopes
e^s above 100, which amplify float32 rounding past the tolerances), carried
into the port by
``flow_params_from_numpy``; the same numpy inputs go through both; the
estimators and chains take JAX's draws replayed (base samples and
uniforms from JAX's key splits, injected through the ``*_with`` forms and
``draws``).  Then JAX's own property tests, as port tests.

Tolerances (float32 on both sides, convolutions and reductions in another
order, through up to 8 coupling layers): links and logdets 1e-4; the
numerical inverse and log q 2e-4 (40 bisection steps and a Newton polish
on each side); losses rel 1e-5; gradients max|d| <= 1e-3 max|g| per
tensor; chain states atol 1e-4 where the accept decisions agree (no
near-ties at these draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import flow as JF
from l2hmc_tpu_torch.dynamics import flow as TF
from l2hmc_tpu_torch.lattice import u1 as tu1

torch.set_num_threads(1)

CFGS = {
    "4x4": dict(time_size=4, space_size=4, num_layers=8, n_mix=2,
                hidden_channels=4),
    "8x8_k5_depth2": dict(time_size=8, space_size=8, num_layers=4, n_mix=2,
                          hidden_channels=8, kernel_size=5,
                          conditioner_depth=2),
}
SCALES = {"4x4": 0.2, "8x8_k5_depth2": 0.1}


def _pair(name, seed=0, scale=None):
    scale = SCALES[name] if scale is None else scale
    kw = CFGS[name]
    jcfg, tcfg = JF.FlowConfig(**kw), TF.FlowConfig(**kw)
    jp = JF.init_flow(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + scale * rng.standard_normal(a.shape), jnp.float32),
        jp)
    return jcfg, jp, tcfg, TF.flow_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _z(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi,
                       (b, cfg.time_size, cfg.space_size, 2)).astype(
                           np.float32)


def _jz(key, b, cfg):
    """Base samples as JAX's ``sample_and_logq`` draws them."""
    return jax.random.uniform(key, (b, cfg.time_size, cfg.space_size, 2),
                              minval=-np.pi, maxval=np.pi)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _hwio_grads(tp, jgrads):
    """JAX's gradient tree in the port's parameter names and layouts."""
    out = {}
    for i, layer in enumerate(jgrads):
        for conv, leaves in layer.items():
            w = np.transpose(np.asarray(leaves["w"]), (3, 2, 0, 1))
            out[f"{i}.{conv}.w"] = w
            out[f"{i}.{conv}.b"] = np.asarray(leaves["b"])
    return out


def _check_grads(tp, loss, jgrads):
    named = dict(tp.named_parameters())
    got = torch.autograd.grad(loss, list(named.values()))
    want = _hwio_grads(tp, jgrads)
    assert set(want) == set(named)
    for name, g in zip(named, got):
        scale = max(np.abs(want[name]).max(), 1e-6)
        assert np.abs(g.numpy() - want[name]).max() <= 1e-3 * scale, name


# ---------------------------------------------------------------------------
# Transforms and maps
# ---------------------------------------------------------------------------


def test_torch_ncp_mixture_and_inverse_match_jax():
    rng = np.random.default_rng(3)
    phi = rng.uniform(-np.pi, np.pi, (64,)).astype(np.float32)
    scales = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    logits = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    offset = rng.uniform(-1, 1, (64,)).astype(np.float32)
    want = JF.ncp_mixture(*map(jnp.asarray, (phi, scales, logits, offset)))
    got = TF.ncp_mixture(*map(_t, (phi, scales, logits, offset)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    back = TF.ncp_mixture_inverse(got[0], *map(_t, (scales, logits, offset)))
    jback = JF.ncp_mixture_inverse(want[0], *map(jnp.asarray,
                                                 (scales, logits, offset)))
    for g, w in zip(back, jback):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    np.testing.assert_allclose(tu1.wrap(back[0] - _t(phi)).numpy(), 0.0,
                               atol=2e-5)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_torch_flow_maps_match_jax(name):
    """``flow_forward``, ``flow_inverse`` and ``logq_of`` on the same
    parameters and links."""
    jcfg, jp, tcfg, tp = _pair(name)
    z = _z(tcfg, 3)
    jx, jld = jax.jit(lambda p, z: JF.flow_forward(p, z, jcfg))(
        jp, jnp.asarray(z))
    jz, jli = jax.jit(lambda p, x: JF.flow_inverse(p, x, jcfg))(jp, jx)
    with torch.no_grad():
        tx, tld = TF.flow_forward(tp, _t(z), tcfg)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
        np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-4)
        tz, tli = TF.flow_inverse(tp, _t(jx), tcfg)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=2e-4)
        np.testing.assert_allclose(tli.numpy(), np.asarray(jli), atol=2e-4)
        # logq_of = log q0 + logdet_inv
        np.testing.assert_allclose(
            TF.logq_of(tp, _t(jx), tcfg).numpy(),
            -tcfg.shape.num_links * np.log(2 * np.pi) + np.asarray(jli),
            atol=2e-4)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CFGS))
def test_torch_reverse_kl_loss_and_grads_match_jax(name):
    jcfg, jp, tcfg, tp = _pair(name)
    key = jax.random.PRNGKey(4)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JF.reverse_kl_loss(p, key, 16, 1.5, jcfg),
        has_aux=True))(jp)
    loss, aux = TF.reverse_kl_loss_with(tp, _t(_jz(key, 16, jcfg)), 1.5,
                                        tcfg)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ess_frac", "plaq"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-4), k
    _check_grads(tp, loss, jgrads)


def test_torch_importance_weights_and_forward_kl_match_jax():
    jcfg, jp, tcfg, tp = _pair("4x4")
    key = jax.random.PRNGKey(6)
    jx, jlogw, jlogz = jax.jit(
        lambda p: JF.importance_weights(p, key, 32, 2.0, jcfg))(jp)
    x, logw, logz = TF.importance_weights_with(tp, _t(_jz(key, 32, jcfg)),
                                               2.0, tcfg)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(logw.numpy(), np.asarray(jlogw), atol=1e-4)
    assert float(logz) == pytest.approx(float(jlogz), abs=1e-4)
    xp = _z(tcfg, 8, seed=5)
    jfkl, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JF.forward_kl_loss(p, jnp.asarray(xp), jcfg)))(jp)
    fkl = TF.forward_kl_loss(tp, _t(xp), tcfg)
    assert float(fkl.detach()) == pytest.approx(float(jfkl), rel=1e-5)
    _check_grads(tp, fkl, jgrads)


# ---------------------------------------------------------------------------
# Chains, JAX's draws replayed
# ---------------------------------------------------------------------------


def test_torch_independence_mh_chain_matches_jax():
    jcfg, jp, tcfg, tp = _pair("4x4", scale=0.05)
    b, steps = 16, 5
    x0, logq0 = jax.jit(lambda p: JF.sample_and_logq(
        p, jax.random.PRNGKey(8), b, jcfg))(jp)
    key = jax.random.PRNGKey(9)
    _, jplaq, jacc = jax.jit(lambda p: JF.independence_mh_chain(
        p, key, x0, logq0, 1.0, steps, jcfg))(jp)
    draws = []
    for k in jax.random.split(key, steps):
        kp, ka = jax.random.split(k)
        draws.append((_t(_jz(kp, b, jcfg)),
                      _t(jax.random.uniform(ka, (b,)))))
    _, plaq, acc = TF.independence_mh_chain(tp, None, _t(x0), _t(logq0), 1.0,
                                            steps, tcfg, draws=draws)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(plaq.numpy(), np.asarray(jplaq), atol=1e-4)
    assert 0 < float(acc.mean()) < 1


def test_torch_flow_hmc_hybrid_chain_matches_jax():
    jcfg, jp, tcfg, tp = _pair("4x4", scale=0.05)
    b, rounds, per_round, eps, lf = 8, 2, 2, 0.2, 3
    links0 = jnp.asarray(_z(tcfg, b, seed=11) * 0.3)
    key = jax.random.PRNGKey(12)
    want = jax.jit(lambda p: JF.flow_hmc_hybrid_chain(
        p, key, links0, 1.0, rounds, per_round, eps, lf, jcfg))(jp)
    draws = []
    for k in jax.random.split(key, rounds):
        kh, kp, ka = jax.random.split(k, 3)
        hmc = []
        for kk in jax.random.split(kh, per_round):
            kv, kacc = jax.random.split(kk)
            hmc.append((_t(jax.random.normal(kv, (b, 32))),
                        _t(jax.random.uniform(kacc, (b,)))))
        draws.append((hmc, _t(_jz(kp, b, jcfg)),
                      _t(jax.random.uniform(ka, (b,)))))
    got = TF.flow_hmc_hybrid_chain(tp, None, _t(links0), 1.0, rounds,
                                   per_round, eps, lf, tcfg, draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# ---------------------------------------------------------------------------
# JAX's flow properties, as port tests
# ---------------------------------------------------------------------------


def _random_port(cfg_kw, seed=0):
    cfg = TF.FlowConfig(**cfg_kw)
    g = torch.Generator().manual_seed(seed)
    params = TF.init_flow(g, cfg, "cpu")
    with torch.no_grad():
        for layer in params:
            layer.c2.w.copy_(0.3 * torch.randn(layer.c2.w.shape,
                                               generator=g))
    return cfg, params


def test_torch_flow_refuses_sides_not_divisible_by_4():
    with pytest.raises(ValueError, match="divisible by 4"):
        TF.FlowConfig(time_size=6, space_size=6)
    with pytest.raises(ValueError, match="divisible by 4"):
        TF.FlowConfig(time_size=4, space_size=10)


def test_torch_flow_identity_at_init():
    cfg = TF.FlowConfig(**CFGS["4x4"])
    params = TF.init_flow(torch.Generator().manual_seed(0), cfg, "cpu")
    z = _t(_z(cfg, 3))
    with torch.no_grad():
        x, logdet = TF.flow_forward(params, z, cfg)
    np.testing.assert_allclose(x.numpy(), z.numpy(), atol=1e-6)
    # each active site's log h' is log 1 up to float32 rounding of
    # cos^2 + sin^2 (~1.2e-7): 32 of them over 8 layers
    np.testing.assert_allclose(logdet.numpy(), 0.0, atol=4e-6)


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_flow_logdet_matches_the_jacobian(depth):
    """The accumulated logdet against slogdet of the autograd Jacobian on
    link space (32 links at 4x4): triangular, positive."""
    cfg, params = _random_port(dict(time_size=4, space_size=4,
                                    num_layers=8 if depth == 1 else 4,
                                    n_mix=3, hidden_channels=8,
                                    conditioner_depth=depth))
    z = _t(_z(cfg, 1, seed=2)).double()
    params = params.double()

    def flat(zf):
        return TF.flow_forward(params, zf.reshape(1, 4, 4, 2), cfg)[0] \
            .reshape(-1)

    jac = torch.autograd.functional.jacobian(flat, z.reshape(-1))
    sign, logabsdet = torch.linalg.slogdet(jac)
    with torch.no_grad():
        _, logdet = TF.flow_forward(params, z, cfg)
    assert float(sign) == 1.0
    assert float(logdet[0]) == pytest.approx(float(logabsdet), abs=1e-4)


def test_torch_flow_is_gauge_equivariant():
    cfg, params = _random_port(dict(time_size=4, space_size=8, num_layers=8,
                                    n_mix=3, hidden_channels=8))
    rng = np.random.default_rng(3)
    z = _t(rng.uniform(-np.pi, np.pi, (2, 4, 8, 2)))
    g = _t(rng.uniform(-np.pi, np.pi, (4, 8)))
    u0 = z[..., 0] + g - torch.roll(g, -1, dims=0)
    u1_ = z[..., 1] + g - torch.roll(g, -1, dims=1)
    zg = tu1.wrap(torch.stack([u0, u1_], dim=-1))
    with torch.no_grad():
        x, logdet = TF.flow_forward(params, z, cfg)
        xg, logdetg = TF.flow_forward(params, zg, cfg)
    np.testing.assert_allclose(logdet.numpy(), logdetg.numpy(), atol=1e-4)
    np.testing.assert_allclose(torch.cos(tu1.plaq_sums(xg)).numpy(),
                               torch.cos(tu1.plaq_sums(x)).numpy(),
                               atol=1e-4)


def test_torch_flow_independence_mh_uniform_target_accepts_everything():
    """At beta=0 the identity flow proposes exactly the target."""
    cfg = TF.FlowConfig(**CFGS["4x4"])
    g = torch.Generator().manual_seed(4)
    params = TF.init_flow(g, cfg, "cpu")
    with torch.no_grad():
        x0, logq0 = TF.sample_and_logq(params, g, 8, cfg)
    _, _, accs = TF.independence_mh_chain(params, g, x0, logq0, 0.0, 20, cfg)
    np.testing.assert_allclose(accs.numpy(), 1.0)


def test_torch_flow_inverse_round_trip_and_density():
    cfg, params = _random_port(CFGS["4x4"], seed=5)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        z = TF.draw_base(g, 4, cfg)
        x, logq = TF.sample_and_logq_with(params, z, cfg)
        back, _ = TF.flow_inverse(params, x, cfg)
        np.testing.assert_allclose(tu1.wrap(back - z).numpy(), 0.0,
                                   atol=1e-4)
        np.testing.assert_allclose(TF.logq_of(params, x, cfg).numpy(),
                                   logq.numpy(), atol=1e-3)
