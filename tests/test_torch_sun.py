"""PyTorch port, the SU(N) family (``lattice/sun.py``, ``lattice/su2.py``,
``ops/su_matrix.py``, ``dynamics/su2_hmc.py``, ``dynamics/sun_hmc.py``,
``lattice/sun_nd.py``, ``dynamics/sun_l2hmc.py``), against the JAX package.

The same numpy inputs (seeded) go through both; random functions replay
JAX's draws from its keys (``kv, ka = split(key)`` for HMC; ``kv, kd, ka =
split(key, 3)`` for the L2HMC kernel, its direction ``bernoulli(kd, 0.5)``).
The port computes in complex64 and is held against JAX's complex forms and,
for the 4-D actions and HMC transition, against its float32 (re, im) pair
forms (the pairs converted in the test with JAX's ``cmat.to_pairs``).

Tolerances: float32 group algebra 1e-5 (relative for actions, which sum
hundreds of terms); one HMC transition (K=3-4 leapfrog steps) 2e-4 on the
links and the acceptance, the pair test's bound; the L2HMC transition and
train step 3e-4, the JAX pair test's; the exact values to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.dynamics import su2_hmc as jsu2_hmc
from l2hmc_tpu.dynamics import sun_hmc as jsun_hmc
from l2hmc_tpu.dynamics import sun_l2hmc as jsl
from l2hmc_tpu.lattice import su2 as jsu2
from l2hmc_tpu.lattice import sun as jsun
from l2hmc_tpu.lattice import sun_nd as jnd
from l2hmc_tpu.ops import cmat
from l2hmc_tpu.ops import su_matrix as jsm
from l2hmc_tpu_torch.dynamics import su2_hmc as tsu2_hmc
from l2hmc_tpu_torch.dynamics import sun_hmc as tsun_hmc
from l2hmc_tpu_torch.dynamics import sun_l2hmc as tsl
from l2hmc_tpu_torch.lattice import su2 as tsu2
from l2hmc_tpu_torch.lattice import sun as tsun
from l2hmc_tpu_torch.lattice import sun_nd as tnd
from l2hmc_tpu_torch.ops import su_matrix as tsm

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _links(n, shape, seed, scale=0.5):
    """Near-identity SU(N) links as numpy complex64 (JAX's expm)."""
    rng = np.random.default_rng(seed)
    alpha = scale * rng.standard_normal((*shape, n * n - 1)).astype(
        np.float32)
    h = jnp.einsum("...k,kij->...ij", jnp.asarray(alpha, jnp.complex64),
                   jsun.generators(n))
    return np.asarray(jax.scipy.linalg.expm(1j * h)), alpha


def _quats(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*shape, 4)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Group algebra, plaquettes and actions
# ---------------------------------------------------------------------------


def test_torch_su2_quaternion_algebra_matches_jax():
    a, b = _quats((5,), 0), _quats((5,), 1)
    theta = 0.7 * np.random.default_rng(2).standard_normal((4, 3)).astype(
        np.float32)
    for name in ("qmul",):
        np.testing.assert_allclose(getattr(tsu2, name)(_t(a), _t(b)).numpy(),
                                   np.asarray(getattr(jsu2, name)(a, b)),
                                   atol=1e-6)
    np.testing.assert_array_equal(tsu2.qconj(_t(a)).numpy(),
                                  np.asarray(jsu2.qconj(a)))
    np.testing.assert_allclose(tsu2.q_exp(_t(theta)).numpy(),
                               np.asarray(jsu2.q_exp(theta)), atol=1e-6)
    np.testing.assert_allclose(tsu2.to_matrix(_t(a)).numpy(),
                               np.asarray(jsu2.to_matrix(a)), atol=1e-7)
    links = _quats((3, 4, 4, 2), 3)
    np.testing.assert_allclose(tsu2.plaquette(_t(links)).numpy(),
                               np.asarray(jsu2.plaquette(links)), atol=1e-5)
    np.testing.assert_allclose(tsu2.wilson_action(_t(links), 2.0).numpy(),
                               np.asarray(jsu2.wilson_action(links, 2.0)),
                               rtol=1e-5)
    np.testing.assert_allclose(tsu2.avg_plaquette(_t(links)).numpy(),
                               np.asarray(jsu2.avg_plaquette(links)),
                               atol=1e-6)
    # the quaternion action equals the matrix form's
    np.testing.assert_allclose(
        tsu2.wilson_action(_t(links), 2.0).numpy(),
        tsun.sun_action(tsu2.to_matrix(_t(links)), 2.0).numpy(), rtol=1e-4)
    cold = tsu2.cold_links(2, 4, 4, device="cpu")
    np.testing.assert_array_equal(cold.numpy(),
                                  np.asarray(jsu2.cold_links(2, 4, 4)))


@pytest.mark.parametrize("n", [2, 3])
def test_torch_sun_group_matches_jax(n):
    np.testing.assert_array_equal(tsun.generators(n).numpy(),
                                  np.asarray(jsun.generators(n)))
    links, alpha = _links(n, (2, 4, 3, 2), 10 + n)
    # random_sun on injected normals: the same expm(i a.T), a = scale * z
    got = tsun.random_sun(None, n, scale=0.5, normals=_t(alpha / 0.5))
    np.testing.assert_allclose(got.numpy(), links, atol=2e-6)
    np.testing.assert_allclose(tsun.sun_plaquette(_t(links)).numpy(),
                               np.asarray(jsun.sun_plaquette(links)),
                               atol=1e-5)
    np.testing.assert_allclose(tsun.sun_action(_t(links), 2.0).numpy(),
                               np.asarray(jsun.sun_action(links, 2.0)),
                               rtol=1e-5)
    assert tsun.is_unitary(_t(links)) == bool(jsun.is_unitary(links))
    assert not tsun.is_unitary(_t(links) * 1.01)


@pytest.mark.parametrize("n", [2, 3])
def test_torch_su_matrix_matches_jax(n):
    rng = np.random.default_rng(20 + n)
    a = 0.4 * rng.standard_normal((32, n * n - 1)).astype(np.float32)
    h = np.asarray(jnp.einsum("bk,kij->bij", jnp.asarray(a, jnp.complex64),
                              jsun.generators(n)))
    np.testing.assert_allclose(tsm.expm_ih(_t(h)).numpy(),
                               np.asarray(jsm.expm_ih(h)), atol=1e-6)
    np.testing.assert_allclose(tsm.expm_taylor(_t(h)).numpy(),
                               np.asarray(jsm.expm_taylor(h)), atol=1e-6)
    drift = np.asarray(jsm.expm_ih(h)) + np.complex64(2e-3)
    np.testing.assert_allclose(tsm.polar_reunitarize(_t(drift)).numpy(),
                               np.asarray(jsm.polar_reunitarize(drift)),
                               atol=1e-6)
    np.testing.assert_allclose(tsm._det_small(_t(drift)).numpy(),
                               np.asarray(jsm._det_small(drift)), atol=1e-6)
    # QR reunitarization (sun_hmc) projects to SU(N) as JAX's does
    links, _ = _links(n, (4,), 30 + n)
    off = links * np.complex64(1.01) + np.complex64(0.01)
    got = tsun_hmc._reunitarize(_t(off))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jsun_hmc._reunitarize(off)),
                               atol=2e-6)
    assert tsun.is_unitary(got)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("dims", [(2, 3), (3, 2, 3), (2, 2, 2, 2)])
def test_torch_sun_nd_actions_match_jax_complex_and_pairs(dims):
    n = 3 if len(dims) < 4 else 2
    links, _ = _links(n, (2, *dims, len(dims)), 40 + len(dims))
    pairs = np.asarray(cmat.to_pairs(links))
    u = _t(links)
    c1 = -1.0 / 12.0
    for got, want_c, want_p in (
            (tnd.wilson_action_nd(u, 2.0), jnd.wilson_action_nd(links, 2.0),
             jnd.wilson_action_nd_pairs(pairs, 2.0)),
            (tnd.improved_action_nd(u, 2.0, c1),
             jnd.improved_action_nd(links, 2.0, c1),
             jnd.improved_action_nd_pairs(pairs, 2.0, c1)),
            (tnd.avg_plaq_nd(u), jnd.avg_plaq_nd(links),
             jnd.avg_plaq_nd_pairs(pairs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_c),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_p),
                                   rtol=1e-5)
    np.testing.assert_allclose(
        tnd.improved_action_nd(u, 1.5, 0.0).numpy(),
        tnd.wilson_action_nd(u, 1.5).numpy(), rtol=1e-6)
    for mu, nu in ((0, 1), (1, 0)):
        np.testing.assert_allclose(
            tnd.rect_field_nd(u, mu, nu).numpy(),
            np.asarray(jnd.rect_field_nd(links, mu, nu)), atol=1e-5)
    if len(dims) == 2:  # d=2 is the 2-D module
        np.testing.assert_allclose(tnd.wilson_action_nd(u, 2.0).numpy(),
                                   tsun.sun_action(u, 2.0).numpy(),
                                   rtol=1e-5)


def test_torch_sun_nd_gauge_invariance():
    links, _ = _links(3, (2, 3, 2, 3, 2, 4), 50)
    g, _ = _links(3, (2, 3, 2, 3, 2), 51, scale=1.0)
    gauged = tnd.gauge_transform_nd(_t(links), _t(g))
    np.testing.assert_allclose(
        gauged.numpy(), np.asarray(jnd.gauge_transform_nd(links, g)),
        atol=1e-5)
    assert tsun.is_unitary(gauged, atol=1e-4)
    for fn in (lambda v: tnd.wilson_action_nd(v, 2.0),
               lambda v: tnd.improved_action_nd(v, 2.0, -1.0 / 12.0)):
        np.testing.assert_allclose(fn(gauged).numpy(), fn(_t(links)).numpy(),
                                   rtol=2e-4)


def test_torch_sun_exact_values_match_jax():
    for beta in (0.5, 2.0, 4.0):
        assert tsu2.su2_plaq_exact(beta) == jsu2.su2_plaq_exact(beta)
        for n in (2, 3):
            assert tsun_hmc.sun_plaq_exact(n, beta) == \
                jsun_hmc.sun_plaq_exact(n, beta)
            assert tnd.sun_plaq_strong_coupling(n, beta) == \
                jnd.sun_plaq_strong_coupling(n, beta)
    assert round(tsun_hmc.sun_plaq_exact(2, 2.0), 5) == 0.43313
    assert round(tsun_hmc.sun_plaq_exact(3, 4.0), 5) == 0.27930


# ---------------------------------------------------------------------------
# HMC transitions on JAX's draws
# ---------------------------------------------------------------------------


def _hmc_draws(key, mom_shape, b):
    kv, ka = jax.random.split(key)
    return (_t(jax.random.normal(kv, mom_shape, jnp.float32)),
            _t(jax.random.uniform(ka, (b,))))


def test_torch_su2_hmc_transition_matches_jax():
    links = _quats((4, 4, 4, 2), 60)
    key = jax.random.PRNGKey(61)
    want = jax.jit(lambda u, k: jsu2_hmc.su2_hmc_transition(
        u, 2.0, k, 0.12, 3))(links, key)
    pi, u = _hmc_draws(key, links.shape[:-1] + (3,), 4)
    got = tsu2_hmc.su2_hmc_transition(_t(links), 2.0, None, 0.12, 3, pi=pi,
                                      u=u)
    np.testing.assert_allclose(got.accept_prob.numpy(),
                               np.asarray(want.accept_prob), atol=2e-4)
    np.testing.assert_array_equal(got.accept_mask.numpy(),
                                  np.asarray(want.accept_mask))
    np.testing.assert_allclose(got.links.numpy(), np.asarray(want.links),
                               atol=2e-4)
    f = tsu2_hmc._force(_t(links), 2.0)
    np.testing.assert_allclose(f.numpy(),
                               np.asarray(jsu2_hmc._force(links, 2.0)),
                               atol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_torch_sun_hmc_transition_matches_jax(n):
    links, _ = _links(n, (4, 4, 4, 2), 70 + n)
    key = jax.random.PRNGKey(71)
    want = jax.jit(lambda u, k: jsun_hmc.sun_hmc_transition(
        u, 3.0, k, 0.1, 3, n))(links, key)
    pi, u = _hmc_draws(key, links.shape[:-2] + (n * n - 1,), 4)
    got = tsun_hmc.sun_hmc_transition(_t(links), 3.0, None, 0.1, 3, n,
                                      pi=pi, u=u)
    np.testing.assert_allclose(got.accept_prob.numpy(),
                               np.asarray(want.accept_prob), atol=2e-4)
    np.testing.assert_allclose(got.links.numpy(), np.asarray(want.links),
                               atol=2e-4)


def test_torch_sun_nd_hmc_transition_matches_jax_complex_and_pairs():
    links, _ = _links(2, (3, 3, 2, 3, 3), 80)
    key = jax.random.PRNGKey(81)
    want = jax.jit(lambda u, k: jnd.sun_nd_hmc_transition(
        u, k, 0.15, 3, lambda v: jnd.wilson_action_nd(v, 1.0)))(links, key)
    want_p = jax.jit(lambda u, k: jnd.sun_nd_hmc_transition_pairs(
        u, k, 0.15, 3, lambda v: jnd.wilson_action_nd_pairs(v, 1.0)))(
            cmat.to_pairs(links), key)
    pi, u = _hmc_draws(key, links.shape[:-2] + (3,), 3)
    got = tnd.sun_nd_hmc_transition(_t(links), None, 0.15, 3,
                                    tnd.make_action(1.0), pi=pi, u=u)
    for w_prob, w_links in ((want.accept_prob, want.links),
                            (want_p.accept_prob,
                             cmat.from_pairs(want_p.links))):
        np.testing.assert_allclose(got.accept_prob.numpy(),
                                   np.asarray(w_prob), atol=2e-4)
        np.testing.assert_allclose(got.links.numpy(), np.asarray(w_links),
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# The trainable SU(N) kernel
# ---------------------------------------------------------------------------

CFG = dict(n=2, num_steps=2, eps_init=0.12, hidden=8)


def _sun_params(key, cfg=None):
    cfg = cfg or jsl.SUNL2HMCConfig(**CFG)
    p = jsl.init_sun_l2hmc(key, cfg)
    return p._replace(net=p.net._replace(
        w_s=0.3 * jax.random.normal(jax.random.fold_in(key, 1),
                                    p.net.w_s.shape),
        w_t=0.3 * jax.random.normal(jax.random.fold_in(key, 2),
                                    p.net.w_t.shape),
        w_q=0.3 * jax.random.normal(jax.random.fold_in(key, 3),
                                    p.net.w_q.shape)))


def _sun_draws(key, shape, b):
    kv, kd, ka = jax.random.split(key, 3)
    return tsl.SUNDraws(
        _t(jax.random.normal(kv, shape, jnp.float32)),
        _t(np.where(np.asarray(jax.random.bernoulli(kd, 0.5, (b,))), 1.0,
                    -1.0).astype(np.float32)),
        _t(jax.random.uniform(ka, (b,))))


def test_torch_sun_l2hmc_transition_matches_jax():
    key = jax.random.PRNGKey(90)
    jparams = _sun_params(key)
    tparams = tsl.sun_params_from_numpy(jparams, device="cpu")
    links, _ = _links(2, (4, 4, 4, 2), 91)
    kk = jax.random.PRNGKey(92)
    want = jsl.make_sun_dynamics(jsl.SUNL2HMCConfig(**CFG), 2.0)[
        "transition"](jparams, links, kk)
    dyn = tsl.make_sun_dynamics(tsl.SUNL2HMCConfig(**CFG), 2.0)
    with torch.no_grad():
        got = dyn["transition_with"](tparams, _t(links),
                                     _sun_draws(kk, (4, 4, 4, 2, 3), 4))
    for k in ("accept_prob", "sumlogdet", "x_proposed", "x_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=3e-4, err_msg=k)
    # reversibility with cancelling log-Jacobians
    p = torch.randn((4, 4, 4, 2, 3), generator=torch.Generator()
                    .manual_seed(0))
    d = torch.ones(4)
    with torch.no_grad():
        u1, p1, ld1 = dyn["integrate"](tparams, _t(links), p, d)
        u2, p2, ld2 = dyn["integrate"](tparams, u1, p1, -d)
    np.testing.assert_allclose(u2.numpy(), links, atol=2e-5)
    np.testing.assert_allclose(p2.numpy(), p.numpy(), atol=2e-5)
    np.testing.assert_allclose((ld1 + ld2).numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("eps_trainable", [True, False])
def test_torch_sun_l2hmc_train_step_matches_jax(eps_trainable):
    """SU(3) at K=3: in SU(2) Im tr P and sin(2 pi i / 2) are zero up to
    rounding, so their weights' gradients are rounding noise, which Adam's
    first steps (~ lr x sign) turn into lr-sized differences."""
    import optax

    key = jax.random.PRNGKey(100)
    kw = dict(CFG, n=3, num_steps=3, eps_trainable=eps_trainable)
    jcfg = jsl.SUNL2HMCConfig(**kw)
    tcfg = tsl.SUNL2HMCConfig(**kw)
    jparams = _sun_params(key, jcfg)
    tparams = tsl.sun_params_from_numpy(jparams, device="cpu")
    jopt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(optax.warmup_exponential_decay_schedule(
            0.0, 1e-2, 1, 1000, 0.96)))
    topt = tsl.make_sun_optimizer(1e-2, 1)
    jstep = jax.jit(jsl.make_sun_train_step(jcfg, 2.0, jopt)[0])
    tstep, _ = tsl.make_sun_train_step(tcfg, 2.0, topt)
    jstate = jopt.init(jparams)
    tstate = topt.init(tsl.named_leaves(tparams))
    links, _ = _links(3, (4, 4, 4, 2), 101)
    ju, tu = links, _t(links)
    for i in range(2):
        kk = jax.random.fold_in(key, 10 + i)
        jparams, jstate, ju, jm = jstep(jparams, jstate, ju, kk)
        tparams, tstate, tu, tm = tstep(tparams, tstate, tu,
                                        draws=_sun_draws(kk, (4, 4, 4, 2, 8),
                                                         4))
        for k in ("loss", "accept_prob", "eps"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=3e-4,
                                                 abs=3e-4), k
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=3e-4)
        for k, v in tsl.named_leaves(tparams).items():
            want = jparams.raw_eps if k == "raw_eps" else getattr(
                jparams.net, k.split("/")[1])
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(want),
                                       atol=3e-4, err_msg=k)
    if not eps_trainable:
        assert float(tparams.raw_eps.detach()) == pytest.approx(
            CFG["eps_init"])


def test_torch_sun_pairs_raise():
    with pytest.raises(NotImplementedError, match="Not to port"):
        tsl.make_sun_dynamics(tsl.SUNL2HMCConfig(real_pairs=True), 2.0)
    with pytest.raises(NotImplementedError, match="Not to port"):
        tsl.init_sun_l2hmc(None, tsl.SUNL2HMCConfig(real_pairs=True),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="Not to port"):
        tnd.sun_nd_hmc_chain(torch.Generator(), 2, (2, 2), 1.0, 1,
                             real_pairs=True, device="cpu")
    for name in ("random_links_nd_pairs", "plaq_field_nd_pairs",
                 "rect_field_nd_pairs", "wilson_action_nd_pairs",
                 "improved_action_nd_pairs", "avg_plaq_nd_pairs",
                 "sun_nd_hmc_transition_pairs"):
        with pytest.raises(NotImplementedError, match="Not to port"):
            getattr(tnd, name)(None)
